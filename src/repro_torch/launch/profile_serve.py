"""Where the serving time goes on the card: a torch.profiler breakdown.

Runs the port's serving path (``repro_torch.launch.serve``'s prefill of the
batch and its decode steps, on either of its schedules) on a full-width
model and profiles the prefill and a window of batched decode steps.  For
each phase it prints the host wall time (ended by a device synchronise; the
fastest and the median of a few repeats, since the host's clock is noisy),
the device busy time (the sum of kernel time the profiler saw), the device
idle share, the kernel launches, and the kernels that take the most device
time.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      [--arch smollm-360m|recurrentgemma-2b|xlstm-1.3b|musicgen-medium] [--prompt-len 512] \\
      [--attn-impl pallas|xla] [--kv-page-len 32 --kv-kind pinned_host] \\
      [--param-kind pinned_host --device-budget-mb 160] [--out profile_serve.json]
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mixtral-8x7b \\
      --n-layers 4 --batch 2 --param-kind pinned_host --expert-stream \\
      --device-budget-mb 9000 [--all-experts]

Batch 4 (``--batch``), random bf16 weights from seed 0; 8 decode steps are
profiled.  ``--n-layers`` cuts the depth.
chip_smoke.py's cells take prompt 512 for smollm-360m and xlstm-1.3b (whose
prompts longer than its 128-token chunk must be a multiple of it) and 3072
for recurrentgemma-2b (longer than its 2048 window).  Prefill times are per
request: the batch's over 4.

``--kv-page-len > 0`` profiles the paged decode step instead: one
``ServeSession.step()`` (pop the cold pages, assemble the view, decode,
cut out the current pages, demote, prefetch) with the cold pages at
``--kv-kind``.  Beside the step's numbers it gives the device time of
``assemble_view``'s copies and of ``update_current``'s (the kernels inside
the ``record_function`` spans that the paged step and the pager mark), and
the compute-blocked transfer wait a step.

``--param-kind pinned_host|disk_host`` profiles the unpaged decode step with
the weights streamed from that home (``make_weight_streamed_decode_step``,
under ``--device-budget-mb``; the prefill streams too and is not profiled).
Beside the step's wall, device busy, idle share and launches it gives the
weight stream's compute-blocked transfer wait, H2D bytes and requests, disk
requests and groups fetched a step, and the residency cache's counters.
The streamed weights are initialized group by group, so a model larger than
the card profiles too.  ``--expert-stream`` (a MoE arch) decodes
router-first and fetches only the routed experts (all of them with
``--all-experts``); the breakdown then adds the expert groups' bytes,
fetches, resident hits and transfer wait a step, and the distinct experts
fetched a MoE layer.

Needs a CUDA card; it measures the device and has no CPU mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.weightstream import PARAM_KINDS, WeightStreamPlan
from repro_torch.device import resolve_device
from repro_torch.launch import serve as sv
from repro_torch.train import steps as st

STEPS, SEED = 8, 0
TOP = 8  # kernels listed per phase
REPEATS = 5  # unprofiled wall-time repeats


def _device_us(evt) -> float:
    # the attribute's name changed across PyTorch releases
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


#: the record_function spans the paged profile marks
SPANS = ("assemble_view", "update_current")


def _breakdown(prof, wall_s: float, n: int, top: int) -> dict:
    """Device busy time and the top kernels, per unit (request or step).
    Only device-side events count: an operator's own entry repeats the
    time of the kernels it launched, and a ``record_function`` span's
    device-side entry covers the kernels inside it (and the gaps)."""
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in SPANS
            and not getattr(e, "is_user_annotation", False)]
    kernels = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)
    return {
        "wall_ms_per_unit": wall_s * 1e3 / n,
        "device_busy_ms_per_unit": busy_us / 1e3 / n,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s) if busy_us else None,
        "kernel_launches_per_unit": sum(r[2] for r in kernels) / n,
        "top_kernels": [
            {"name": k[:80], "ms_per_unit": us / 1e3 / n, "share_of_busy": us / busy_us,
             "calls_per_unit": c / n}
            for k, us, c in kernels[:top]
        ],
        # every kernel's launches, to tell two paths' launch counts apart
        "launches_by_kernel": {k[:120]: c / n for k, _, c in kernels},
    }


def _span_device_ms(prof, name: str, n: int) -> float:
    """Device time (ms per unit) of the kernels launched inside the
    ``record_function(name)`` spans: the host-side span's device total."""
    for e in prof.key_averages():
        if e.key == name and e.device_type != DeviceType.CUDA:
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            return us / 1e3 / n
    return 0.0


def profile_paged(cfg, params, prompts, args, report: dict) -> None:
    """Profile one paged decode step of a full batch (see the module
    docstring)."""
    page = args.kv_page_len
    warm = 2
    gen = warm + REPEATS * STEPS + STEPS + 1  # no request retires while measured
    session = sv.ServeSession(cfg, slots=prompts.shape[0], max_len=args.prompt_len + gen, kv_kind=args.kv_kind,
                              page_len=page, params=params)
    try:
        for row in prompts.cpu().numpy():
            session.submit(row, gen)
        session.admit_pending()
        for _ in range(warm):
            session.step()
        torch.cuda.synchronize()
        reps, waits = [], []
        for _ in range(REPEATS):
            w0 = len(session.step_waits)
            t0 = time.perf_counter()
            for _ in range(STEPS):
                session.step()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / STEPS)
            waits += session.step_waits[w0:]
        reps.sort()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                session.step()
            torch.cuda.synchronize()
        name = (f"paged decode (one batched step; pages of {page}, cold pages at "
                f"{args.kv_kind})")
        report[name] = r = _breakdown(prof, reps[0] * STEPS, STEPS, TOP)
        r["wall_ms_per_unit_repeats"] = [w * 1e3 for w in reps]
        r["assemble_view_device_ms"] = _span_device_ms(prof, "assemble_view", STEPS)
        r["update_current_device_ms"] = _span_device_ms(prof, "update_current", STEPS)
        r["transfer_wait_ms_per_step"] = {"mean": 1e3 * sum(waits) / len(waits),
                                          "median": 1e3 * sorted(waits)[len(waits) // 2],
                                          "max": 1e3 * max(waits)}
        st = session.stats
        r["h2d_bytes_per_step"] = st.bytes_h2d / session.n_steps
        r["peak_resident_bytes"] = session.pager.peak_resident_bytes
        r["total_cache_bytes"] = session.pager.total_cache_bytes()
    finally:
        session.close()
    idle = r["device_idle_share"]
    busy = r["device_busy_ms_per_unit"]
    print(f"{name}: wall {r['wall_ms_per_unit']:.3f} ms (min of {REPEATS}; median "
          f"{reps[len(reps) // 2] * 1e3:.3f}), device busy {busy:.3f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}, "
          f"{r['kernel_launches_per_unit']:.0f} kernel launches")
    share = f"{r['assemble_view_device_ms'] / busy:.3f}" if busy else "not measured"
    print(f"    assemble_view {r['assemble_view_device_ms']:.4f} ms of device time a step "
          f"({share} of busy), update_current {r['update_current_device_ms']:.4f} ms")
    w = r["transfer_wait_ms_per_step"]
    print(f"    compute-blocked transfer wait a step: mean {w['mean']:.3f} ms, median "
          f"{w['median']:.3f}, max {w['max']:.3f}; H2D {r['h2d_bytes_per_step']:.0f} B a step; "
          f"peak resident {r['peak_resident_bytes']} of {r['total_cache_bytes']} B")
    for k in r["top_kernels"]:
        print(f"    {k['ms_per_unit']:.4f} ms  {k['share_of_busy']:.3f}  x{k['calls_per_unit']:.0f}  {k['name']}")


def profile_streamed(cfg, params, prompts, args, report: dict) -> None:
    """Profile the unpaged decode step with streamed weights (see the
    module docstring).  ``params`` is unused: the home is drawn group by
    group."""
    dev = prompts.device
    batch = prompts.shape[0]
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), device_budget_mb=args.device_budget_mb,
                            expert_stream=args.expert_stream)
    home, store = sv._weight_home(plan, st.init_weight_streamed_params(cfg, plan, SEED, dev),
                                  args.param_kind, None)
    engine = TransferEngine(EngineConfig(max_distance=plan.max_distance_for_budget()), device=dev)
    stats = StreamStats()
    residency = ResidencyCache(plan.residency_capacity_bytes())
    kw = dict(engine=engine, stats=stats, residency=residency)
    max_len = args.prompt_len + STEPS + 2
    decode = st.make_weight_streamed_decode_step(cfg, plan, paged=False,
                                                 route_experts=not args.all_experts, **kw)
    es = decode.expert_stats or StreamStats()
    try:
        first, caches = sv.prefill_all(
            cfg, home, prompts, max_len,
            lambda b: st.make_weight_streamed_prefill_step(cfg, plan, b, max_len, **kw))

        def decode_steps():
            tok = first
            for i in range(STEPS):
                pos = sv.step_pos(cfg, batch, args.prompt_len + i, dev)
                logits, _ = decode(home, caches, sv._step_batch(cfg, tok, dev), pos)
                tok = sv._greedy(logits)
            torch.cuda.synchronize()

        decode_steps()  # warm-up
        reps = []
        def counts():
            return (stats.bytes_h2d, stats.h2d_requests, stats.disk_requests,
                    stats.unique_group_fetches, stats.transfer_wait_s, es.bytes_h2d,
                    es.unique_group_fetches, es.cache_hits, es.transfer_wait_s)

        counts0 = counts()
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            decode_steps()
            reps.append((time.perf_counter() - t0) / STEPS)
        n = REPEATS * STEPS
        per_step = [(now - was) / n for now, was in zip(counts(), counts0)]
        reps.sort()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode_steps()
        counters = residency.counters()
    finally:
        engine.close()
        residency.clear()
        if store is not None:
            store.close()
    experts = ("" if not plan.expert_stream else
                "; all experts" if args.all_experts else "; routed experts")
    name = (f"streamed decode (one batched step; weights at {args.param_kind}, budget "
            f"{args.device_budget_mb} MB, {plan.n_groups} groups{experts})")
    report[name] = r = _breakdown(prof, reps[0] * STEPS, STEPS, TOP)
    r["wall_ms_per_unit_repeats"] = [w * 1e3 for w in reps]
    (r["h2d_bytes_per_step"], r["h2d_requests_per_step"], r["disk_requests_per_step"],
     r["groups_fetched_per_step"], wait, e_bytes, e_fetches, e_hits, e_wait) = per_step
    r["transfer_wait_ms_per_step"] = wait * 1e3
    if plan.expert_stream:
        r["expert_bytes_per_step"] = e_bytes
        r["expert_groups_fetched_per_step"] = e_fetches
        r["expert_resident_hits_per_step"] = e_hits
        r["expert_transfer_wait_ms_per_step"] = e_wait * 1e3
        r["experts_fetched_per_layer"] = (e_fetches + e_hits) / cfg.n_layers
    r["n_groups"] = plan.n_groups
    r["residency"] = counters
    idle = r["device_idle_share"]
    print(f"{name}: wall {r['wall_ms_per_unit']:.3f} ms (min of {REPEATS}; median "
          f"{reps[len(reps) // 2] * 1e3:.3f}), device busy {r['device_busy_ms_per_unit']:.3f} ms, "
          f"idle share {'not measured' if idle is None else f'{idle:.3f}'}, "
          f"{r['kernel_launches_per_unit']:.0f} kernel launches")
    print(f"    compute-blocked transfer wait a step {r['transfer_wait_ms_per_step']:.3f} ms; "
          f"H2D {r['h2d_bytes_per_step']:.0f} B in {r['h2d_requests_per_step']:.2f} requests, "
          f"{r['disk_requests_per_step']:.2f} disk requests, {r['groups_fetched_per_step']:.2f} "
          f"groups fetched a step; residency {r['residency']}")
    if plan.expert_stream:
        print(f"    experts a step: {r['expert_bytes_per_step']:.0f} B H2D in "
              f"{r['expert_groups_fetched_per_step']:.2f} fetched groups, "
              f"{r['expert_resident_hits_per_step']:.2f} resident hits, "
              f"{r['experts_fetched_per_layer']:.2f} experts a MoE layer, transfer wait "
              f"{r['expert_transfer_wait_ms_per_step']:.3f} ms")
    for k in r["top_kernels"]:
        print(f"    {k['ms_per_unit']:.4f} ms  {k['share_of_busy']:.3f}  x{k['calls_per_unit']:.0f}  {k['name']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--attn-impl", default="pallas", choices=("xla", "pallas"),
                    help="pallas: the CUDA attention kernels; xla: the plain path")
    ap.add_argument("--kv-page-len", type=int, default=0,
                    help="> 0: profile the paged decode step with pages of this many tokens")
    ap.add_argument("--kv-kind", default="device", choices=sv.KV_KINDS,
                    help="home of the cold pages (with --kv-page-len)")
    ap.add_argument("--param-kind", default="device", choices=PARAM_KINDS,
                    help="home of the weights: a host kind profiles the streamed decode step")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="device budget of the streamed weights (with --param-kind)")
    ap.add_argument("--expert-stream", action="store_true",
                    help="MoE: per-expert fetch groups, routed decode (with --param-kind)")
    ap.add_argument("--all-experts", action="store_true",
                    help="with --expert-stream: fetch all experts a MoE layer (the baseline)")
    ap.add_argument("--out", default=None, help="also write the breakdown here as JSON")
    args = ap.parse_args()
    if args.kv_kind != "device" and args.kv_page_len <= 0:
        ap.error("--kv-kind needs --kv-page-len > 0")
    if args.param_kind != "device" and args.kv_page_len > 0:
        ap.error("--param-kind profiles the unpaged streamed step; leave --kv-page-len at 0")
    if args.expert_stream and args.param_kind == "device":
        ap.error("--expert-stream streams routed experts from a weight home; it requires "
                 "--param-kind pinned_host or disk_host")

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), attn_impl=args.attn_impl)
    try:
        sv._check_servable(cfg)
    except ValueError as e:
        ap.error(str(e))
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    prompt = args.prompt_len
    batch = args.batch
    # streamed weights are drawn group by group inside profile_streamed
    params = st.init_params(cfg, SEED, dev) if args.param_kind == "device" else None
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=g, device=dev)
    report = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
              "attn_impl": args.attn_impl, "batch": batch, "prompt_len": prompt,
              "n_layers": cfg.n_layers, "kv_page_len": args.kv_page_len, "kv_kind": args.kv_kind}
    if args.kv_page_len > 0 or args.param_kind != "device":
        report.update(param_kind=args.param_kind, device_budget_mb=args.device_budget_mb,
                      expert_stream=args.expert_stream, all_experts=args.all_experts)
        (profile_paged if args.kv_page_len > 0 else profile_streamed)(cfg, params, prompts, args,
                                                                       report)
        _write(args.out, report)
        return 0
    max_len = prompt + STEPS + 2
    decode = st.make_decode_step(cfg)

    def prefill_once():
        return sv.prefill_all(cfg, params, prompts, max_len)

    tokens, caches = prefill_once()

    def decode_steps(caches, tokens):
        for i in range(STEPS):
            pos = sv.step_pos(cfg, batch, prompt + i, dev)
            logits, caches = decode(params, caches, sv._step_batch(cfg, tokens, dev), pos)
            tokens = sv._greedy(logits)
        return tokens

    decode_steps(st.clone_caches(caches), tokens)  # warm-up
    torch.cuda.synchronize()

    schedule = "lock-step" if sv.lock_step(cfg) else "one request at a time"
    phases = ((f"prefill (per request; batch of {batch}, {schedule})", prefill_once, batch),
              ("decode (one batched step)", lambda: decode_steps(caches, tokens), STEPS))
    # wall times first, without the profiler: once it has run, its tracing
    # adds host time to every later launch
    walls = []
    for _, fn, _ in phases:
        reps = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        walls.append(sorted(reps))
    for (name, fn, n), reps in zip(phases, walls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the idle share is read against the fastest repeat: host noise only adds
        report[name] = r = _breakdown(prof, reps[0], n, TOP)
        r["wall_ms_per_unit_repeats"] = [w * 1e3 / n for w in reps]
        idle = r["device_idle_share"]
        print(f"{name}: wall {r['wall_ms_per_unit']:.3f} ms (min of {REPEATS}; median "
              f"{r['wall_ms_per_unit_repeats'][len(reps) // 2]:.3f}), device busy "
              f"{r['device_busy_ms_per_unit']:.3f} ms, idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}, "
              f"{r['kernel_launches_per_unit']:.0f} kernel launches")
        for k in r["top_kernels"]:
            print(f"    {k['ms_per_unit']:.4f} ms  {k['share_of_busy']:.3f}  x{k['calls_per_unit']:.0f}  {k['name']}")
    _write(args.out, report)
    return 0


def _write(out, report: dict) -> None:
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    raise SystemExit(main())
