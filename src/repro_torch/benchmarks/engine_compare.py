"""Seed-style per-leaf streaming vs the coalesced transfer engine (A/B).

    PYTHONPATH=src python -m repro_torch.benchmarks.engine_compare [--device cpu]

The JAX package's ``benchmarks/engine_compare.py`` on the port.  The
offload_modes workload (the paper's Fig-3 ML benchmark: feed-forward ``ro``
streaming + combine-gradients ``rw`` streaming) with train-loop group
structure, run through ``HostStreamExecutor`` under two engine configs:

``seed``
    ``EngineConfig(coalesce=False, async_writeback=False)`` — one H2D
    request per pytree leaf per group, blocking D2H per ``rw`` group.
``engine``
    the default config — coalesced single-request groups, staging-buffer
    reuse, pipelined writeback.

Two link regimes per config: ``real`` (the card's PCIe link from pinned
host memory; on the CPU by request, a copy) and ``paper`` (the engine's
link emulation at the paper's Epiphany constants, 88 MB/s and 0.104 ms a
request).  Gates, the JAX package's: the engine reaches 1 H2D request a
group on the real link, the seed more than 1, and the engine beats the seed
schedule's prefetch-mode wall time by >= 20% on the paper link (the larger
of the median and the minimum ratios).  Values are bitwise equal across
configs and links.

On the card it also prints the **pack/link split**: for this workload's
group, Fig 4's 6 MB ``w1`` group and smollm-360m's streamed-weight groups
as its serving path packs them (the embed, a layers and the tied head's
fetch group of its ``WeightStreamPlan`` at the 160 MB budget, homed as
``init_home`` homes them, random from a seed), the host time of
``GroupLayout.pack_into`` into pinned staging and, separately, the
CUDA-event time of its ``put_staged`` copy and of a bare copy of the same
bytes, each as GB/s, with the packing share; and the sums over the plan's
pass of 34 groups.  The engine itself is not timed or changed for it.

Writes ``results/torch/BENCH_engine.json``.
"""
from __future__ import annotations

import argparse
import collections
import statistics
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.benchmarks.offload_modes import home_on_host
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_array
from repro_torch.core.engine import EngineConfig, GroupLayout, PAPER_EPIPHANY_LINK
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device

CONFIGS = {
    "seed": lambda link: EngineConfig(coalesce=False, async_writeback=False, link=link),
    "engine": lambda link: EngineConfig(link=link),
}

#: leaves per weight group — real train-loop groups (one transformer layer's
#: param dict) are many-leaf pytrees, which is where the seed's one-request-
#: per-leaf schedule multiplies (the paper's request-count penalty)
N_W_PARTS = 6
N_PIXELS, GROUPS, BATCH_IMAGES = 3600, 16, 8
SPEC = PrefetchSpec(buffer_size=6, elements_per_fetch=1, distance=2)
REPEATS = 5
SPEEDUP_GATE = 1.20

#: the pack/link split: timed repeats a group, and its larger groups
SPLIT_REPEATS = 10
FIG4_GROUPS = 120
FIG4_W1_GROUP = (15_000, 100)  # 1.8M pixels / 120 groups x 100 hidden, f32: 6,000,000 B
SMOLLM_BUDGET_MB = 160  # smollm-360m's streamed-weight serving budget (34 groups)


def _workload(device: torch.device, n_pixels: int = N_PIXELS, groups: int = GROUPS,
              batch_images: int = BATCH_IMAGES, params: Optional[dict] = None,
              images: Optional[tuple] = None):
    """The offload_modes ML workload with train-loop group structure: ro
    groups ``{x, w: (6 parts)}`` for feed-forward, rw groups with the
    device-resident upstream gradient ``dh`` for combine-gradients.

    ``params`` (``{"w1", "w2"}``) and ``images`` (``(xs, ys)``) are numpy
    arrays when given (the JAX package's, in the parity tests), else made
    from the config's seed.  Host leaves are homed at the paper's ``Host``
    kind (pinned on the card; numpy on the CPU), each part contiguous."""
    cfg = C.LungNNConfig(n_pixels=n_pixels, batch_images=batch_images)
    if params is None:
        params = {k: v.cpu().numpy() for k, v in C.init_lung_nn(cfg, device).items()}
    if images is None:
        images = tuple(t.cpu().numpy() for t in C.make_images(cfg, batch_images, device))
    w1, w2 = (np.array(params[k], np.float32) for k in ("w1", "w2"))
    xs, ys = (np.array(a, np.float32) for a in images)
    gp = n_pixels // groups
    hp = cfg.n_hidden // N_W_PARTS

    def host(a: np.ndarray):
        return home_on_host(torch.from_numpy(np.ascontiguousarray(a)), device)

    w1_groups = [tuple(host(w1[i * gp:(i + 1) * gp, j * hp:(j + 1) * hp]) for j in range(N_W_PARTS))
                 for i in range(groups)]
    x_groups = [host(xs[:, i * gp:(i + 1) * gp]) for i in range(groups)]

    w1_d, w2_d = (torch.from_numpy(a).to(device) for a in (w1, w2))
    xs_d, ys_d = (torch.from_numpy(a).to(device) for a in (xs, ys))
    h = torch.sigmoid(xs_d @ w1_d[:, :hp * N_W_PARTS])
    p = torch.sigmoid(h @ w2_d[:hp * N_W_PARTS])
    dh = ((p - ys_d) @ w2_d[:hp * N_W_PARTS].T) * h * (1 - h)

    def ff_apply(carry, group):
        w = torch.cat(group["w"], dim=1)
        return carry + group["x"] @ w

    def grad_apply(carry, group):
        w = torch.cat(group["w"], dim=1)
        gw = group["x"].T @ group["dh"]  # dh passes by reference (device)
        return carry + torch.sum(gw * w), gw

    ff_groups = [{"x": x, "w": w} for x, w in zip(x_groups, w1_groups)]
    rw_groups = [{"x": x, "w": w, "dh": dh} for x, w in zip(x_groups, w1_groups)]
    ff_carry = torch.zeros((batch_images, hp * N_W_PARTS), device=device)
    return ff_apply, ff_groups, ff_carry, grad_apply, rw_groups


def run(device: DeviceLike = None, params: Optional[dict] = None,
        images: Optional[tuple] = None) -> tuple[list[dict], dict]:
    """Every (link, config) row; returns ``(rows, values)``, ``values`` the
    ff carry, the rw carry and the written-back groups of each row as
    numpy, bitwise equal across rows."""
    dev = resolve_device(device)
    ff_apply, ff_groups, ff_carry, grad_apply, rw_groups = _workload(dev, params=params,
                                                                     images=images)
    rows, values = [], {}
    for link_name, link in (("real", None), ("paper", PAPER_EPIPHANY_LINK)):
        for cfg_name, make_cfg in CONFIGS.items():
            out = {}
            # -- ro phase: feed forward ---------------------------------------
            st = StreamStats()
            with HostStreamExecutor(ff_apply, engine_config=make_cfg(link), device=dev) as ex:
                t = C.timed(lambda: out.__setitem__("ff", ex.run(
                    ff_carry, ff_groups, mode="prefetch", prefetch=SPEC, stats=st)[0]),
                    stats=st, repeats=REPEATS)

            # -- rw phase: combine gradients (writeback) ----------------------
            st2 = StreamStats()
            with HostStreamExecutor(grad_apply, writeback=True, engine_config=make_cfg(link),
                                    device=dev) as ex2:
                def rw_run():
                    out["rw"], out["rw_groups"] = ex2.run(
                        torch.zeros((), device=dev), rw_groups, mode="prefetch", prefetch=SPEC,
                        stats=st2)
                t2 = C.timed(rw_run, stats=st2, repeats=REPEATS)
            values[(link_name, cfg_name)] = {
                "ff": out["ff"].cpu().numpy(), "rw": out["rw"].cpu().numpy(),
                "rw_groups": [g.cpu().numpy() for g in out["rw_groups"]]}

            per = max(st.n_runs, 1)
            per2 = max(st2.n_runs, 1)
            rows.append({
                "link": link_name,
                "config": cfg_name,
                "ff_s": t["median_s"],
                "rw_s": t2["median_s"],
                "total_s": t["median_s"] + t2["median_s"],
                # min over repeats: the least-interference estimate — what
                # the gate reads beside the median
                "total_min_s": t["min_s"] + t2["min_s"],
                "h2d_requests_per_group": st.requests_per_group,
                "rw_h2d_requests_per_group": st2.requests_per_group,
                "d2h_requests": st2.d2h_requests // per2,
                "transfer_wait_s": st.transfer_wait_s / per,
                "rw_transfer_wait_s": st2.transfer_wait_s / per2,
                "writeback_drain_s": st2.writeback_drain_s / per2,
                "wait_hist": st.wait_hist(),
            })

    by = {(r["link"], r["config"]): r for r in rows}
    for link_name in ("real", "paper"):
        seed, eng = by[(link_name, "seed")], by[(link_name, "engine")]
        eng["speedup_vs_seed"] = seed["total_s"] / eng["total_s"]
        eng["speedup_min_vs_seed"] = seed["total_min_s"] / eng["total_min_s"]
        seed["speedup_vs_seed"] = seed["speedup_min_vs_seed"] = 1.0

    C.print_table(
        f"coalesced transfer engine vs seed per-leaf schedule (prefetch mode) — {C.card_label(dev)}",
        rows,
        ["link", "config", "ff_s", "rw_s", "total_s", "h2d_requests_per_group", "d2h_requests",
         "speedup_vs_seed", "speedup_min_vs_seed"],
    )
    C.save_rows("BENCH_engine", rows)  # after the speedup columns exist

    # schedules and links never change a value
    first = values[("real", "seed")]
    for key, v in values.items():
        assert np.array_equal(v["ff"], first["ff"]), f"{key}: feed-forward carry differs"
        assert np.array_equal(v["rw"], first["rw"]), f"{key}: gradient carry differs"
        assert all(np.array_equal(a, b) for a, b in zip(v["rw_groups"], first["rw_groups"])), \
            f"{key}: written-back groups differ"
    return rows, values


def gates(rows: list[dict]) -> tuple[bool, str]:
    """The JAX package's gates over ``run``'s rows, and the line it prints."""
    by = {(r["link"], r["config"]): r for r in rows}
    one_req = by[("real", "engine")]["h2d_requests_per_group"] == 1.0
    seed_req = by[("real", "seed")]["h2d_requests_per_group"]
    eng = by[("paper", "engine")]
    speedup = max(eng["speedup_vs_seed"], eng["speedup_min_vs_seed"])
    line = (f"requests/group: engine {by[('real', 'engine')]['h2d_requests_per_group']:.0f} vs seed "
            f"{seed_req:.0f}; paper-link wall-time speedup: {speedup:.2f}x "
            f"(median {eng['speedup_vs_seed']:.2f}x, min {eng['speedup_min_vs_seed']:.2f}x; "
            f"gate: >= {SPEEDUP_GATE:.2f}x)")
    return bool(one_req and seed_req > 1 and speedup >= SPEEDUP_GATE), line


# ---------------------------------------------------------------------------
# the pack/link split of one group's staged transfer (card only)
# ---------------------------------------------------------------------------


def smollm_groups() -> list[tuple[str, dict, int]]:
    """smollm-360m's streamed-weight fetch groups as its serving path packs
    them: ``(name, fetch tree, groups of that kind in a pass)`` for the
    embed group, the first layers group and the tied head's fetch group (its
    ``ln_f`` and the borrowed embed table) of the ``WeightStreamPlan`` at
    ``SMOLLM_BUDGET_MB``.  Each home is what ``init_home`` makes of it (host
    numpy leaves, bf16 as ``BF16HostArray``), random from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.train.steps import abstract_params

    cfg = get_config("smollm-360m")
    shapes = abstract_params(cfg)
    plan = WeightStreamPlan(cfg, shapes, device_budget_mb=SMOLLM_BUDGET_MB)
    gen = torch.Generator().manual_seed(0)

    def leaf(meta: torch.Tensor):
        return host_array((torch.randn(meta.shape, generator=gen) * 0.02).to(meta.dtype))

    picks = [next(g for g in plan.groups if g.kind == kind) for kind in ("embed", "layers", "head")]
    home = {"groups": {g.key: tr.tree_map(leaf, plan.home_group(shapes, g)) for g in picks}}
    counts = collections.Counter(g.kind for g in plan.groups)
    return [(f"smollm-360m {g.kind} group", plan.fetch_group(home, g), counts[g.kind])
            for g in picks]


def split_groups(device: torch.device) -> list[tuple[str, dict, int]]:
    """The split's groups, ``(name, group, groups of its kind in a pass)``:
    this workload's ff group and Fig 4's ``w1`` group (f32, pinned on the
    card, as their suites home them), and smollm-360m's ``smollm_groups``."""
    _, ff_groups, *_ = _workload(device)
    rng = np.random.default_rng(0)
    fig4 = torch.from_numpy(rng.standard_normal(FIG4_W1_GROUP, dtype=np.float32))
    if device.type == "cuda":
        fig4 = fig4.pin_memory()
    return [("engine_compare ff group", ff_groups[0], GROUPS),
            ("Fig 4 w1 group", {"w": fig4}, FIG4_GROUPS)] + smollm_groups()


def _event_s(stream, fn) -> tuple[float, Any]:
    """CUDA-event seconds of what ``fn`` enqueues on ``stream``, and what
    ``fn`` returned."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def pack_link_split(device: DeviceLike = None) -> list[dict]:
    """For each split group, medians over ``SPLIT_REPEATS``: ``pack_s``, the host
    time of ``GroupLayout.pack_into`` into pinned staging; ``link_s``, the
    CUDA-event time of its ``put_staged`` copy on a side stream (the copy's
    device allocation and launch included); ``whole_s``, the host time of
    the group's whole staged transfer (pack, copy, the copy's event
    synchronised), as the engine's worker runs it; and ``dma_s``, the
    events around a bare copy of the same staging into a buffer allocated
    beforehand: the link itself."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the pack/link split times a copy to the card; it needs one")
    copy_stream = torch.cuda.Stream(dev)
    consumer = torch.cuda.current_stream(dev)
    rows = []
    for name, group, per_pass in split_groups(dev):
        leaves = tr.leaves(group)
        layout = GroupLayout(group, device=dev)
        staging = layout.new_staging()
        flat = torch.empty((layout.staging_bytes,), dtype=torch.uint8, device=dev)
        packs, links, wholes, dmas = [], [], [], []
        for i in range(SPLIT_REPEATS + 1):  # the first is a warm-up
            t0 = time.perf_counter()
            layout.pack_into(leaves, staging)
            t1 = time.perf_counter()
            link, (_, event) = _event_s(
                copy_stream, lambda: layout.put_staged(staging, copy_stream, consumer))
            event.synchronize()
            t2 = time.perf_counter()
            with torch.cuda.stream(copy_stream):
                dma, _ = _event_s(copy_stream, lambda: flat.copy_(staging, non_blocking=True))
            if i:
                packs.append(t1 - t0)
                links.append(link)
                wholes.append(t2 - t0)
                dmas.append(dma)
        nbytes = layout.payload_bytes
        pack_s, link_s, dma_s = (statistics.median(x) for x in (packs, links, dmas))
        rows.append({"group": name, "bytes": nbytes, "leaves": layout.n_packed, "per_pass": per_pass,
                     "pack_s": pack_s, "link_s": link_s, "whole_s": statistics.median(wholes),
                     "dma_s": dma_s, "pack_GBps": nbytes / pack_s / 1e9,
                     "link_GBps": nbytes / link_s / 1e9, "dma_GBps": nbytes / dma_s / 1e9,
                     "pack_share": pack_s / (pack_s + link_s)})
    C.print_table(f"pack/link split of one group's staged transfer (medians) — "
                  f"{C.card_label(dev)}", rows,
                  ["group", "bytes", "pack_s", "link_s", "whole_s", "dma_s", "pack_GBps",
                   "link_GBps", "dma_GBps", "pack_share"])
    smollm = [r for r in rows if r["group"].startswith("smollm-360m")]
    n = sum(r["per_pass"] for r in smollm)
    nbytes = sum(r["per_pass"] * r["bytes"] for r in smollm)
    pack, link, whole = (sum(r["per_pass"] * r[k] for r in smollm)
                         for k in ("pack_s", "link_s", "whole_s"))
    print(f"smollm-360m, a pass of its {n} groups ({nbytes:,} B), the per-group medians summed: "
          f"pack {pack * 1e3:.3f} ms, link {link * 1e3:.3f} ms, whole staged transfers "
          f"{whole * 1e3:.3f} ms (one thread, no compute beside it)")
    C.save_rows("BENCH_engine_split", rows)
    return rows


def main(device: DeviceLike = None) -> int:
    dev = resolve_device(device)
    rows, _ = run(dev)
    ok, line = gates(rows)
    print(line)
    if dev.type == "cuda":
        pack_link_split(dev)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
