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
      [--arch smollm-360m|recurrentgemma-2b] [--prompt-len 512] \\
      [--attn-impl pallas|xla] [--out profile_serve.json]

Batch 4, random bf16 weights from seed 0; 8 decode steps are profiled.
chip_smoke.py's cells take prompt 512 for smollm-360m and 3072 for
recurrentgemma-2b (longer than its 2048 window).  Prefill times are per
request: the batch's over 4.

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
from repro_torch.device import resolve_device
from repro_torch.launch import serve as sv
from repro_torch.train import steps as st

BATCH, STEPS, SEED = 4, 8, 0
TOP = 8  # kernels listed per phase
REPEATS = 5  # unprofiled wall-time repeats


def _device_us(evt) -> float:
    # the attribute's name changed across PyTorch releases
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def _breakdown(prof, wall_s: float, n: int, top: int) -> dict:
    """Device busy time and the top kernels, per unit (request or step).
    Only device-side events count: an operator's own entry repeats the
    time of the kernels it launched."""
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
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
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--attn-impl", default="pallas", choices=("xla", "pallas"),
                    help="pallas: the CUDA attention kernels; xla: the plain path")
    ap.add_argument("--out", default=None, help="also write the breakdown here as JSON")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), attn_impl=args.attn_impl)
    prompt = args.prompt_len
    params = st.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, prompt), generator=g, device=dev)
    max_len = prompt + STEPS + 2
    decode = st.make_decode_step(cfg)

    def prefill_once():
        return sv.prefill_all(cfg, params, prompts, max_len)

    first, caches = prefill_once()
    tokens = first.long()[:, None]

    def decode_steps(caches, tokens):
        for i in range(STEPS):
            pos = sv.step_pos(cfg, BATCH, prompt + i, dev)
            logits, caches = decode(params, caches, {"tokens": tokens}, pos)
            tokens = logits[:, -1].argmax(-1)[:, None]
        return tokens

    decode_steps(st.clone_caches(caches), tokens)  # warm-up
    torch.cuda.synchronize()

    report = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
              "attn_impl": args.attn_impl, "batch": BATCH, "prompt_len": prompt}
    schedule = "lock-step" if sv.lock_step(cfg) else "one request at a time"
    phases = ((f"prefill (per request; batch of {BATCH}, {schedule})", prefill_once, BATCH),
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
