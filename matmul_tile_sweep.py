#!/usr/bin/env python3
"""Time the f32 route of ``streamed_matmul`` at each tile and split plan it
could be built with, and beside it the f32 kernel of another checkout.

    python3 matmul_tile_sweep.py [--baseline DIR] [--passes N] [--variants A,B,...]

The f32 route's output tile, k-tile and outputs per thread are
compile-time constants of ``csrc/streamed_matmul.cu``, mirrored in its
wrapper; its split plan's aims (``TARGET_BLOCKS``, ``MIN_SPLIT_KT``) are the
wrapper's, which passes the plan to the kernel.  For each
entry of ``VARIANTS`` this copies the program into
``build/tile_sweep/<variant>/`` and sets them there, through
``decode_split_sweep.py``'s copy, build and run machinery; ``--baseline DIR``
(an unpacked checkout, such as ``git archive HEAD~1``) adds that checkout's
kernel, timed by the same code.  The copies' kernels build in parallel; each
copy then runs in its own process, ``N`` passes (default 2) in the order
baseline, ``VARIANTS``, then reversed.

Each run holds the route against its plain version (f32 rtol 2e-4 / atol
2e-3) at 512^3, listing 4's 256 x 512 x 256, 7 x 384 x 512 and 130^3 (by
cp.async), and bitwise across six rings at 512^3. Then, before any profiler
runs, it times the copy's own kernel sweep
(``benchmarks/kernel_streaming.py``: 20 calls back to back, L2 warm, so the
host's enqueue sets the pace where it is the slower side), the same run of
calls at the default ring with the host's time a call beside the device's
(:func:`back_to_back`, seven times), and the host time of one call (seven
readings of 200 calls each). Then, with the L2 flushed before every call
(``events`` and ``held``, as in the decode sweep), it times the kernel at
512^3 with the default ring beside ``torch.matmul`` (TF32 off), the kernel
sweep's four rings at 512^3, and listing 4 with its ring; and it reports
the kernels' registers from the build log, and from a ``torch.profiler``
trace the kernels a call launches, a call's device span and how far the
combine ends after the split kernel. Prints one line per run and a JSON
summary; exits 0 iff every copy agrees with the plain version. Needs a CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

import decode_split_sweep as sweep

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "tile_sweep"
_CU, _OPS = "csrc/streamed_matmul.cu", "kernels/streamed_matmul/ops.py"
#: the kernel sweep's rings (distance, slots), from benchmarks/kernel_streaming.py
SWEEP_RINGS = [(0, 1), (1, 2), (2, 3), (4, 5)]


def _tile(bm: int, bn: int, bk: int, tm: int, tn: int) -> list:
    """Edits to an output tile of ``bm`` x ``bn``, k-tiles of ``bk``, ``tm``
    x ``tn`` outputs a thread."""
    return [(_CU, "constexpr int BM = 64, BN = 64, BK = 32;  // output tile",
             f"constexpr int BM = {bm}, BN = {bn}, BK = {bk};  // output tile"),
            (_CU, "constexpr int TM = 8, TN = 4;", f"constexpr int TM = {tm}, TN = {tn};"),
            (_OPS, "BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32\n", f"BLOCK_M, BLOCK_N, BLOCK_K = {bm}, {bn}, {bk}\n")]


def _plan(target: int, min_kt: int) -> list:
    """Edits to a split plan that aims for ``target`` blocks, splits of at
    least ``min_kt`` k-tiles."""
    return [(_OPS, "TARGET_BLOCKS = 256\n", f"TARGET_BLOCKS = {target}\n"),
            (_OPS, "MIN_SPLIT_KT = 2\n", f"MIN_SPLIT_KT = {min_kt}\n")]


#: name -> edits; the name gives the tile (M x N x K), the outputs a thread and
#: the splits the plan makes at 512^3
VARIANTS = {
    "64x64x32_8x4_s4": [],  # as committed
    "64x64x32_4x8_s4": _tile(64, 64, 32, 4, 8),
    "64x64x32_8x8_s4": _tile(64, 64, 32, 8, 8),
    "128x64x16_8x8_s8": _tile(128, 64, 16, 8, 8),
    "128x64x16_8x4_s8": _tile(128, 64, 16, 8, 4),
    "64x64x32_8x4_s8": _plan(512, 2),
    "64x64x32_8x4_s4_min4": _plan(256, 4),  # listing 4 in 4 splits, not 8
    "64x64x32_8x4_s1": _plan(1, 2),
}


def back_to_back(fn, reps: int = 20) -> list[float]:
    """``[device ms, host ms]`` a call over ``reps`` calls queued back to
    back, L2 warm (the kernel sweep's method): the larger of the two sets
    the pace."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    host = (time.perf_counter() - h0) * 1e3 / reps
    e1.synchronize()
    return [e0.elapsed_time(e1) / reps, host]


def run_matmul(name: str) -> None:
    """In a copy: check, then time its f32 route; prints ``RESULT`` and the
    JSON of the run."""
    import torch

    import chip_smoke as C
    from repro_torch.benchmarks import kernel_streaming
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul

    resolve_device("cuda")  # TF32 off
    flush = sweep.flush_buffer()
    for m, k, n in [C.SWEEP_SHAPE, C.LISTING4_SHAPE, (7, 384, 512), (130, 130, 130)]:
        x, w = C.mm_inputs(m, k, n, torch.float32)
        C.check_close(f"{name} ({m},{k})@({k},{n})", streamed_matmul(x, w), matmul_ref(x, w), **C.F32_TOL)
    x, w = C.mm_inputs(*C.SWEEP_SHAPE, torch.float32)
    rings = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 4), (5, 6)]
    outs = [streamed_matmul(x, w, spec=PrefetchSpec(s, 1, d)) for d, s in rings]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise SystemExit(f"{name}: the value depends on the ring")
    kern = lambda: streamed_matmul(x, w)
    # first, before any profiler: the copy's own kernel sweep (20 calls back
    # to back) and the same run of calls with the host's time beside it
    out = dict(kernel_sweep={f"{r['distance']},{r['ring_slots']}": r["ms"]
                             for r in kernel_streaming.kernel_sweep("cuda")},
               back_to_back=[back_to_back(kern) for _ in range(7)],
               matmul_back_to_back=back_to_back(lambda: torch.matmul(x, w)),
               host_us=sorted(C.host_us(kern) for _ in range(7)))  # seven readings: the host is shared
    out.update(
        flush_ms=sweep.flush_ms(flush),
        registers=[int(r) for r in re.findall(r"Used (\d+) registers", _build.library_path(
            "streamed_matmul").with_suffix(".log").read_text())],
        kernel=sweep.both_ways(kern, flush),
        matmul=sweep.both_ways(lambda: torch.matmul(x, w), flush),
        by_ring={f"{d},{s}": sweep.both_ways(lambda: streamed_matmul(x, w, spec=PrefetchSpec(s, 1, d)), flush)
                 for d, s in SWEEP_RINGS},
    )
    (m, k, n), (d, s) = C.LISTING4_SHAPE, C.LISTING4_RING
    x4, w4 = C.mm_inputs(m, k, n, torch.float32)
    out["listing4"] = sweep.both_ways(lambda: streamed_matmul(x4, w4, spec=PrefetchSpec(s, 1, d)), flush)
    out["listing4_matmul"] = sweep.both_ways(lambda: torch.matmul(x4, w4), flush)
    out["device"] = sweep.device_spans(kern, flush, r"streamed_matmul\w*kernel", "streamed_matmul_f32_combine_kernel")
    print("RESULT " + json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an unpacked checkout whose f32 kernel is timed too")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--variants", help="comma-separated names of VARIANTS (default: all)")
    args = ap.parse_args()
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    dirs = {name: sweep.copy_with(WORK, name, ROOT / "src", VARIANTS[name]) for name in names}
    if args.baseline:
        dirs = {"baseline": sweep.copy_with(WORK, "baseline", args.baseline.resolve() / "src"), **dirs}
    sweep.build_copies(dirs, ["streamed_matmul"])
    runs, ok = sweep.run_copies(dirs, "matmul_tile_sweep.run_matmul", args.passes)
    fmt = sweep.fmt
    for r in runs:
        rings = ", ".join(f"({ring}) {fmt(t['held'])}" for ring, t in r["by_ring"].items())
        print(f"{r['copy']} (flush {r['flush_ms']:.4f} ms; mean/median/max ms):\n"
              f"  512^3 kernel events {fmt(r['kernel']['events'])} held {fmt(r['kernel']['held'])}; "
              f"torch.matmul events {fmt(r['matmul']['events'])} held {fmt(r['matmul']['held'])}\n"
              f"  by ring, held: {rings}\n"
              f"  listing 4 kernel held {fmt(r['listing4']['held'])}, torch.matmul held "
              f"{fmt(r['listing4_matmul']['held'])}; host us a call, min/median of 7: "
              f"{r['host_us'][0]:.1f}/{r['host_us'][3]:.1f}\n"
              f"  kernel sweep (back to back, L2 warm) by ring: {r['kernel_sweep']}; the default ring "
              f"[device, host] ms a call: {[[round(v, 5) for v in b] for b in r['back_to_back']]} "
              f"(torch.matmul {[round(v, 5) for v in r['matmul_back_to_back']]})\n"
              f"  on the device {r['device']}; registers {r['registers']}")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"tile_sweep": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
