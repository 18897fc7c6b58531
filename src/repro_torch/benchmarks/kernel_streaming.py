"""Kernel-level prefetch study: the streamed matmul's copy schedule.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_streaming

The in-kernel analogue of the paper's §3.1 knobs: the weight operand stays
in device memory and its tiles stream through the shared-memory ring of
``csrc/streamed_matmul.cu``.  :func:`kernel_sweep` runs the kernel at 512³
f32 for four (distance, slots) rings, each checked against the plain
version, with the ring's schedule from the kernel's tiles and split plan,
and its time on the card.  :func:`host_stream_sweep` runs the same K-tile
schedule one level up: weight tiles stream through the transfer engine over
an emulated link (``SWEEP_LINK``), fixed distances against
``distance="auto"``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.core.engine import EngineConfig, LinkModel
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul
from repro_torch.kernels.streamed_matmul import ops as smm

#: emulated link for the host-stream sweep: modest occupancy, a 2 ms
#: completion latency — the term prefetch depth exists to hide.  distance=1
#: cannot cover it; the adaptive controller must find the window that does.
SWEEP_LINK = LinkModel(request_s=0.104e-3, bandwidth_Bps=2e9, latency_s=2e-3)


def _kernel_ms(fn, reps: int = 20) -> float:
    """Mean time of one launch on the card (CUDA events)."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_sweep(device: DeviceLike = None, seed: int = 0) -> list[dict]:
    """The JAX package's 512³ f32 ring sweep on the port's kernel."""
    dev = resolve_device(device)
    m = k = n = 512
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev)
    ref = matmul_ref(x, w)
    plan = smm.split_plan(m, n, k)
    # every block copies its split's k-tiles: one stage per (output tile, k-tile)
    tiles = plan.grid[0] * plan.grid[1] * (-(-k // smm.BLOCK_K))
    stage = smm.stage_bytes(torch.float32)
    rows = []
    for dist, slots in [(0, 1), (1, 2), (2, 3), (4, 5)]:
        spec = PrefetchSpec(buffer_size=slots, elements_per_fetch=1, distance=dist)
        out = streamed_matmul(x, w, spec=spec, block_k=128)
        rows.append({
            "distance": dist,
            "ring_slots": slots,
            "splits": plan.splits,
            "copy_issues": tiles,
            "bytes_per_stage": stage,
            "smem_ring_bytes": smm.ring_bytes(torch.float32, slots),
            "overlapped": dist > 0,
            "matches_oracle": bool(torch.allclose(out, ref, atol=1e-3)),
            "ms": (_kernel_ms(lambda: streamed_matmul(x, w, spec=spec))
                   if dev.type == "cuda" else None),
        })
    C.print_table("streamed matmul copy schedule (paper §3.1 knobs, kernel level)", rows,
                  ["distance", "ring_slots", "splits", "copy_issues", "bytes_per_stage",
                   "smem_ring_bytes", "matches_oracle", "ms"])
    C.save_rows("kernel_streaming", rows)
    return rows


def host_stream_sweep(device: DeviceLike = None, seed: int = 0) -> list[dict]:
    """The same K-tile schedule at the host level: weight tiles stream
    through the TransferEngine while the tile matmul computes.  Every
    setting must equal eager bit for bit."""
    dev = resolve_device(device)
    m = n = 256
    k = 2048
    bk = 128
    rng = np.random.default_rng(seed)
    x_host = rng.standard_normal((m, k)).astype(np.float32)
    w_host = rng.standard_normal((k, n)).astype(np.float32)
    n_tiles = k // bk
    groups = [(x_host[:, i * bk:(i + 1) * bk], w_host[i * bk:(i + 1) * bk]) for i in range(n_tiles)]

    def apply(carry, g):
        xt, wt = g
        return carry + xt @ wt

    rows = []
    ref = None
    for dist in ("eager", 1, 2, 4, AUTO):
        with HostStreamExecutor(apply, engine_config=EngineConfig(link=SWEEP_LINK, max_distance=8),
                                device=dev) as ex:
            mode = "eager" if dist == "eager" else "prefetch"
            spec = None if dist == "eager" else PrefetchSpec(
                buffer_size=10, elements_per_fetch=1, distance=dist)
            zeros = torch.zeros((m, n), device=dev)
            ex.run(zeros, groups, mode=mode, prefetch=spec)  # warm
            best = None
            for _ in range(2):  # best of two: the host is shared
                st = StreamStats()
                out, _ = ex.run(zeros, groups, mode=mode, prefetch=spec, stats=st)
                if best is None or st.transfer_wait_s < best.transfer_wait_s:
                    best = st
            st = best
        out = out.cpu()
        if ref is None:
            ref = out
        tail = list(st.wait_per_group)[n_tiles // 2:]
        rows.append({
            "distance": dist,
            "transfer_wait_s": st.transfer_wait_s,
            "steady_wait_s": float(sum(tail)),
            "final_distance": st.distance_trace[-1] if st.distance_trace else None,
            "requests_per_group": st.requests_per_group,
            "matches_eager": bool(torch.equal(out, ref)),
        })
    C.print_table("host-stream K-tile schedule: fixed vs adaptive prefetch distance "
                  "(emulated 2 ms-latency link)", rows,
                  ["distance", "transfer_wait_s", "steady_wait_s", "final_distance",
                   "matches_eager"])
    C.save_rows("kernel_streaming_host", rows)
    return rows


def main(device: DeviceLike = None) -> int:
    rows = kernel_sweep(device)
    host_rows = host_stream_sweep(device)
    by = {r["distance"]: r for r in host_rows}
    auto_beats_d1 = by[AUTO]["steady_wait_s"] < by[1]["steady_wait_s"]
    print(f"adaptive distance: steady-state wait {by[AUTO]['steady_wait_s'] * 1e3:.2f} ms "
          f"(converged window {by[AUTO]['final_distance']}) vs distance=1 "
          f"{by[1]['steady_wait_s'] * 1e3:.2f} ms -> {'OK' if auto_beats_d1 else 'FAIL'}")
    ok = (all(r["matches_oracle"] for r in rows)
          and all(r["matches_eager"] for r in host_rows) and auto_beats_d1)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
