"""Where the paper path's time goes on the card: a torch.profiler breakdown.

Runs the lung-NN Fig 4 feed forward at the JAX package's full size (1.8M
pixels, 100 hidden, batch 2, 120 groups: 720 MB of f32 weights in pinned
host memory) through the ``HostStreamExecutor`` in each schedule, and for
each prints the host wall time of a pass (ended by a device synchronise;
the fastest and the median of a few unprofiled repeats), the
``StreamStats`` split of it (``transfer_wait_s``, ``compute_s``), and from
one profiled pass the device time in copies and in kernels and the
device's idle share.

  PYTHONPATH=src python -m repro_torch.launch.profile_offload [--out profile_offload.json]

Needs a CUDA card; it measures the device and has no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.benchmarks import common as C
from repro_torch.benchmarks import offload_modes as om
from repro_torch.benchmarks import offload_modes_full as full
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import _device_us

REPEATS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the breakdown here as JSON")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = C.LungNNConfig(n_pixels=full.N_PIXELS, batch_images=full.BATCH)
    params = C.init_lung_nn(cfg, dev)
    xs, _ = C.make_images(cfg, cfg.batch_images, dev)
    gp = cfg.n_pixels // full.N_GROUPS
    xs_host = om.home_on_host(xs.cpu(), dev)
    w1_host = om.home_on_host(params["w1"].cpu(), dev)
    groups = [(xs_host[:, i * gp:(i + 1) * gp], w1_host[i * gp:(i + 1) * gp])
              for i in range(full.N_GROUPS)]
    carry = torch.zeros((cfg.batch_images, cfg.n_hidden), device=dev)

    report = {"device": torch.cuda.get_device_name(dev), "n_groups": full.N_GROUPS}
    for mode in om.MODES:
        with HostStreamExecutor(om.ff_apply, device=dev) as ex:
            ex.run(carry, groups, prefetch=om.SPEC, mode=mode)  # warm
            walls, stats = [], []
            for _ in range(REPEATS):
                st = StreamStats()
                t0 = time.perf_counter()
                ex.run(carry, groups, prefetch=om.SPEC, mode=mode, stats=st)
                torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                stats.append(st)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex.run(carry, groups, prefetch=om.SPEC, mode=mode)
                torch.cuda.synchronize(dev)
                prof_wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        copy_us = sum(_device_us(e) for e in events if e.key.startswith("Memcpy"))
        kernel_us = sum(_device_us(e) for e in events if not e.key.startswith("Memcpy"))
        fastest = min(range(REPEATS), key=lambda i: walls[i])
        report[mode] = {
            "wall_ms_min": walls[fastest] * 1e3,
            "wall_ms_median": statistics.median(walls) * 1e3,
            "transfer_wait_ms": stats[fastest].transfer_wait_s * 1e3,
            "compute_ms": stats[fastest].compute_s * 1e3,
            "profiled_wall_ms": prof_wall * 1e3,
            "device_copy_ms": copy_us / 1e3,
            "device_kernel_ms": kernel_us / 1e3,
            "device_idle_share": 1.0 - (copy_us + kernel_us) / 1e6 / prof_wall,
            "kernel_launches": sum(e.count for e in events if not e.key.startswith("Memcpy")),
            "copies": sum(e.count for e in events if e.key.startswith("Memcpy")),
        }
        r = report[mode]
        print(f"{mode}: wall {r['wall_ms_min']:.3f} ms (median {r['wall_ms_median']:.3f}), "
              f"transfer_wait {r['transfer_wait_ms']:.3f} ms, compute {r['compute_ms']:.3f} ms; "
              f"profiled pass {r['profiled_wall_ms']:.3f} ms: device copies {r['device_copy_ms']:.3f} ms "
              f"({r['copies']}), kernels {r['device_kernel_ms']:.3f} ms ({r['kernel_launches']}), "
              f"idle share {r['device_idle_share']:.3f}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
