"""Benchmark aggregator: one harness per paper table/figure + the port's studies.

    PYTHONPATH=src python -m repro_torch.benchmarks.run                 # all, on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run fig3 table2     # a subset
    PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --device cpu
        # the modeled-link suites (engine, disk, serve, serve_slo, shard,
        # weights, recovery) at reduced size, on the CPU by request

The JAX package's ``benchmarks/run.py`` over the port's suites.  Each
suite's ``main(device)`` returns nonzero when its gate fails; a failing
suite makes the runner exit 1.  ``shard`` runs on the process group that
is up, or on its own ranks (two gloo ranks on the CPU, one NCCL rank on
the card; ``benchmarks/shard_stream.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import sys
import time
from typing import Optional, Sequence

import torch

SUITES = {
    "fig3": ("repro_torch.benchmarks.offload_modes", "paper Fig 3: eager/on-demand/prefetch (small images)"),
    "fig4": ("repro_torch.benchmarks.offload_modes_full", "paper Fig 4: full-size images"),
    "table1": ("repro_torch.benchmarks.power_model", "paper Table 1: throughput/power"),
    "table2": ("repro_torch.benchmarks.transfer_stall", "paper Table 2: stall vs transfer size"),
    "kernels": ("repro_torch.benchmarks.kernel_streaming", "kernel-level DMA schedule study"),
    "engine": ("repro_torch.benchmarks.engine_compare", "coalesced transfer engine vs seed per-leaf schedule"),
    "disk": ("repro_torch.benchmarks.disk_tier", "DiskHost three-level streaming (modeled disk link)"),
    "serve": ("repro_torch.benchmarks.serve_paged", "paged KV-cache serving vs per-step placement"),
    "serve_slo": ("repro_torch.benchmarks.serve_slo", "SLO load-generator serving: goodput under SLO + COW prefix sharing A/B"),
    "shard": ("repro_torch.benchmarks.shard_stream", "sharding-aware coalescing vs per-leaf fallback (2-device mesh)"),
    "weights": ("repro_torch.benchmarks.weight_stream", "streamed model parameters under a device budget (modeled link)"),
    "recovery": ("repro_torch.benchmarks.recovery", "self-healing runtime: retry overhead, fault bitwise-equality, CRC recovery, restart latency"),
}

#: the suites driven by the deterministic LinkModel emulation (the JAX
#: package's)
SMOKE_SUITES = ["engine", "disk", "serve", "serve_slo", "shard", "weights", "recovery"]


def run_suites(names: Sequence[str], device: Optional[str] = None) -> list[str]:
    """Run each suite's ``main(device)``; returns the names that failed.  On
    the CPU the suites run on one intra-op thread: their products are small
    (as XLA runs them, on one), and beside other busy processes a pool's
    threads wait on each other at every op, which took the weights suite
    from 41 to 88-98 s beside eight busy loops."""
    from repro_torch.benchmarks.common import one_cpu_thread

    cpu = device is not None and torch.device(device).type == "cpu"
    failures = []
    for name in names:
        mod_name, desc = SUITES[name]
        print(f"\n########## {name}: {desc} ##########")
        t0 = time.time()
        with one_cpu_thread(torch.device("cpu")) if cpu else contextlib.nullcontext():
            rc = importlib.import_module(mod_name).main(device)
        print(f"[{name}] rc={rc} ({time.time() - t0:.1f}s)")
        if rc:
            failures.append(name)
    return failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suites", nargs="*", help=f"any of {', '.join(SUITES)} (default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="the modeled-link suites at reduced size (REPRO_BENCH_SMOKE=1)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for name in args.suites:
        if name not in SUITES:
            ap.error(f"unknown suite {name!r}")
    if args.smoke:
        # read by the suites' modules when they are first imported
        os.environ["REPRO_BENCH_SMOKE"] = "1"
    names = args.suites or (SMOKE_SUITES if args.smoke else list(SUITES))
    failures = run_suites(names, args.device)
    if failures:
        print(f"\nFAILED suites: {failures}")
        return 1
    print(f"\nall {len(names)} benchmark suites passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
