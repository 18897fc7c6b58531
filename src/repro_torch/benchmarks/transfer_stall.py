"""Paper Table 2 analogue: per-transfer stall time vs transfer size.

    PYTHONPATH=src python -m repro_torch.benchmarks.transfer_stall [--device cpu]

The paper's synthetic benchmark measures the time a micro-core stalls per
single load for 128B / 1KB / 8KB transfers, on-demand vs prefetch, and finds
them *nearly identical per transfer* — the end-to-end gap (Fig 3/4) comes
from request COUNT.  The JAX package's ``benchmarks/transfer_stall.py`` on
the port: stall = the host time the consumer blocks on one host->device
transfer; prefetch hides it by issuing two copies ahead.

On the card the sources are page-locked and every copy is ``non_blocking``
on a side stream, its event recorded there: ``prefetch`` issues two copies
ahead and the stall is the time blocked in ``event.synchronize()`` at use;
``on_demand`` issues the copy at use and blocks.  The consumer
(``acc + x.sum()``) runs on the current stream after ``wait_event``, and
each buffer is ``record_stream``-ed there so that the caching allocator
does not hand its memory out before the consumer has read it.  A third
mode, ``on_demand_pageable``, copies from pageable memory: what pinning
buys on this card.  On the CPU (``--device cpu``) a transfer is a copy, as
the JAX package's ``device_put`` is there, and the pageable rows are left
out: the rows are the JAX package's.

Writes ``results/torch/table2_stall.json``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.device import DeviceLike, resolve_device

SIZES = (128, 1024, 8192, 262144, 2 ** 20)
N_TRANSFERS = 64
WARMUP = 4  # transfers dropped from the front of each run
#: the JAX package's modes; the card adds the pageable on-demand row
MODES = ("on_demand", "prefetch")
PAGEABLE = "on_demand_pageable"


def _measure(size_bytes: int, *, prefetch: bool, device: torch.device, pinned: bool = True,
             n: int = N_TRANSFERS) -> dict:
    elems = max(size_bytes // 4, 1)
    rng = np.random.default_rng(0)
    host = [torch.from_numpy(rng.standard_normal(elems).astype(np.float32)) for _ in range(n)]
    on_card = device.type == "cuda"
    if on_card and pinned:
        host = [t.pin_memory() for t in host]
    copy = torch.cuda.Stream(device) if on_card else None
    consumer = torch.cuda.current_stream(device) if on_card else None
    acc = torch.zeros((), device=device)

    def issue(src):
        if copy is None:
            return src.clone(), None
        with torch.cuda.stream(copy):
            buf = src.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy)
        buf.record_stream(consumer)
        return buf, event

    def consume(buf, event):
        nonlocal acc
        if event is not None:
            consumer.wait_event(event)
        acc = acc + buf.sum()

    stalls = []
    if prefetch:
        inflight = [issue(host[0]), issue(host[1])]
        for i in range(n):
            if i + 2 < n:
                inflight.append(issue(host[i + 2]))
            t0 = time.perf_counter()
            buf, event = inflight.pop(0)
            if event is not None:
                event.synchronize()  # stall only if the copy isn't done
            stalls.append(time.perf_counter() - t0)
            consume(buf, event)
    else:
        for i in range(n):
            t0 = time.perf_counter()
            buf, event = issue(host[i])  # issued at use time: full stall
            if event is not None:
                event.synchronize()
            stalls.append(time.perf_counter() - t0)
            consume(buf, event)
    float(acc)  # the consumer's work has run
    stalls = stalls[WARMUP:]
    return {
        "min_ms": min(stalls) * 1e3,
        "max_ms": max(stalls) * 1e3,
        "mean_ms": float(np.mean(stalls)) * 1e3,
    }


def run(device: DeviceLike = None) -> list[dict]:
    """Every (size, mode) row; the card adds ``on_demand_pageable``."""
    dev = resolve_device(device)
    modes = MODES + ((PAGEABLE,) if dev.type == "cuda" else ())
    rows = []
    for size in SIZES:
        for mode in modes:
            r = _measure(size, prefetch=(mode == "prefetch"), pinned=(mode != PAGEABLE),
                         device=dev)
            rows.append({"size": size, "mode": mode, **r})
    C.print_table(f"paper Table 2 analogue: stall time per transfer (ms) — {C.card_label(dev)}",
                  rows, ["size", "mode", "min_ms", "mean_ms", "max_ms"])
    C.save_rows("table2_stall", rows)
    return rows


def main(device: DeviceLike = None) -> int:
    rows = run(device)
    # claim: per-transfer stall is comparable across modes at small sizes
    small = [r for r in rows if r["size"] <= 8192]
    od = np.mean([r["mean_ms"] for r in small if r["mode"] == "on_demand"])
    pf = np.mean([r["mean_ms"] for r in small if r["mode"] == "prefetch"])
    print(f"small-transfer mean stall: on_demand {od:.4f} ms vs prefetch {pf:.4f} ms")
    by = {(r["size"], r["mode"]): r for r in rows}
    if (SIZES[-1], PAGEABLE) in by:
        print(f"1 MiB on-demand mean stall: pinned {by[(SIZES[-1], 'on_demand')]['mean_ms']:.4f} ms "
              f"vs pageable {by[(SIZES[-1], PAGEABLE)]['mean_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
