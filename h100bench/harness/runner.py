"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up (counted in ``setup_s``, from the process's start to the window's):
the program's import, its meta set-up, the weights from the seed, the
session with its home and stream, the warm-up of the cell's own prefill
buckets and decode step, and the traffic's priming.  Nothing compiles in
the window: the program's kernels are built ahead (into the checkout's
``build/``) and loaded at their first call in the warm-up.

Every run measures the same untraced window, from which the end-to-end
metrics and the per-layer metrics of the host's clock and the program's
counters are read.  A traced run (``--trace 1``) goes on under the profiler
for a second window of the same mix (``TRACE_S`` long at most), from which
the device's metrics are read, so that the profiler's cost on the host
shows in none of the others.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import types
from typing import Callable, Optional

import numpy as np
import torch

from . import check, counts, program, stats, trace, traffic, window
from .spec import Cell, session_args

#: intra-op threads of the run's process
HOST_THREADS = 1
#: the longest traced window, in seconds: reading the profiler's events
#: takes ~4 s a traced second at the chat cell's launch rate, and a 45 s
#: traced window took its runs to 325-355 s (PERF.md)
TRACE_S = 15.0
#: the StreamStats counters read before and after the window
COUNTERS = ("transfer_wait_s", "bytes_h2d", "h2d_requests", "unique_group_fetches",
            "cache_hits")


def _counters(session) -> dict:
    out = {}
    for name in ("stats", "param_stats", "expert_stats"):
        st = getattr(session, name, None)
        out[name] = {k: getattr(st, k) for k in COUNTERS} if st is not None else None
    return out


def _delta(after: dict, before: dict) -> dict:
    return {n: None if a is None else {k: a[k] - before[n][k] for k in a}
            for n, a in after.items()}


def _buckets(lo: int, hi: int, cap: int) -> list:
    """Prompt widths to warm: each power of two from the one that holds
    ``lo`` to the one that holds ``hi`` (the session's prefill buckets)."""
    out, b = [], 8
    while b < lo:
        b *= 2
    while True:
        out.append(min(b, cap))
        if b >= hi or b >= cap:
            return out
        b *= 2


def warm(session, traffic_spec: dict, vocab: int) -> None:
    """Prefill one request at each of the cell's prompt buckets and decode
    it once, then one decode step over every slot: every shape the window
    uses, and no other."""
    rng = np.random.default_rng(0)
    lo, hi = traffic_spec["prompt_len"]
    for b in _buckets(lo, hi, session.max_len - 2):
        session.submit(rng.integers(1, vocab, size=b, dtype=np.int32), 2)
        session.admit_pending()
        while session.active:
            session.step()
    session.warmup()


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    numbers: dict
    notes: dict
    breakdown: Optional[dict] = None
    detail: Optional[dict] = None


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        control: bool = False, plant: Optional[Callable] = None) -> Result:
    """One run.  ``t_start`` is the process's start on ``time.perf_counter``.
    ``plant(session)`` may break the session underneath (the fault tests)."""
    dev = torch.device(device)
    marks = {"start_s": time.perf_counter() - t_start}

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks[name] = time.perf_counter() - t_start

    cfg = program.port_config(cell.config)
    vocab = cell.config["vocab_size"]
    profiled = traced and trace.available(dev)
    trace_s = min(seconds, TRACE_S)
    reqs, start = traffic.timeline(cell.traffic, seed, seconds, vocab,
                                   after=trace_s if profiled else 0.0)
    prompts = {r.index: r.prompt for r in reqs}
    home = cell.config["weights_home"]
    params = program.make_params(cfg, cell.config, seed, dev, home)
    mark("weights_s")
    session = program.open_session(cfg, session_args(cell.config, cell.traffic), params, dev)
    del params
    mark("session_s")
    # from the warm-up on: the loop only launches work, and idle OpenMP
    # workers spinning beside it spread its steps (tpot_p90_ms 13-22 % over
    # a set against 7-9 % on one thread: PERF.md)
    torch.set_num_threads(HOST_THREADS)
    traced_win, summary = None, None
    try:
        if plant is not None:
            plant(session)
        warm(session, cell.traffic, vocab)
        mark("warm_s")
        loop = window.Loop(session, dev)
        drv = window.Driver(loop, reqs, cell.traffic["loop"] == "closed", start)
        drv.run_until(0.0)
        setup_s = loop.t0 - t_start  # the window opens at the loop's 0
        before = _counters(session)
        drv.run_until(seconds)
        delta = _delta(_counters(session), before)
        win = drv.window(0.0, seconds)
        if profiled:  # device metrics from a traced window that follows
            with trace.Tracer(True) as tr:
                drv.run_until(seconds + trace_s)
            traced_win = drv.window(seconds, trace_s)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if profiled:
            t0_ns = int(traced_win.start_wall * 1e9)
            summary = trace.summarize(tr.device_events(), t0_ns, t0_ns + int(trace_s * 1e9))
            del tr
    finally:
        session.close()
    del session, loop, drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic, window=win,
                                traced_window=traced_win, seconds=seconds, setup_s=setup_s,
                                counters=delta, trace=summary, counts=counts, stats=stats)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}

    t_ref = time.perf_counter()
    smp = cell.limits["sample"]
    picked = check.sample(win, seed, smp["requests"], smp["finished_only"])
    numbers, detail = check.compare(cell.config, prompts, picked, seed, dev, control=control)
    offered = stats.in_window(win)
    failed = sum(1 for s in offered if s.rejected)
    attempted = len(offered)
    marks["reference_s"] = time.perf_counter() - t_ref
    marks["prime_s"] = -start
    marks["steps"] = len(win.steps)
    marks["prefills"] = len(win.admissions)
    marks["gen_lag_p90_s"] = stats.percentile(win.gen_lag_s, 90)
    ok, checks = check.judge(numbers, cell.limits["limits"])
    ok = ok and failed == 0 and attempted > 0
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    bd = None
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        bd = trace.breakdown(summary, traced_win)
    return Result(ok, attempted, failed, metrics, dev_info, checks, numbers, marks, bd, detail)
