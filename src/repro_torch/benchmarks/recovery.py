"""Recovery study: what the self-healing runtime costs and guarantees.

    PYTHONPATH=src python -m repro_torch.benchmarks.recovery [--device cpu]

The JAX package's ``benchmarks/recovery.py`` on the port's engine, spill
store and driver.  Six gates, the first on the deterministic modeled link:

  * **clean-path overhead**: enabling the transient-retry budget
    (``max_attempts=3``) on a fault-free streamed run adds <= 1% (+ 2 ms)
    to the compute-thread transfer wait vs the fail-fast engine, each side's
    minimum over ``REPEATS`` interleaved runs (the row keeps the medians
    beside);
  * **transient H2D fault** and **transient disk-staging fault**: one
    injected fault each; the run completes **bitwise-equal** to the
    unfaulted values with retry counters equal to the injected count;
  * **permanent fault**: surfaces after exactly ``max_attempts`` tries;
  * **spill integrity**: a flipped byte in a spill chunk is detected by CRC
    on fetch and recovered from the durable home within the gate time —
    values bitwise the originals;
  * **restart latency**: a driver-level fault -> restore -> first resumed
    step of :class:`~repro_torch.runtime.driver.TrainDriver` completes
    within the recovery-time gate.

Writes ``results/torch/BENCH_recovery.json``.  Runs on the card unless
``--device cpu``.  ``REPRO_BENCH_SMOKE=1`` shrinks the workload.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.core.engine import EngineConfig, GroupLayout, LinkModel, TransferEngine
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.spillstore import SpillStore
from repro_torch.device import DeviceLike, resolve_device

SMOKE = bool(int(os.environ.get("REPRO_BENCH_SMOKE", "0")))

N_GROUPS = 12 if SMOKE else 24
#: interleaved fail-fast / retry-enabled runs of the clean-overhead gate: a
#: run costs ~10 ms, and on a loaded host a minimum needs a few dozen runs
#: before each side has one that nothing preempted
REPEATS = 20 if SMOKE else 30
GROUP_SHAPE = (64, 64)

HOST_LINK = LinkModel(request_s=0.1e-3, bandwidth_Bps=500e6, latency_s=0.0)
DISK_LINK = LinkModel(request_s=0.3e-3, bandwidth_Bps=500e6, latency_s=4e-3)

#: clean-path gate: retry-enabled wait <= this ratio of fail-fast wait
CLEAN_OVERHEAD_RATIO = 1.01
CLEAN_OVERHEAD_ABS_S = 2e-3  # noise floor for near-zero waits
#: recovery-time gates (wall clock, generous for shared runners)
CRC_RECOVER_GATE_S = 5.0
RESTART_GATE_S = 5.0


def _host_groups(n=None):
    """``n`` groups, ``N_GROUPS`` as the module holds it at the call (a
    caller may shrink the study)."""
    n = N_GROUPS if n is None else n
    rng = np.random.default_rng(0)
    return [{"w": rng.standard_normal(GROUP_SHAPE).astype(np.float32)} for _ in range(n)]


def _apply(carry, g):
    return carry + torch.sum(g["w"]), {"w": g["w"] * 1.0001}


def _expected(w: np.ndarray) -> np.ndarray:
    """What ``_apply`` writes back, computed the same way on the CPU."""
    return (torch.from_numpy(w) * 1.0001).numpy()


def _run_stream(groups, cfg, device):
    st = StreamStats()
    with HostStreamExecutor(_apply, writeback=True, engine_config=cfg, device=device) as ex:
        _, outs = ex.run(torch.zeros((), device=ex.device), groups, mode="prefetch", stats=st)
    return st, outs


def _bitwise(outs, groups) -> bool:
    return all(np.array_equal(o["w"].numpy(), _expected(g["w"])) for o, g in zip(outs, groups))


# ---------------------------------------------------------------------------
# clean-path overhead of the retry machinery
# ---------------------------------------------------------------------------


def bench_clean_overhead(device):
    """Fail-fast and retry-enabled runs interleaved, ``REPEATS`` of each; the
    gate reads each side's minimum run total, the least-interference
    estimate (a preempted thread only ever adds wait)."""
    groups = _host_groups()
    waits = {1: [], 3: []}
    for _ in range(REPEATS):
        for attempts in (1, 3):
            st, _ = _run_stream(groups, EngineConfig(link=HOST_LINK, max_attempts=attempts), device)
            assert st.retries == 0 and st.give_ups == 0
            waits[attempts].append(st.transfer_wait_s)
    base, retry = min(waits[1]), min(waits[3])
    ok = retry <= base * CLEAN_OVERHEAD_RATIO + CLEAN_OVERHEAD_ABS_S
    return {"case": "clean_overhead", "wait_fail_fast_s": base, "wait_retry_enabled_s": retry,
            "wait_fail_fast_median_s": statistics.median(waits[1]),
            "wait_retry_enabled_median_s": statistics.median(waits[3]),
            "repeats": REPEATS, "ratio": retry / base if base else 1.0,
            "gate_ratio": CLEAN_OVERHEAD_RATIO, "retries": 0, "pass": bool(ok)}


# ---------------------------------------------------------------------------
# injected transient / permanent faults
# ---------------------------------------------------------------------------


def bench_transient_h2d(device):
    groups = _host_groups()
    real = GroupLayout.put_staged
    faults = {"n": 0}

    def flaky(self, *a, **kw):
        if faults["n"] == 0:
            faults["n"] += 1
            raise RuntimeError("bench: transient H2D fault")
        return real(self, *a, **kw)

    GroupLayout.put_staged = flaky
    try:
        t0 = time.perf_counter()
        st, outs = _run_stream(groups, EngineConfig(max_attempts=3, retry_backoff_s=1e-4), device)
        dt = time.perf_counter() - t0
    finally:
        GroupLayout.put_staged = real
    bitwise = _bitwise(outs, groups)
    ok = st.retries == faults["n"] == 1 and st.give_ups == 0 and bitwise
    return {"case": "transient_h2d", "injected": faults["n"], "retries": st.retries,
            "give_ups": st.give_ups, "bitwise_equal": bool(bitwise), "run_s": dt, "pass": bool(ok)}


def bench_transient_disk(device):
    with tempfile.TemporaryDirectory() as d:
        store = SpillStore(d)
        host = _host_groups()
        disk = []
        for i, g in enumerate(host):
            store.put(f"g{i:04d}", g)
            disk.append(store.get(f"g{i:04d}"))
        real = TransferEngine._acquire_disk_staging
        faults = {"n": 0}

        def flaky(self, dsig, layout):
            if faults["n"] == 0:
                faults["n"] += 1
                raise RuntimeError("bench: transient disk-stage fault")
            return real(self, dsig, layout)

        TransferEngine._acquire_disk_staging = flaky
        try:
            st, outs = _run_stream(
                disk, EngineConfig(disk_link=DISK_LINK, max_attempts=3, retry_backoff_s=1e-4),
                device)
        finally:
            TransferEngine._acquire_disk_staging = real
        store.close()
    bitwise = _bitwise(outs, host)
    ok = st.retries == faults["n"] == 1 and st.give_ups == 0 and bitwise
    return {"case": "transient_disk", "injected": faults["n"], "retries": st.retries,
            "give_ups": st.give_ups, "bitwise_equal": bool(bitwise), "pass": bool(ok)}


def bench_permanent_fault(device):
    real = GroupLayout.put_staged
    calls = {"n": 0}

    def dead(self, *a, **kw):
        calls["n"] += 1
        raise RuntimeError("bench: permanent H2D fault")

    surfaced = False
    st = StreamStats()
    GroupLayout.put_staged = dead
    try:
        with HostStreamExecutor(lambda c, g: c, device=device, engine_config=EngineConfig(
                max_attempts=3, retry_backoff_s=1e-4)) as ex:
            try:
                ex.run(torch.zeros((), device=ex.device), _host_groups(2), mode="on_demand",
                       stats=st)
            except RuntimeError:
                surfaced = True
    finally:
        GroupLayout.put_staged = real
    ok = surfaced and calls["n"] == 3 and st.give_ups == 1
    return {"case": "permanent_fault", "max_attempts": 3, "tries": calls["n"],
            "surfaced": bool(surfaced), "give_ups": st.give_ups, "pass": bool(ok)}


# ---------------------------------------------------------------------------
# spill integrity: CRC detect + recover
# ---------------------------------------------------------------------------


def bench_crc_detect_recover(device):
    with tempfile.TemporaryDirectory() as d:
        store = SpillStore(d)
        host = _host_groups(4)
        disk = []
        for i, g in enumerate(host):
            store.put(f"g{i:04d}", g)
            disk.append(store.get(f"g{i:04d}"))
        store.set_recovery(lambda key: host[int(key[1:])])
        path = store.dir / store._entry("g0001")["file"]
        raw = bytearray(path.read_bytes())
        raw[16] ^= 0xFF
        path.write_bytes(bytes(raw))

        t0 = time.perf_counter()
        st, outs = _run_stream(disk, EngineConfig(), device)
        dt = time.perf_counter() - t0
        bitwise = _bitwise(outs, host)
        ok = store.crc_failures >= 1 and store.recoveries == 1 and bitwise and dt < CRC_RECOVER_GATE_S
        row = {"case": "crc_detect_recover", "crc_failures": store.crc_failures,
               "recoveries": store.recoveries, "bitwise_equal": bool(bitwise), "run_s": dt,
               "gate_s": CRC_RECOVER_GATE_S, "pass": bool(ok)}
        store.close()
    return row


# ---------------------------------------------------------------------------
# driver restart latency
# ---------------------------------------------------------------------------


def bench_driver_restart(device):
    from repro_torch.runtime.driver import DriverConfig, TrainDriver

    marks = {}

    def step_fn(state, batch):
        if batch == 6 and "fault" not in marks:
            marks["fault"] = time.perf_counter()
            raise RuntimeError("bench: injected driver fault")
        if batch == 6 and "resumed" not in marks:
            marks["resumed"] = time.perf_counter()
        x = torch.as_tensor(state["x"], device=device) + 1.0
        return {"x": x}, {"loss": float(torch.sum(x))}

    with tempfile.TemporaryDirectory() as d:
        cfg = DriverConfig(total_steps=10, checkpoint_every=2, checkpoint_dir=d, log_every=0)
        drv = TrainDriver(cfg, step_fn, lambda i: i,
                          lambda: {"x": torch.zeros(64, dtype=torch.float32, device=device)})
        drv.run()
    recover_s = marks["resumed"] - marks["fault"]
    ok = drv.restarts == 1 and recover_s < RESTART_GATE_S
    return {"case": "driver_restart", "restarts": drv.restarts, "fault_to_resume_s": recover_s,
            "gate_s": RESTART_GATE_S, "pass": bool(ok)}


def main(device: DeviceLike = None) -> int:
    device = resolve_device(device)
    rows = [
        bench_clean_overhead(device),
        bench_transient_h2d(device),
        bench_transient_disk(device),
        bench_permanent_fault(device),
        bench_crc_detect_recover(device),
        bench_driver_restart(device),
    ]
    C.print_table(f"recovery: retry / integrity / restart gates ({device})", rows,
                  ["case", "retries", "give_ups", "bitwise_equal", "run_s", "fault_to_resume_s", "pass"])
    out = C.save_rows("BENCH_recovery", rows)
    print(f"saved {out}")
    failed = [r["case"] for r in rows if not r["pass"]]
    if failed:
        print(f"FAILED gates: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
