"""Three-level streaming study: the DiskHost tier under modeled links.

    PYTHONPATH=src python -m repro_torch.benchmarks.disk_tier [--device cpu]

The JAX package's ``benchmarks/disk_tier.py`` on the port.  The paper hides
host latency behind compute with prefetch (§5.1); the ``DiskHost`` tier
repeats the trick one level down — disk fetches overlap behind
host->device transfers.  This suite streams spill-store groups through the
engine's two-stage pipeline under *two* modeled links (a host link and a
slower, higher-latency disk link) and records, per schedule:

  * requests/group per tier (coalescing: 1 H2D + 1 disk chunk per group),
  * the stall breakdown: compute-thread wait (compute-on-H2D), the
    transfer worker's disk wait (H2D-on-disk), and writeback drain,
  * steady-state tail waits for ``distance=1`` vs ``distance="auto"``.

Gates, the JAX package's: both tiers coalesce to 1 request/group, and at
``distance="auto"`` the adaptive window hides the disk latency — the
steady-state compute wait drops below half of the ``distance=1``
schedule's and below half of the serial disk cost it would pay
unoverlapped — and the window grows past 1.  The values are bitwise equal
across the schedules.  The host case's groups are homed at the paper's
``Host`` kind (pinned on the card; numpy on the CPU).  On the CPU the
study runs torch on one intra-op thread (``common.one_cpu_thread``).

Writes ``results/torch/BENCH_disk.json``.  ``REPRO_BENCH_SMOKE=1`` (set by
``repro_torch.benchmarks.run --smoke``) shrinks the workload.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.benchmarks.offload_modes import home_on_host
from repro_torch.core.engine import EngineConfig, LinkModel
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.spillstore import SpillStore
from repro_torch.device import DeviceLike, resolve_device

SMOKE = bool(int(os.environ.get("REPRO_BENCH_SMOKE", "0")))

N_GROUPS = 12 if SMOKE else 24
REPEATS = 2 if SMOKE else 5
GROUP_SHAPE = (64, 64)  # 16 KB f32 per leaf

#: the host link: the paper's request-cost regime, no latency tail
HOST_LINK = LinkModel(request_s=0.1e-3, bandwidth_Bps=500e6, latency_s=0.0)
#: the disk link: slower per request and high *latency* — the overlappable
#: term the disk read-ahead window hides (bandwidth deliberately >= the
#: host link's so the pipeline is latency-bound, not throughput-bound)
DISK_LINK = LinkModel(request_s=0.3e-3, bandwidth_Bps=500e6, latency_s=4e-3)


def host_groups(n: int) -> list[dict]:
    """The groups' values as numpy, from seed 0 (the JAX package's)."""
    rng = np.random.default_rng(0)
    return [{"w": rng.standard_normal(GROUP_SHAPE).astype(np.float32),
             "b": rng.standard_normal((GROUP_SHAPE[1],)).astype(np.float32)}
            for _ in range(n)]


def apply_ro(carry, g):
    return carry + torch.sum(g["w"] @ g["w"].T) + torch.sum(g["b"])


def apply_rw(carry, g):
    return carry + torch.sum(g["b"]), {"w": g["w"] * 1.0001, "b": g["b"]}


def _workload(tmpdir: str, device: torch.device):
    values = host_groups(N_GROUPS)
    store = SpillStore(tmpdir)
    disk_groups = []
    for i, g in enumerate(values):
        store.put(f"g{i:04d}", g)
        disk_groups.append(store.get(f"g{i:04d}"))
    homed = [{k: home_on_host(torch.from_numpy(v), device) for k, v in g.items()} for g in values]
    return homed, disk_groups, store


def _tail(xs, frac=0.5):
    xs = list(xs)
    return sum(xs[int(len(xs) * frac):])


def _row(name, source, distance, st: StreamStats, t: dict) -> dict:
    per = max(st.n_runs, 1)
    return {
        "schedule": name,
        "source": source,
        "distance": str(distance),
        "total_s": t["median_s"],
        "total_min_s": t["min_s"],
        "requests_per_group": st.requests_per_group,
        "disk_requests_per_group": st.disk_requests_per_group,
        "per_tier": st.per_tier(),
        "stall_breakdown": {
            "compute_on_h2d_s": st.transfer_wait_s / per,
            "h2d_on_disk_s": st.disk_wait_s / per,
            "writeback_drain_s": st.writeback_drain_s / per,
        },
        "tail_wait_s": _tail(st.wait_per_group) / per,
        "tail_disk_wait_s": _tail(st.disk_wait_per_group) / per,
        "final_distance": st.distance_trace[-1] if st.distance_trace else None,
        "wait_hist": st.wait_hist(),
    }


def run(device: DeviceLike = None) -> tuple[list[dict], dict]:
    """The four cases' rows, and ``values``: each ro case's carry and the rw
    case's carry and written-back groups, as numpy."""
    dev = resolve_device(device)
    rows, values = [], {}
    with tempfile.TemporaryDirectory(prefix="repro-torch-bench-disk-") as td, \
            C.one_cpu_thread(dev):
        homed, disk_groups, store = _workload(td, dev)
        cfg = EngineConfig(link=HOST_LINK, disk_link=DISK_LINK)
        try:
            # -- ro streaming: host-tier baseline + disk tier at d=1 / auto -
            for source, groups, dist in (("host", homed, 1), ("disk", disk_groups, 1),
                                         ("disk", disk_groups, AUTO)):
                spec = PrefetchSpec(buffer_size=N_GROUPS + 2, distance=dist)
                out = {}
                with HostStreamExecutor(apply_ro, engine_config=cfg, device=dev) as ex:
                    st = StreamStats()
                    t = C.timed(lambda: out.__setitem__("c", ex.run(
                        torch.zeros((), device=dev), groups, mode="prefetch", prefetch=spec,
                        stats=st)[0]), stats=st, repeats=REPEATS)
                values[(source, str(dist))] = out["c"].cpu().numpy()
                rows.append(_row("ro", source, dist, st, t))

            # -- rw streaming (moments-style writeback) from disk at auto ---
            spec = PrefetchSpec(buffer_size=N_GROUPS + 2, distance=AUTO)
            out = {}
            with HostStreamExecutor(apply_rw, writeback=True, engine_config=cfg, device=dev) as ex:
                st = StreamStats()

                def rw_run():
                    out["c"], out["groups"] = ex.run(
                        torch.zeros((), device=dev), disk_groups, mode="prefetch",
                        prefetch=spec, stats=st)
                t = C.timed(rw_run, stats=st, repeats=REPEATS)
            values[("rw", str(AUTO))] = (out["c"].cpu().numpy(),
                                         [{k: v.cpu().numpy() for k, v in g.items()}
                                          for g in out["groups"]])
            rows.append(_row("rw", "disk", AUTO, st, t))
        finally:
            store.close()

    # schedules never change values: disk == host, d=1 == auto, bitwise
    ro = [values[k] for k in (("host", "1"), ("disk", "1"), ("disk", str(AUTO)))]
    assert all(np.array_equal(v, ro[0]) for v in ro), "the ro schedules' carries differ"

    C.print_table(
        f"DiskHost three-level streaming (modeled host + disk links) — {C.card_label(dev)}",
        rows,
        ["schedule", "source", "distance", "total_s", "requests_per_group",
         "disk_requests_per_group", "tail_wait_s", "tail_disk_wait_s", "final_distance"],
    )
    C.save_rows("BENCH_disk", rows)
    return rows, values


def gates(rows: list[dict]) -> tuple[bool, str]:
    """The JAX package's gates over ``run``'s rows, and the line it prints."""
    by = {(r["schedule"], r["source"], r["distance"]): r for r in rows}
    d1 = by[("ro", "disk", "1")]
    auto = by[("ro", "disk", str(AUTO))]
    rw = by[("rw", "disk", str(AUTO))]

    one_req = all(r["requests_per_group"] == 1.0 for r in (d1, auto, rw)) and all(
        r["disk_requests_per_group"] == 1.0 for r in (d1, auto, rw))

    # the adaptive window must hide the disk latency: the steady-state
    # compute wait collapses vs the distance=1 schedule, and vs the serial
    # per-group disk cost (occupancy + latency) it would pay unoverlapped
    group_bytes = 4 * (GROUP_SHAPE[0] * GROUP_SHAPE[1] + GROUP_SHAPE[1])
    serial_disk_s = DISK_LINK.transfer_s(1, group_bytes) * (N_GROUPS // 2)
    hides_latency = (auto["tail_wait_s"] < 0.5 * d1["tail_wait_s"]
                     and auto["tail_wait_s"] < 0.5 * serial_disk_s)
    grew = (auto["final_distance"] or 0) > 1
    line = (f"requests/group: h2d {auto['requests_per_group']:.0f}, "
            f"disk {auto['disk_requests_per_group']:.0f} (gate: 1 each); "
            f"steady tail wait: auto {auto['tail_wait_s']*1e3:.2f} ms vs "
            f"d=1 {d1['tail_wait_s']*1e3:.2f} ms vs serial disk "
            f"{serial_disk_s*1e3:.2f} ms (gate: auto < 50% of both); "
            f"final distance {auto['final_distance']} (gate: > 1)")
    return bool(one_req and hides_latency and grew), line


def main(device: DeviceLike = None) -> int:
    rows, _ = run(device)
    ok, line = gates(rows)
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
