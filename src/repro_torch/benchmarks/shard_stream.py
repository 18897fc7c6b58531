"""Sharding-aware coalesced streaming vs the per-leaf fallback (A/B).

    PYTHONPATH=src python -m repro_torch.benchmarks.shard_stream [--device cpu]

The JAX package's ``benchmarks/shard_stream.py`` on the port.  The paper's
offload penalty scales with the request count; the coalescing engine
collapses a group to one request, and under a mesh to one request a
(rank, group).  Sixteen groups of an ``x`` (8, 48) and twelve weight parts
(48, 32), the parts sharded over ``model`` (``P(None, "model")``) and ``x``
replicated, stream through ``HostStreamExecutor(device_shardings=...)`` on
a ``(data 1, model n)`` mesh under the paper's Epiphany link model:

``per_leaf``
    ``EngineConfig(coalesce=False)`` with the same shardings: one request a
    (host leaf, local shard).
``sharded``
    the default engine: one coalesced H2D request a (rank, group), the
    leaves DTensors.

Each rank runs its own engine (one process a rank, ``parallel/__init__.py``).
A row's integer counts are summed over the ranks (the JAX package's
one-process counts), ``requests_per_device_group`` is each rank's own, and
the times are the slowest rank's.  Gates, the JAX package's: the sharded
schedule costs exactly one request a (rank, group); the per-leaf one
``(1 + N_W_PARTS) x n`` a group; the steady-state wait a group is at least
2x lower; every schedule's result is bitwise the eager sharded run's.
Writes ``results/torch/BENCH_shard.json`` (rank 0).

``main`` runs the body in place when a process group is up (``n`` its
world size); otherwise it re-runs this module under ``torch.distributed.run
--standalone`` on localhost: two gloo ranks with ``--device cpu``, one
NCCL rank on the card (one card holds one NCCL rank).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: weight parts a group: the per-leaf schedule costs (1 + N_W_PARTS) x n
#: requests a group, the engine n
N_W_PARTS = 12
N_GROUPS = 16
#: ranks of the re-run on the CPU (the JAX package's forced device count)
N_DEVICES = 2
COLLAPSE_GATE = 2.0

#: summed over the ranks (the JAX package's counts); the times are the
#: slowest rank's
SUMMED = ("n_devices", "requests_per_group", "h2d_requests", "bytes_h2d")
SLOWEST = ("transfer_wait_s", "steady_wait_per_group_s", "total_s", "total_min_s")


def _across_ranks(values: list, op, device: torch.device) -> list:
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return t.tolist()


def run_body(device: DeviceLike = None) -> tuple[list[dict], bool]:
    """Both rows on the process group that is up, with its world size as
    the model axis; returns ``(rows, bitwise)``, every rank the same."""
    import torch.distributed as dist

    from repro_torch.benchmarks import common as C
    from repro_torch.core.engine import PAPER_EPIPHANY_LINK, EngineConfig
    from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
    from repro_torch.core.memkind import sharding_for
    from repro_torch.core.refspec import AUTO, PrefetchSpec
    from repro_torch.launch.mesh import is_rank0, make_local_mesh
    from repro_torch.parallel.sharding import P

    dev = resolve_device(device)
    n = dist.get_world_size()
    smoke = bool(os.environ.get("REPRO_BENCH_SMOKE"))
    repeats = 3 if smoke else 5
    mesh = make_local_mesh(model=n, device=dev.type)

    # small leaves: the link's per-request cost (what coalescing collapses)
    # dominates the serial bandwidth term
    rng = np.random.default_rng(0)
    groups = [
        {"x": rng.standard_normal((8, 48)).astype(np.float32),
         "w": tuple(rng.standard_normal((48, 32)).astype(np.float32)
                    for _ in range(N_W_PARTS))}
        for _ in range(N_GROUPS)
    ]
    shardings = {"x": sharding_for(mesh, P()),
                 "w": tuple(sharding_for(mesh, P(None, "model")) for _ in range(N_W_PARTS))}

    def apply(carry, g):
        # each rank's columns: its shards of the parts, side by side
        w = torch.cat([part.to_local() for part in g["w"]], dim=1)
        return carry + g["x"].to_local() @ w

    carry0 = torch.zeros((8, 32 // n * N_W_PARTS), device=dev)
    spec = PrefetchSpec(buffer_size=N_GROUPS + 2, distance=AUTO)

    # the bitwise reference: eager sharded placement, the same apply
    eager = [{"x": shardings["x"].put(g["x"]),
              "w": tuple(s.put(w) for s, w in zip(shardings["w"], g["w"]))} for g in groups]
    with HostStreamExecutor(apply, device_shardings=shardings, device=dev) as ex:
        ref, _ = ex.run(carry0, eager, mode="eager")

    configs = {"per_leaf": EngineConfig(coalesce=False, link=PAPER_EPIPHANY_LINK),
               "sharded": EngineConfig(link=PAPER_EPIPHANY_LINK)}
    rows, bitwise = [], True
    for name, cfg in configs.items():
        st = StreamStats()
        with HostStreamExecutor(apply, device_shardings=shardings, engine_config=cfg,
                                device=dev) as ex:
            t = C.timed(lambda: ex.run(carry0, groups, mode="prefetch", prefetch=spec,
                                       stats=st)[0], stats=st, repeats=repeats)
            out, _ = ex.run(carry0, groups, mode="prefetch", prefetch=spec)
        bitwise = bitwise and torch.equal(out, ref)
        waits = list(st.wait_per_group)
        per = max(st.n_runs, 1)
        rows.append({
            "config": name,
            "n_devices": st.n_devices,
            "n_leaves": 1 + N_W_PARTS,
            "requests_per_group": st.requests_per_group,
            "requests_per_device_group": st.per_tier()["h2d"]["requests_per_device_group"],
            "h2d_requests": st.h2d_requests // per,
            "bytes_h2d": st.bytes_h2d // per,
            "transfer_wait_s": st.transfer_wait_s / per,
            "steady_wait_per_group_s": float(np.median(waits[len(waits) // 2:])),
            "total_s": t["median_s"],
            "total_min_s": t["min_s"],
            "final_distance": st.distance_trace[-1] if st.distance_trace else None,
        })

    # across the ranks: counts summed, times the slowest rank's, the
    # per-(rank, group) ratio and the bitwise check each rank's own
    red = dev if dev.type == "cuda" else torch.device("cpu")
    for r in rows:
        own = r["requests_per_device_group"]
        lo, hi = _across_ranks([own, -own], dist.ReduceOp.MIN, red)
        r["requests_per_device_group"] = own if lo == -hi else float("nan")
        for k, v in zip(SUMMED, _across_ranks([r[k] for k in SUMMED], dist.ReduceOp.SUM, red)):
            r[k] = v if k == "requests_per_group" else int(v)
        for k, v in zip(SLOWEST, _across_ranks([r[k] for k in SLOWEST], dist.ReduceOp.MAX, red)):
            r[k] = v
    bitwise = _across_ranks([float(bitwise)], dist.ReduceOp.MIN, red)[0] == 1.0
    by = {r["config"]: r for r in rows}
    by["sharded"]["wait_collapse_vs_per_leaf"] = (
        by["per_leaf"]["steady_wait_per_group_s"]
        / max(by["sharded"]["steady_wait_per_group_s"], 1e-9))
    by["per_leaf"]["wait_collapse_vs_per_leaf"] = 1.0
    for r in rows:
        r["bitwise_equal_to_eager_sharded"] = bitwise
    if is_rank0():
        C.print_table(
            f"sharded coalesced streaming vs per-leaf fallback ({n}-rank mesh, paper link) — "
            f"{C.card_label(dev)}", rows,
            ["config", "n_devices", "requests_per_group", "requests_per_device_group",
             "steady_wait_per_group_s", "transfer_wait_s", "total_s",
             "wait_collapse_vs_per_leaf"])
        C.save_rows("BENCH_shard", rows)
    return rows, bitwise


def gates(rows: list[dict], n: int) -> tuple[bool, str]:
    """The JAX package's gates at world size ``n``; ``(ok, line)``."""
    by = {r["config"]: r for r in rows}
    eng, leaf = by["sharded"], by["per_leaf"]
    one_per_device = eng["requests_per_device_group"] == 1.0
    storm = leaf["requests_per_group"] == (1 + N_W_PARTS) * n
    collapse = eng["wait_collapse_vs_per_leaf"]
    bitwise = eng["bitwise_equal_to_eager_sharded"]
    line = (f"requests/group: sharded {eng['requests_per_group']:.0f} (= ranks, "
            f"{eng['requests_per_device_group']:.2f} a (rank, group)) vs per-leaf "
            f"{leaf['requests_per_group']:.0f} (= n_leaves x n_shards, {n} ranks); steady-wait "
            f"collapse {collapse:.1f}x (gate: >= {COLLAPSE_GATE:.0f}x); bitwise equal to eager "
            f"sharded placement: {bitwise}")
    return one_per_device and storm and collapse >= COLLAPSE_GATE and bitwise, line


def main(device: DeviceLike = None) -> int:
    """The suite: in place on the process group that is up, else re-run on
    its own ranks (two gloo ranks on the CPU, one NCCL rank on the card)."""
    import torch.distributed as dist

    if dist.is_initialized():
        rows, _ = run_body(device)
        ok, line = gates(rows, dist.get_world_size())
        if dist.get_rank() == 0:
            print(line)
        return 0 if ok else 1
    dev = resolve_device(device)
    nproc = N_DEVICES if dev.type == "cpu" else 1
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), "-m", "repro_torch.benchmarks.shard_stream", "--device", dev.type]
    sys.stdout.flush()
    return subprocess.run(cmd, env=env).returncode


def _rank_main(device: Optional[str]) -> int:
    """One rank of the re-run: join the group ``torchrun`` describes, run
    the suite, leave."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_env

    if not init_from_env(device):
        return main(device)
    try:
        return main(device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(_rank_main(ap.parse_args().device))
