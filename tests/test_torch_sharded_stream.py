"""The sharding plan's consumers (``core/engine.py``'s ``ShardedGroupLayout``,
``HostStreamExecutor(device_shardings=...)``, ``memkind.place`` under a mesh,
``WeightStreamPlan.group_shardings``, the Sharder in the layer body) held
against the JAX package's on the same numpy inputs.

Two gloo ranks run the port in one subprocess (``torch.multiprocessing``
spawn, ``tcp://127.0.0.1:<free port>``); the JAX package runs in another on
a forced 2-device host mesh.  A JAX process addresses both devices; a port
rank addresses its own.  So:

* H2D requests and bytes summed over the ranks are the JAX package's counts
  exactly; each rank stages one request a (rank, group);
* per-(device, group) ratios (``requests_per_device_group``) are each
  rank's own the JAX package's;
* disk requests and bytes are each rank's the JAX package's: every rank
  reads its own home;
* staged groups are bitwise ``distribute_tensor`` of the host leaves, on
  the coalesced route and the per-leaf one (``coalesce=False``: one
  request a (leaf, local shard)), and every schedule's result bitwise the
  eager sharded run's;
* one train step and one prefill + decode step at meshes ``(1, 2)`` and
  ``(2, 1)`` agree with the JAX package's 2-device results within
  ``tests/test_kernels.py::_tol`` (f32).

``group_shardings`` is compared in-process on the shape-only ``_FakeMesh``
of every config.  ``tests/test_torch_sharded_models.py`` holds the other
archs' layer bodies and the serve and streamed paths under a mesh.  Each subprocess has its own timeout, and every process
group its 60 s one.
"""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.parallel import sharding as jax_sh
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import memkind as mk
from repro_torch.core import tree as tr
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.parallel import sharding as sh
from repro_torch.train import steps as st

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 300
F32_TOL = dict(rtol=2e-4, atol=2e-3)  # tests/test_kernels.py::_tol (f32)
#: AdamW's first update is lr * sign(g): a small rate keeps a sign flip of a
#: gradient within rounding of zero inside the tolerance (test_torch_train)
PARITY_OPT = dict(peak_lr=2e-4, warmup_steps=1, total_steps=6)
MESHES = {"mesh_1x2": 2, "mesh_2x1": 1}  # name -> model axis (of 2 ranks)
SEQ, BATCH, PROMPT = 16, 2, 12
N_GROUPS = 4


def _smoke_f32():
    return dataclasses.replace(jax_smoke("smollm-360m"), dtype="float32")


# ---------------------------------------------------------------------------
# the shared inputs
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    from repro.data.synthetic import SyntheticConfig, synthetic_batch

    jc = _smoke_f32()
    p, o = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)
    batch = synthetic_batch(jc, SyntheticConfig(jc.vocab_size, SEQ, BATCH, seed=1), 0)
    rng = np.random.default_rng(3)
    return {"params": jax.tree.map(np.asarray, p), "opt": jax.tree.map(np.asarray, o),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "prompts": rng.integers(1, jc.vocab_size, (BATCH, PROMPT)).astype(np.int32),
            "groups": [{"w": rng.standard_normal((4, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,))} for _ in range(N_GROUPS)]}


#: the layout sweep's cases (the JAX package's tests/test_coalesce_prop.py):
#: (name, leaves as (key, shape, dtype, sharding name))
SWEEP = [
    (f"{dt}-m{m}", [("w", (3, 2 * m), dt, "SH"), ("v", (2 * m,), dt, "SH0"),
                    ("rep_odd", (7,), "float32", "REP"), ("zero", (0,), dt, "REP"),
                    ("scalar", (), dt, "REP")])
    for dt in ("bfloat16", "float32", "int32", "float64") for m in (1, 3, 5)
] + [
    ("mixed-none", [("a", (2, 6), "float32", "SH"), ("b", (2, 4), "bfloat16", "REP"),
                    ("c", (4,), "int32", None), ("d", (4,), "float32", "SH0")]),
]
KINDS = ("device", "pinned_host", "unpinned_host", "disk_host")
CELLS = [(k, a, d) for a in ("ro", "rw") for k in KINDS for d in (0, 1, "auto")]


# ---------------------------------------------------------------------------
# the JAX package on a forced 2-device mesh
# ---------------------------------------------------------------------------

_JAX_CODE = r"""
import os, sys, json, pickle, tempfile
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.core import memkind as mk
from repro.core.engine import EngineConfig, TransferEngine
from repro.core.hoststream import HostStreamExecutor, StreamStats
from repro.core.refspec import AUTO, PrefetchSpec
from repro.core.spillstore import SpillStore
from repro.jaxcompat import make_mesh
from repro.models import transformer
from repro.optim.adamw import AdamWConfig
from repro.parallel import sharding as sh
from repro.train import steps as st
import dataclasses

inp = pickle.load(open(sys.argv[1], "rb"))
spec = json.loads(sys.argv[3])
out = {"sweep": {}, "matrix": {}}
assert len(jax.devices()) == 2
mesh = make_mesh((1, 2), ("data", "model"))
S = {"SH": NamedSharding(mesh, P(None, "model")), "SH0": NamedSharding(mesh, P("model")),
     "REP": NamedSharding(mesh, P()), None: None}

def leaf(shape, dt, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    if dt == "bfloat16":
        return np.asarray(jnp.asarray(a, jnp.bfloat16))
    return (a * 100).astype(np.int32) if dt == "int32" else np.asarray(a).astype(dt)

for (name, leaves), coalesce in [(c, k) for c in spec["sweep"] for k in (True, False)]:
    group = {k: leaf(tuple(shape), dt, i) for i, (k, shape, dt, _) in enumerate(leaves)}
    shs = {k: S[s] for k, _, _, s in leaves}
    eng = TransferEngine(EngineConfig(coalesce=coalesce))
    fut = eng.submit_group(0, group, device_shardings=shs)
    fut.wait()
    fut.group()
    eng.close()
    out["sweep"][f"{name}/{coalesce}"] = {"requests": fut.n_requests, "bytes": fut.nbytes,
                                          "devices": fut.n_devices}

shardings = {"w": S["SH"], "b": S["REP"]}
host = [{"w": g["w"], "b": np.asarray(jnp.asarray(g["b"], jnp.bfloat16))} for g in inp["groups"]]

@jax.jit
def apply_ro(carry, g):
    return carry + jnp.sum(g["w"]) * 2.0 + jnp.sum(g["b"].astype(jnp.float32))

@jax.jit
def apply_rw(carry, g):
    return carry + jnp.sum(g["w"]), {"w": g["w"] * 2.0 + 1.0, "b": g["b"]}

kinds = {"device": mk.DEVICE, "pinned_host": mk.PINNED_HOST,
         "unpinned_host": mk.UNPINNED_HOST, "disk_host": mk.DISK_HOST}
for kname, access, dist in spec["cells"]:
    kind = kinds[kname]
    wb = access == "rw"
    if kind.jax_kind == "device":
        groups = [jax.device_put(g, shardings) for g in host]
    elif not kind.jax_addressable:
        store = SpillStore(tempfile.mkdtemp(prefix="jax-conf-"))
        groups = []
        for i, g in enumerate(host):
            store.put(f"g{i}", g)
            groups.append(store.get(f"g{i}"))
    else:
        groups = host
    d = AUTO if dist == "auto" else dist
    mode = "on_demand" if d == 0 else "prefetch"
    pf = None if d == 0 else PrefetchSpec(buffer_size=len(groups) + 2, distance=d)
    stats = StreamStats()
    with HostStreamExecutor(apply_rw if wb else apply_ro, writeback=wb,
                            device_shardings=shardings) as ex:
        res, outs = ex.run(jnp.zeros(()), groups, mode=mode, prefetch=pf, stats=stats)
    out["matrix"][f"{kname}-{access}-{dist}"] = {
        "out": float(res), "outs": [np.asarray(o["w"]).tolist() for o in outs] if wb else None,
        "n_groups": stats.n_groups, "h2d": stats.h2d_requests, "bytes": stats.bytes_h2d,
        "devices": stats.n_devices, "disk": stats.disk_requests, "disk_bytes": stats.bytes_disk,
        "rpdg": stats.per_tier()["h2d"]["requests_per_device_group"]}

# the serve plan's cache specs survive a round trip through the host kind
cfg = get_smoke_config("smollm-360m")
splan = sh.make_plan(mesh, mode="serve")
caches = jax.jit(lambda: transformer.init_caches(cfg, 2, 16))()
specs = sh.cache_specs_tree(splan, caches, 2)
back = mk.place(mk.place(caches, mesh, specs, mk.PINNED_HOST), mesh, specs, mk.DEVICE)
flat_s = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
out["cache_specs"] = [[a if a is None or isinstance(a, str) else list(a) for a in s]
                      for s in flat_s]
out["cache_kept"] = all(l.sharding.spec == s for l, s in zip(jax.tree.leaves(back), flat_s))

# one train step, one prefill and one decode step at (1, 2) and (2, 1)
jc = dataclasses.replace(cfg, dtype="float32")
params = jax.tree.map(jnp.asarray, inp["params"])
opt = jax.tree.map(jnp.asarray, inp["opt"])
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
b, s = batch["tokens"].shape
for name, model in spec["meshes"].items():
    m = make_mesh((2 // model, model), ("data", "model"))
    plan = sh.make_plan(m, mode="train")
    p_specs = sh.param_specs(plan, params)
    p_sh = sh.named_shardings(m, p_specs)
    o_sh = sh.named_shardings(m, sh.opt_state_specs(plan, p_specs, params))
    sharder = sh.make_sharder(plan, params, b, seq_len=s, seq_shard=True)
    step = jax.jit(st.make_train_step(jc, AdamWConfig(**spec["opt"]), m, sharder),
                   in_shardings=(p_sh, o_sh, None), out_shardings=(p_sh, o_sh, None))
    with m:
        new_p, _, met = step(jax.device_put(params, p_sh), jax.device_put(opt, o_sh), batch)
    r = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
         "params": [np.asarray(x).tolist() for x in jax.tree.leaves(new_p)]}
    splan = sh.make_plan(m, mode="serve")
    ssharder = sh.make_sharder(splan, params, inp["prompts"].shape[0])
    sp = jax.device_put(params, sh.named_shardings(m, sh.param_specs(splan, params)))
    prompts = jnp.asarray(inp["prompts"])
    pb, ps = prompts.shape
    prefill = jax.jit(st.make_prefill_step(jc, pb, ps + 4, m, ssharder))
    decode = jax.jit(st.make_decode_step(jc, m, ssharder))
    with m:
        logits, caches = prefill(sp, {"tokens": prompts})
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        logits2, _ = decode(sp, caches, {"tokens": tok[:, None]}, jnp.asarray(ps, jnp.int32))
    r.update(prefill=np.asarray(logits).tolist(), decode=np.asarray(logits2).tolist())
    out[name] = r
json.dump(out, open(sys.argv[2], "w"))
"""


# ---------------------------------------------------------------------------
# the port on two gloo ranks
# ---------------------------------------------------------------------------

_PORT_CODE = r"""
import datetime, json, os, pickle, socket, sys, tempfile, traceback
import dataclasses
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp


def worker(rank, port, args, q):
    try:
        q.put(run(rank, port, *args))
    except BaseException:
        q.put(dict(rank=rank, error=traceback.format_exc()))
        raise


def run(rank, port, inp_path, spec):
    torch.set_num_threads(1)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import opt_state_from_numpy, tensor_from_numpy
    from repro_torch.core import memkind as mk
    from repro_torch.core import tree as tr
    from repro_torch.core.arrays import host_array, host_tensor
    from repro_torch.core.engine import EngineConfig, TransferEngine
    from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
    from repro_torch.core.refspec import AUTO, PrefetchSpec
    from repro_torch.core.spillstore import SpillStore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.local import full_local
    from repro_torch.train import steps as st

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    inp = pickle.load(open(inp_path, "rb"))
    out = {"rank": rank, "sweep": {}, "matrix": {}}
    mesh = make_local_mesh(model=2, device="cpu")
    S = {"SH": mk.sharding_for(mesh, sh.P(None, "model")), "SH0": mk.sharding_for(mesh, sh.P("model")),
         "REP": mk.sharding_for(mesh, sh.P()), None: None}

    def leaf(shape, dt, seed):  # a host leaf: numpy (bf16 as BF16HostArray)
        a = torch.from_numpy(np.asarray(np.random.default_rng(seed).standard_normal(shape)))
        if dt == "int32":
            return host_array((a * 100).to(torch.int32))
        return host_array(a.to({"bfloat16": torch.bfloat16, "float32": torch.float32,
                                "float64": torch.float64}[dt]))

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and (a.numel() == 0 or torch.equal(
            a.contiguous().reshape(-1).view(torch.uint8),
            b.contiguous().reshape(-1).view(torch.uint8)))

    def eager(x, s):  # distribute_tensor of the leaf, at the engine's dtype
        t = host_tensor(x)
        t = t.to(torch.float32) if t.dtype == torch.float64 else t
        if s is None:
            return t
        return distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    for (name, leaves), coalesce in [(c, k) for c in spec["sweep"] for k in (True, False)]:
        group = {k: leaf(tuple(shape), dt, i) for i, (k, shape, dt, _) in enumerate(leaves)}
        shs = {k: S[s] for k, _, _, s in leaves}
        eng = TransferEngine(EngineConfig(coalesce=coalesce), device="cpu")
        fut = eng.submit_group(0, group, device_shardings=shs)
        fut.wait()
        staged = fut.group()
        eng.close()
        ok = all(same(local(staged[k]), local(eager(group[k], shs[k])))
                 and (shs[k] is None or tuple(staged[k].placements) == tuple(shs[k].placements))
                 for k in group)
        out["sweep"][f"{name}/{coalesce}"] = {"requests": fut.n_requests, "bytes": fut.nbytes,
                                              "devices": fut.n_devices, "bitwise": bool(ok)}

    shardings = {"w": S["SH"], "b": S["REP"]}
    host = [{"w": g["w"], "b": host_array(torch.from_numpy(g["b"]).to(torch.bfloat16))}
            for g in inp["groups"]]

    def apply_ro(carry, g):
        return (carry + full_local(g["w"]).sum() * 2.0
                + full_local(g["b"]).to(torch.float32).sum())

    def apply_rw(carry, g):
        return carry + full_local(g["w"]).sum(), {"w": g["w"] * 2.0 + 1.0, "b": g["b"]}

    kinds = {"device": mk.DEVICE, "pinned_host": mk.PINNED_HOST,
             "unpinned_host": mk.UNPINNED_HOST, "disk_host": mk.DISK_HOST}
    eager_groups = [{k: shardings[k].put(v) for k, v in g.items()} for g in host]
    refs = {}
    for access in ("ro", "rw"):
        with HostStreamExecutor(apply_rw if access == "rw" else apply_ro, writeback=access == "rw",
                                device_shardings=shardings, device="cpu") as ex:
            refs[access] = ex.run(torch.zeros(()), eager_groups, mode="eager")
    for kname, access, d in spec["cells"]:
        kind = kinds[kname]
        wb = access == "rw"
        if kind.jax_kind == "device":
            groups = eager_groups
        elif not kind.jax_addressable:
            store = SpillStore(tempfile.mkdtemp(prefix=f"port-conf-{rank}-"))
            groups = []
            for i, g in enumerate(host):
                store.put(f"g{i}", g)
                groups.append(store.get(f"g{i}"))
        else:
            groups = host
        dd = AUTO if d == "auto" else d
        mode = "on_demand" if dd == 0 else "prefetch"
        pf = None if dd == 0 else PrefetchSpec(buffer_size=len(groups) + 2, distance=dd)
        stats = StreamStats()
        with HostStreamExecutor(apply_rw if wb else apply_ro, writeback=wb,
                                device_shardings=shardings, device="cpu") as ex:
            res, outs = ex.run(torch.zeros(()), groups, mode=mode, prefetch=pf, stats=stats)
        ref, ref_outs = refs[access]
        bitwise = same(res, ref) and (not wb or all(
            same(host_tensor(a), host_tensor(b_))
            for o, ro in zip(outs, ref_outs) for a, b_ in zip(tr.leaves(o), tr.leaves(ro))))
        out["matrix"][f"{kname}-{access}-{d}"] = {
            "out": float(res), "bitwise": bool(bitwise),
            "outs": [host_tensor(o["w"]).tolist() for o in outs] if wb else None,
            "n_groups": stats.n_groups, "h2d": stats.h2d_requests, "bytes": stats.bytes_h2d,
            "devices": stats.n_devices, "disk": stats.disk_requests,
            "disk_bytes": stats.bytes_disk,
            "rpdg": stats.per_tier()["h2d"]["requests_per_device_group"]}

    # the serve plan's cache specs survive a round trip through the host kind
    cfg = get_smoke_config("smollm-360m")
    splan = sh.make_plan(mesh, mode="serve")
    caches = transformer.init_caches(cfg, 2, 16, device="cpu")
    caches = tr.tree_map(lambda x: x + torch.arange(x.numel()).reshape(x.shape).to(x.dtype), caches)
    specs = sh.cache_specs_tree(splan, caches, 2)
    flat_s = tr.flatten(specs, is_leaf=lambda s: isinstance(s, sh.P))[0]
    placed = mk.place(caches, mesh, specs, mk.PINNED_HOST)
    back = mk.place(placed, mesh, specs, mk.DEVICE)
    out["cache_specs"] = [[a if a is None or isinstance(a, str) else list(a) for a in s]
                          for s in flat_s]
    out["cache_kept"] = all(
        isinstance(h, mk.HostShard) and tuple(h.sharding.placements) == sh.placements(mesh, s)
        and tuple(x.placements) == sh.placements(mesh, s) and same(x.full_tensor(), c)
        for h, x, s, c in zip(tr.leaves(placed), tr.leaves(back), flat_s, tr.leaves(caches)))

    # one train step, one prefill and one decode step at (1, 2) and (2, 1)
    pc = dataclasses.replace(cfg, dtype="float32")
    params = tr.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), inp["params"])
    opt = opt_state_from_numpy(inp["opt"], "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["batch"].items()}
    b, s = batch["tokens"].shape
    for name, model in spec["meshes"].items():
        m = make_local_mesh(model=model, device="cpu")
        plan = sh.make_plan(m, mode="train")
        p_specs = sh.param_specs(plan, params)
        o_specs = sh.opt_state_specs(plan, p_specs, params)
        sharder = sh.make_sharder(plan, params, b, seq_len=s, seq_shard=True)
        step = st.make_train_step(pc, AdamWConfig(**spec["opt"]), m, sharder)
        new_p, _, met = step(sh.distribute_tree(params, m, p_specs, src_data_rank=None),
                             sh.distribute_tree(opt, m, o_specs, src_data_rank=None), batch)
        placed_ok = all(tuple(x.placements) == sh.placements(m, q) for x, q in zip(
            tr.leaves(new_p), tr.flatten(p_specs, is_leaf=lambda q: isinstance(q, sh.P))[0]))
        r = {"loss": float(full_local(met["loss"])), "grad_norm": float(full_local(met["grad_norm"])),
             "params": [x.full_tensor().tolist() for x in tr.leaves(new_p)],
             "placed": bool(placed_ok)}
        splan = sh.make_plan(m, mode="serve")
        prompts = torch.from_numpy(inp["prompts"]).to(torch.long)
        pb, ps = prompts.shape
        ssharder = sh.make_sharder(splan, params, pb)
        sp = sh.distribute_tree(params, m, sh.param_specs(splan, params), src_data_rank=None)
        logits, caches = st.make_prefill_step(pc, pb, ps + 4, m, ssharder)(sp, {"tokens": prompts})
        logits = full_local(logits)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        logits2, _ = st.make_decode_step(pc, m, ssharder)(
            sp, caches, {"tokens": tok[:, None].to(torch.long)}, torch.tensor(ps, dtype=torch.int32))
        r.update(prefill=logits.tolist(), decode=full_local(logits2).tolist())
        out[name] = r
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    args = (sys.argv[1], json.loads(sys.argv[3]))
    procs = [ctx.Process(target=worker, args=(r, port, args, q)) for r in range(2)]
    for p in procs:
        p.start()
    res = [q.get(timeout=280) for _ in procs]
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
    errors = [r["error"] for r in res if "error" in r]
    assert not errors, "\n".join(errors)
    json.dump(sorted(res, key=lambda r: r["rank"]), open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax result, [rank 0's, rank 1's])``: both subprocesses run at once."""
    d = tmp_path_factory.mktemp("sharded_stream")
    inp = d / "inputs.pkl"
    inp.write_bytes(pickle.dumps(_inputs()))
    spec = json.dumps({"sweep": SWEEP, "cells": CELLS, "meshes": MESHES, "opt": PARITY_OPT})
    # one thread a process: the subprocesses share the machine with the
    # other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    (d / "port.py").write_text(_PORT_CODE)
    procs = {
        "jax": subprocess.Popen([sys.executable, "-c", _JAX_CODE, str(inp), str(d / "jax.json"),
                                 spec], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, str(d / "port.py"), str(inp),
                                  str(d / "port.json"), spec], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name}: {err[-4000:]}"
    return json.loads((d / "jax.json").read_text()), json.loads((d / "port.json").read_text())


@pytest.mark.parametrize("case", [name for name, _ in SWEEP])
def test_sharded_group_layout_matches_jax(runs, case):
    """One coalesced request a (rank, group), summing to the JAX package's
    one a (device, group); the payload bytes sum to its; every staged leaf
    bitwise ``distribute_tensor`` of its host leaf, at its placements."""
    ref, ranks = runs
    want = ref["sweep"][f"{case}/True"]
    got = [r["sweep"][f"{case}/True"] for r in ranks]
    assert all(g["bitwise"] for g in got), got
    assert sum(g["requests"] for g in got) == want["requests"] == 2
    _bytes_and_devices_match(case, want, got)


@pytest.mark.parametrize("case", [name for name, _ in SWEEP])
def test_per_leaf_sharded_route_matches_jax(runs, case):
    """The per-leaf route (``EngineConfig(coalesce=False)``) under the same
    shardings: one request a (leaf, local shard), summing over the ranks to
    the JAX package's per-leaf count (a leaf without a sharding costs each
    rank its request, as it costs each its bytes); the host leaves' bytes,
    devices and every staged leaf as on the coalesced route."""
    ref, ranks = runs
    want = ref["sweep"][f"{case}/False"]
    got = [r["sweep"][f"{case}/False"] for r in ranks]
    assert all(g["bitwise"] for g in got), got
    unplaced = sum(1 for _, _, _, s in dict(SWEEP)[case] if s is None)
    assert sum(g["requests"] for g in got) == want["requests"] + (len(got) - 1) * unplaced
    assert want["requests"] > 2
    _bytes_and_devices_match(case, want, got)


def _bytes_and_devices_match(case, want, got) -> None:
    unplaced = sum(4 * int(np.prod(shape)) for _, shape, _, s in dict(SWEEP)[case] if s is None)
    assert sum(g["bytes"] for g in got) == want["bytes"] + (len(got) - 1) * unplaced
    assert sum(g["devices"] for g in got) == want["devices"] == 2


@pytest.mark.parametrize("kind, access, dist", CELLS,
                         ids=[f"{k}-{a}-d{d}" for k, a, d in CELLS])
def test_kind_access_distance_matrix_matches_jax(runs, kind, access, dist):
    """Every kind x ro/rw x distance 0/1/auto: bitwise the eager sharded run
    on each rank, its result within f32 tolerance of the JAX package's, and
    the counts by the counting rule."""
    ref, ranks = runs
    key = f"{kind}-{access}-{dist}"
    want = ref["matrix"][key]
    got = [r["matrix"][key] for r in ranks]
    assert all(g["bitwise"] for g in got), got
    assert got[0]["out"] == got[1]["out"]
    np.testing.assert_allclose(got[0]["out"], want["out"], **F32_TOL)
    if access == "rw":
        for a, b in zip(got[0]["outs"], want["outs"]):
            np.testing.assert_allclose(a, b, **F32_TOL)
    assert all(g["n_groups"] == want["n_groups"] == N_GROUPS for g in got)
    assert sum(g["h2d"] for g in got) == want["h2d"]
    assert sum(g["bytes"] for g in got) == want["bytes"]
    assert all(g["rpdg"] == want["rpdg"] for g in got)
    # each rank reads its own home: its disk requests and bytes are the JAX package's
    assert all(g["disk"] == want["disk"] and g["disk_bytes"] == want["disk_bytes"] for g in got)
    if kind == "device":  # nothing staged: no rank, and no device, took a request
        assert want["h2d"] == 0 and all(g["devices"] == want["devices"] == 1 for g in got)
    else:
        assert want["h2d"] == 2 * N_GROUPS and want["devices"] == 2
        assert all(g["h2d"] == N_GROUPS and g["devices"] == 1 for g in got)


def test_place_keeps_the_serve_plans_cache_specs(runs):
    """``memkind.place(caches, mesh, specs, kind)`` keeps the plan's specs
    through a host round trip (the JAX package's tests/test_serve.py
    regression): the host shards carry them, the device leaves come back
    at them, the values bitwise."""
    ref, ranks = runs
    assert ref["cache_kept"] and all(r["cache_kept"] for r in ranks)
    assert all(r["cache_specs"] == ref["cache_specs"] for r in ranks)
    assert any(any(a is not None for a in s) for s in ref["cache_specs"])


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_jax_2way(runs, mesh):
    """One train step with params and AdamW state as DTensors by the train
    plan and the Sharder in the layer body: loss, gradient norm and updated
    parameters within f32 tolerance of the JAX package's 2-device step; the
    ranks agree bitwise, and the state keeps its layouts."""
    ref, ranks = runs
    want, got = ref[mesh], [r[mesh] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"] and got[0]["params"] == got[1]["params"]
    assert all(g["placed"] for g in got)
    np.testing.assert_allclose(got[0]["loss"], want["loss"], **F32_TOL)
    np.testing.assert_allclose(got[0]["grad_norm"], want["grad_norm"], **F32_TOL)
    assert len(got[0]["params"]) == len(want["params"])
    for a, b in zip(got[0]["params"], want["params"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_and_decode_match_jax_2way(runs, mesh):
    """The serve plan's prefill and one decode step (caches DTensors at its
    cache specs): logits within f32 tolerance of the JAX package's 2-device
    steps, the ranks bitwise equal."""
    ref, ranks = runs
    want, got = ref[mesh], [r[mesh] for r in ranks]
    for k in ("prefill", "decode"):
        assert got[0][k] == got[1][k]
        np.testing.assert_allclose(np.asarray(got[0][k]), np.asarray(want[k]), **F32_TOL)


# ---------------------------------------------------------------------------
# group shardings on the shape-only mesh, every config
# ---------------------------------------------------------------------------

class _FakeMesh:
    """Shape-only mesh stand-in (the JAX package's tests/test_sharding.py)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.mesh_dim_names = tuple(shape)


class _FakeNamed:
    """A ``NamedSharding`` of the shape-only mesh (its mesh and spec)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _plans(arch):
    cfg, jc = get_config(arch), jax_get_config(arch)
    expert = bool(cfg.n_experts)
    port = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=1,
                            expert_stream=expert)
    ref = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1, expert_stream=expert)
    return cfg, port, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_group_shardings_equal_the_jax_packages(arch, monkeypatch):
    """``group_shardings`` and ``home_group_shardings`` of the train plan's
    param shardings on the 16 x 16 mesh, group by group, against the JAX
    package's (expert groups drop the expert axis; a tied head's fetch
    group borrows embed's)."""
    monkeypatch.setattr(jax.sharding, "NamedSharding", _FakeNamed)
    mesh = _FakeMesh({"data": 16, "model": 16})
    cfg, port, ref = _plans(arch)
    p_abs = st.abstract_params(cfg)
    specs = sh.param_specs(sh.ShardingPlan(mesh=mesh, mode="train"), p_abs)
    ours = sh.named_shardings(mesh, specs)
    jspecs = jax_sh.param_specs(jax_sh.ShardingPlan(mesh=mesh, mode="train"),
                                jax_steps.abstract_params(jax_get_config(arch)))
    theirs = jax.tree.map(lambda s: _FakeNamed(mesh, s), jspecs,
                          is_leaf=lambda s: isinstance(s, JP))
    for fn in ("group_shardings", "home_group_shardings"):
        got, want = getattr(port, fn)(ours), getattr(ref, fn)(theirs)
        assert len(got) == len(want) == port.n_groups
        for g, a, b in zip(port.groups, got, want):
            la = tr.flatten(a, is_leaf=lambda x: isinstance(x, mk.Sharding))[0]
            lb = jax.tree.leaves(b, is_leaf=lambda x: isinstance(x, _FakeNamed))
            assert len(la) == len(lb), (fn, g.key)
            for x, y in zip(la, lb):
                assert x.placements == sh.placements(mesh, sh.P(*y.spec)), (fn, g.key)
    if cfg.n_experts:
        assert any(g.kind == "expert" for g in port.groups)
