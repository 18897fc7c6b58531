"""The Sharder in every layer body and the serve paths under a mesh, held
against the JAX package's forced 2-device run on the same numpy inputs.

Two gloo ranks run the port in one subprocess (``torch.multiprocessing``
spawn, ``tcp://127.0.0.1:<free port>``); the JAX package runs in another
on a forced 2-device host mesh.  The cases, each at meshes ``(1, 2)`` and
``(2, 1)``:

* one train step and one prefill + decode step of the smoke configs whose
  layer bodies the Sharder reaches by another route than smollm-360m's:
  olmo-1b (4 query and 4 KV heads: attention sharded over heads on
  ``model``), mixtral-8x7b (the MoE block and its ring cache),
  recurrentgemma-2b (the hetero layout, RG-LRU) and xlstm-1.3b (the period
  layout, mLSTM and sLSTM): loss, gradient norm, updated parameters and
  logits within ``tests/test_kernels.py::_tol`` (f32);
* the paged ``ServeSession`` at pinned-host pages under the serve plan
  (page shardings, cold pages fetched at the cache specs): the tokens the
  JAX package's, page requests and bytes summed over the ranks its count;
* the unpaged ``serve_loop`` with the weights streamed from pinned host at
  the serve plan's ``param_shardings`` (the streamed prefill and decode
  steps): the tokens the JAX package's, weight requests and bytes summed
  over the ranks its count;
* two streamed-weight train steps from pinned host at the train plan's
  ``param_shardings``: the losses within f32 tolerance, the weight and
  optimizer passes' requests and bytes summed over the ranks its count.

A JAX process addresses both devices; a port rank addresses its own (the
counting rule of ``parallel/__init__.py``).  Each subprocess has its own
timeout, and every process group its 60 s one.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.train import steps as jax_steps

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 300
F32_TOL = dict(rtol=2e-4, atol=2e-3)  # tests/test_kernels.py::_tol (f32)
#: AdamW's first update is lr * sign(g): a small rate keeps a sign flip of a
#: gradient within rounding of zero inside the tolerance (test_torch_train)
PARITY_OPT = dict(peak_lr=2e-4, warmup_steps=1, total_steps=6)
MESHES = {"mesh_1x2": 2, "mesh_2x1": 1}  # name -> model axis (of 2 ranks)
ARCHS = ("olmo-1b", "mixtral-8x7b", "recurrentgemma-2b", "xlstm-1.3b")
SEQ, BATCH, PROMPT = 16, 2, 12
#: the serve cases: smollm-360m at f32 (its serve plan shards the caches'
#: head_dim: one KV head), seed, prompts and generated tokens
SERVE_ARCH, SERVE_SEED, SERVE_GEN = "smollm-360m", 7, 6
PAGE_LEN, MAX_LEN = 8, 24
N_REQUESTS, SLOTS = 3, 2
#: the streamed train case: two steps of smollm-360m at f32, one layer a group
STREAMED_TRAIN_STEPS = 2
#: the counters compared (``parallel/__init__.py``): summed over the ranks
#: (what is staged onto the card), and each rank's own (the groups it steps
#: through, its home's disk reads, the full host values it drains)
SUMMED = ("h2d_requests", "bytes_h2d")
PER_RANK = ("n_groups", "d2h_requests", "bytes_d2h", "disk_requests", "bytes_disk",
            "unique_group_fetches")


def _f32(arch):
    return dataclasses.replace(jax_smoke(arch), dtype="float32")


def _inputs() -> dict:
    from repro.data.synthetic import SyntheticConfig, synthetic_batch

    models = {}
    for i, arch in enumerate(ARCHS):
        jc = _f32(arch)
        p, o = jax_steps.init_train_state(jax.random.PRNGKey(i), jc)
        batch = synthetic_batch(jc, SyntheticConfig(jc.vocab_size, SEQ, BATCH, seed=1), 0)
        rng = np.random.default_rng(3 + i)
        models[arch] = {
            "params": jax.tree.map(np.asarray, p), "opt": jax.tree.map(np.asarray, o),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "prompts": rng.integers(1, jc.vocab_size, (BATCH, PROMPT)).astype(np.int32)}
    # the serve cases: the JAX package's weights and prompts for its seed
    jc = _f32(SERVE_ARCH)
    params = jax_steps.init_train_state(jax.random.PRNGKey(SERVE_SEED), jc)[0]
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SERVE_SEED + 1),
                                            (BATCH, PROMPT), 1, jc.vocab_size), np.int32)
    paged = np.random.default_rng(5).integers(1, jc.vocab_size, (N_REQUESTS, PROMPT),
                                              dtype=np.int32)
    # the streamed train case: the JAX package's grouped state, one layer a group
    from repro.core.weightstream import WeightStreamPlan as JaxPlan

    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1)
    state = jax_steps.init_weight_streamed_state(jax.random.PRNGKey(0), jc, jplan)
    batch = synthetic_batch(jc, SyntheticConfig(jc.vocab_size, SEQ, BATCH, seed=2), 0)
    return {"models": models, "serve": {"params": jax.tree.map(np.asarray, params),
                                        "prompts": prompts, "paged": paged},
            "streamed_train": {"state": jax.tree.map(np.asarray, state),
                               "batch": {k: np.asarray(v) for k, v in batch.items()}}}


SPEC = {"archs": ARCHS, "meshes": MESHES, "opt": PARITY_OPT, "seed": SERVE_SEED,
        "gen": SERVE_GEN, "page_len": PAGE_LEN, "max_len": MAX_LEN, "slots": SLOTS,
        "serve_arch": SERVE_ARCH, "counters": SUMMED + PER_RANK,
        "train_steps": STREAMED_TRAIN_STEPS}


# ---------------------------------------------------------------------------
# the JAX package on a forced 2-device mesh
# ---------------------------------------------------------------------------

_JAX_CODE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.jaxcompat import make_mesh
from repro.launch import serve as sv
from repro.optim.adamw import AdamWConfig
from repro.parallel import sharding as sh
from repro.train import steps as st

inp = pickle.load(open(sys.argv[1], "rb"))
spec = json.loads(sys.argv[3])
out = {}
assert len(jax.devices()) == 2

for arch in spec["archs"]:
    jc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    a = inp["models"][arch]
    params = jax.tree.map(jnp.asarray, a["params"])
    opt = jax.tree.map(jnp.asarray, a["opt"])
    batch = {k: jnp.asarray(v) for k, v in a["batch"].items()}
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
        prompts = jnp.asarray(a["prompts"])
        pb, ps = prompts.shape
        ssharder = sh.make_sharder(splan, params, pb)
        sp = jax.device_put(params, sh.named_shardings(m, sh.param_specs(splan, params)))
        prefill = jax.jit(st.make_prefill_step(jc, pb, ps + 4, m, ssharder))
        decode = jax.jit(st.make_decode_step(jc, m, ssharder))
        with m:
            logits, caches = prefill(sp, {"tokens": prompts})
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            logits2, _ = decode(sp, caches, {"tokens": tok[:, None]}, jnp.asarray(ps, jnp.int32))
        r.update(prefill=np.asarray(logits).tolist(), decode=np.asarray(logits2).tolist())
        out[f"{arch}/{name}"] = r

# the serve paths under the serve plan
jc = dataclasses.replace(get_smoke_config(spec["serve_arch"]), dtype="float32")
sv_in = inp["serve"]
for name, model in spec["meshes"].items():
    m = make_mesh((2 // model, model), ("data", "model"))
    with sv.ServeSession(jc, m, seed=spec["seed"], slots=spec["slots"],
                         max_len=spec["max_len"], kv_kind="pinned_host",
                         page_len=spec["page_len"]) as s:
        rids = [s.submit(p, spec["gen"]) for p in sv_in["paged"]]
        res = s.run()
        out[f"paged/{name}"] = {
            "tokens": [np.asarray(res[r]).tolist() for r in rids],
            "stats": {c: getattr(s.stats, c) for c in spec["counters"]},
            "n_steps": s.n_steps}
    res = sv.serve(jc, m, batch=sv_in["prompts"].shape[0], prompt_len=sv_in["prompts"].shape[1],
                   gen=spec["gen"], kv_page_len=0, param_kind="pinned_host",
                   param_layers_per_group=1, seed=spec["seed"], warmup=False)
    out[f"streamed/{name}"] = {
        "tokens": np.asarray(res["generated"]).tolist(),
        "stats": {c: getattr(res["param_stats"], c) for c in spec["counters"]}}

# the streamed-weight train step at the train plan's param_shardings
from repro.core.refspec import PrefetchSpec
from repro.core.weightstream import WeightStreamPlan

wplan = WeightStreamPlan(jc, st.abstract_params(jc), layers_per_group=1)
tb = {k: jnp.asarray(v) for k, v in inp["streamed_train"]["batch"].items()}
for name, model in spec["meshes"].items():
    m = make_mesh((2 // model, model), ("data", "model"))
    plan = sh.make_plan(m, mode="train")
    p_abs = st.abstract_params(jc)
    p_sh = sh.named_shardings(m, sh.param_specs(plan, p_abs))
    sharder = sh.make_sharder(plan, p_abs, tb["tokens"].shape[0], seq_len=tb["tokens"].shape[1],
                              seq_shard=True)
    step = st.make_weight_streamed_train_step(
        jc, AdamWConfig(**spec["opt"]), m, sharder, plan=wplan, param_shardings=p_sh,
        param_kind="pinned_host",
        prefetch=PrefetchSpec(buffer_size=wplan.n_groups + 2, distance=1))
    state = jax.tree.map(lambda x: np.array(x), inp["streamed_train"]["state"])
    losses = []
    try:
        with m:
            for _ in range(spec["train_steps"]):
                state, met = step(state, tb)
                losses.append(float(met["loss"]))
    finally:
        step.close()
    out[f"streamed_train/{name}"] = {
        "losses": losses,
        "param": {c: getattr(step.param_stats, c) for c in spec["counters"]},
        "opt": {c: getattr(step.opt_stats, c) for c in spec["counters"]}}
json.dump(out, open(sys.argv[2], "w"))
"""


# ---------------------------------------------------------------------------
# the port on two gloo ranks
# ---------------------------------------------------------------------------

_PORT_CODE = r"""
import datetime, json, os, pickle, socket, sys, traceback
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
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy, tensor_from_numpy
    from repro_torch.core import tree as tr
    from repro_torch.launch import serve as sv
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.local import full_local
    from repro_torch.train import steps as st

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    inp = pickle.load(open(inp_path, "rb"))
    cpu = torch.device("cpu")
    out = {"rank": rank}
    for arch in spec["archs"]:
        pc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        a = inp["models"][arch]
        params = tr.tree_map(lambda x: tensor_from_numpy(np.asarray(x)), a["params"])
        opt = opt_state_from_numpy(a["opt"], "cpu")
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in a["batch"].items()}
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
            r = {"loss": float(full_local(met["loss"])),
                 "grad_norm": float(full_local(met["grad_norm"])),
                 "params": [x.full_tensor().tolist() for x in tr.leaves(new_p)],
                 "placed": bool(placed_ok)}
            splan = sh.make_plan(m, mode="serve")
            prompts = torch.from_numpy(a["prompts"]).to(torch.long)
            pb, ps = prompts.shape
            ssharder = sh.make_sharder(splan, params, pb)
            sp = sh.distribute_tree(params, m, sh.param_specs(splan, params), src_data_rank=None)
            logits, caches = st.make_prefill_step(pc, pb, ps + 4, m, ssharder)(
                sp, {"tokens": prompts})
            logits = full_local(logits)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            logits2, _ = st.make_decode_step(pc, m, ssharder)(
                sp, caches, {"tokens": tok[:, None].to(torch.long)},
                torch.tensor(ps, dtype=torch.int32))
            r.update(prefill=logits.tolist(), decode=full_local(logits2).tolist())
            out[f"{arch}/{name}"] = r

    # the serve paths under the serve plan
    pc = dataclasses.replace(get_smoke_config(spec["serve_arch"]), dtype="float32")
    sv_in = inp["serve"]
    params = params_from_numpy(sv_in["params"], pc, "cpu")
    for name, model in spec["meshes"].items():
        m = make_local_mesh(model=model, device="cpu")
        with sv.ServeSession(pc, params=params, device="cpu", mesh=m, seed=spec["seed"],
                             slots=spec["slots"], max_len=spec["max_len"],
                             kv_kind="pinned_host", page_len=spec["page_len"]) as s:
            rids = [s.submit(p, spec["gen"]) for p in sv_in["paged"]]
            res = s.run()
            out[f"paged/{name}"] = {
                "tokens": [np.asarray(res[r]).tolist() for r in rids],
                "stats": {c: getattr(s.stats, c) for c in spec["counters"]},
                "n_steps": s.n_steps}
        res = sv.serve_loop(pc, params, sv_in["prompts"], spec["gen"], device=cpu, mesh=m,
                            param_kind="pinned_host", param_layers_per_group=1,
                            seed=spec["seed"], warmup=False)
        out[f"streamed/{name}"] = {
            "tokens": np.asarray(res["generated"]).tolist(),
            "stats": {c: getattr(res["param_stats"], c) for c in spec["counters"]}}

    # the streamed-weight train step at the train plan's param_shardings
    from repro_torch.convert import weight_streamed_state_from_numpy
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.weightstream import WeightStreamPlan

    wplan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=1)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["streamed_train"]["batch"].items()}
    for name, model in spec["meshes"].items():
        m = make_local_mesh(model=model, device="cpu")
        plan = sh.make_plan(m, mode="train")
        p_abs = st.abstract_params(pc)
        p_sh = sh.named_shardings(m, sh.param_specs(plan, p_abs))
        sharder = sh.make_sharder(plan, p_abs, tb["tokens"].shape[0],
                                  seq_len=tb["tokens"].shape[1], seq_shard=True)
        step = st.make_weight_streamed_train_step(
            pc, AdamWConfig(**spec["opt"]), plan=wplan, param_kind="pinned_host",
            prefetch=PrefetchSpec(buffer_size=wplan.n_groups + 2, distance=1), device="cpu",
            mesh=m, sharder=sharder, param_shardings=p_sh)
        state = weight_streamed_state_from_numpy(inp["streamed_train"]["state"])
        losses = []
        try:
            for _ in range(spec["train_steps"]):
                state, met = step(state, tb)
                losses.append(float(full_local(met["loss"])))
        finally:
            step.close()
        out[f"streamed_train/{name}"] = {
            "losses": losses,
            "param": {c: getattr(step.param_stats, c) for c in spec["counters"]},
            "opt": {c: getattr(step.opt_stats, c) for c in spec["counters"]}}
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
    d = tmp_path_factory.mktemp("sharded_models")
    inp = d / "inputs.pkl"
    inp.write_bytes(pickle.dumps(_inputs()))
    spec = json.dumps(SPEC)
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


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch, mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_train_step_matches_jax_2way(runs, arch, mesh):
    """One train step with params and AdamW state as DTensors by the train
    plan and the Sharder in the layer body: loss, gradient norm and updated
    parameters within f32 tolerance of the JAX package's 2-device step; the
    ranks agree bitwise, and the state keeps its layouts."""
    ref, ranks = runs
    key = f"{arch}/{mesh}"
    want, got = ref[key], [r[key] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"] and got[0]["params"] == got[1]["params"]
    assert all(g["placed"] for g in got)
    np.testing.assert_allclose(got[0]["loss"], want["loss"], **F32_TOL)
    np.testing.assert_allclose(got[0]["grad_norm"], want["grad_norm"], **F32_TOL)
    assert len(got[0]["params"]) == len(want["params"])
    for a, b in zip(got[0]["params"], want["params"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32_TOL)


@pytest.mark.parametrize("arch, mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_prefill_and_decode_match_jax_2way(runs, arch, mesh):
    """The serve plan's prefill and one decode step (caches DTensors at its
    cache specs): logits within f32 tolerance of the JAX package's 2-device
    steps, the ranks bitwise equal."""
    ref, ranks = runs
    key = f"{arch}/{mesh}"
    want, got = ref[key], [r[key] for r in ranks]
    for k in ("prefill", "decode"):
        assert got[0][k] == got[1][k]
        np.testing.assert_allclose(np.asarray(got[0][k]), np.asarray(want[k]), **F32_TOL)


def _counts_match(want: dict, got: list) -> None:
    for c in SUMMED:
        assert sum(g[c] for g in got) == want[c], c
    for c in PER_RANK:
        assert all(g[c] == want[c] for g in got), c


@pytest.mark.parametrize("mesh", MESHES)
def test_paged_session_matches_jax_2way(runs, mesh):
    """The paged ``ServeSession`` at pinned-host pages under the serve plan
    (three requests through two slots, pages of 8): every rank emits the JAX
    package's tokens; page requests and bytes sum over the ranks to its
    count, and each rank steps through its groups and drains its demoted
    pages whole."""
    ref, ranks = runs
    key = f"paged/{mesh}"
    want, got = ref[key], [r[key] for r in ranks]
    assert all(g["tokens"] == want["tokens"] for g in got), (want["tokens"], got)
    assert all(g["n_steps"] == want["n_steps"] for g in got)
    _counts_match(want["stats"], [g["stats"] for g in got])
    assert want["stats"]["h2d_requests"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_streamed_serve_matches_jax_2way(runs, mesh):
    """The unpaged serve with the weights streamed from pinned host at the
    serve plan's ``param_shardings`` (the streamed prefill and decode
    steps, one layer a group): the JAX package's tokens on every rank, its
    weight requests and bytes summed over the ranks."""
    ref, ranks = runs
    key = f"streamed/{mesh}"
    want, got = ref[key], [r[key] for r in ranks]
    assert all(g["tokens"] == want["tokens"] for g in got), (want["tokens"], got)
    _counts_match(want["stats"], [g["stats"] for g in got])
    assert want["stats"]["h2d_requests"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_streamed_train_matches_jax_2way(runs, mesh):
    """Two streamed-weight train steps from pinned host with every group
    staged at the train plan's ``param_shardings`` (the forward, backward
    and home orders) and the Sharder in the group stages: the losses within
    f32 tolerance of the JAX package's 2-device steps, the ranks bitwise
    equal; the weight and optimizer passes' requests and bytes summed over
    the ranks its count."""
    ref, ranks = runs
    key = f"streamed_train/{mesh}"
    want, got = ref[key], [r[key] for r in ranks]
    assert got[0]["losses"] == got[1]["losses"]
    assert len(want["losses"]) == STREAMED_TRAIN_STEPS
    np.testing.assert_allclose(got[0]["losses"], want["losses"], **F32_TOL)
    for which in ("param", "opt"):
        _counts_match(want[which], [g[which] for g in got])
        assert want[which]["h2d_requests"] > 0
