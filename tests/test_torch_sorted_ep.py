"""Expert parallelism (``models/moe.py::moe_sorted_ep``) in the train path,
held against the JAX package's forced 2-device run on the same numpy inputs.

Two gloo ranks run the port in one subprocess (``torch.multiprocessing``
spawn, ``tcp://127.0.0.1:<free port>``); the JAX package runs in another on
a forced 2-device host mesh.  mixtral-8x7b's smoke config (4 experts,
top-2) at f32 with ``moe_impl="sorted_ep"``, the train plan's DTensors and
the Sharder in the layer body:

* one train step at meshes ``(1, 2)`` (two experts a rank) and ``(2, 1)``
  (the tokens split over ``data``) at the config's capacity factor, where
  tokens are dropped, and at ``(1, 2)`` with a capacity factor of
  ``n_experts / top_k``, where none can be: loss, aux loss, gradient norm
  and updated parameters within ``tests/test_kernels.py::_tol`` (f32);
* one streamed-weight train step from pinned host at ``(1, 2)`` with the
  train plan's ``param_shardings``: the loss within f32 tolerance, the
  weight and optimizer passes' H2D requests and bytes summed over the ranks
  the JAX package's count.

In-process: the local routine against the JAX package's ``_moe_sorted_local``,
and ``sorted_ep`` without a mesh, which is the dispatch bit for bit (the
JAX package's ``_block_train`` falls back the same way).  Each subprocess
has its own timeout, and every process group its 60 s one.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jax_moe
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import moe, transformer

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 240
F32_TOL = dict(rtol=2e-4, atol=2e-3)  # tests/test_kernels.py::_tol (f32)
#: AdamW's first update is lr * sign(g): a small rate keeps a sign flip of a
#: gradient within rounding of zero inside the tolerance (test_torch_train)
PARITY_OPT = dict(peak_lr=2e-4, warmup_steps=1, total_steps=6)
ARCH = "mixtral-8x7b"
SEQ, BATCH = 16, 2
#: name -> (model axis of the 2 ranks, capacity factor; None: the config's)
CASES = {"mesh_1x2": (2, None), "mesh_2x1": (1, None), "mesh_1x2-no_drops": (2, 2.0)}
STREAMED_MESH = 2
#: the streamed step's counters summed over the ranks (``parallel/__init__.py``)
SUMMED = ("h2d_requests", "bytes_h2d")


def _f32(cf=None):
    cfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32", moe_impl="sorted_ep")
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def _inputs() -> dict:
    from repro.core.weightstream import WeightStreamPlan as JaxPlan
    from repro.data.synthetic import SyntheticConfig, synthetic_batch

    jc = _f32()
    p, o = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)
    batch = synthetic_batch(jc, SyntheticConfig(jc.vocab_size, SEQ, BATCH, seed=1), 0)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1)
    state = jax_steps.init_weight_streamed_state(jax.random.PRNGKey(1), jc, jplan)
    return {"params": jax.tree.map(np.asarray, p), "opt": jax.tree.map(np.asarray, o),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "state": jax.tree.map(np.asarray, state)}


SPEC = {"arch": ARCH, "cases": CASES, "opt": PARITY_OPT, "streamed_mesh": STREAMED_MESH,
        "counters": SUMMED}

# ---------------------------------------------------------------------------
# the JAX package on a forced 2-device mesh
# ---------------------------------------------------------------------------

_JAX_CODE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.core.refspec import PrefetchSpec
from repro.core.weightstream import WeightStreamPlan
from repro.jaxcompat import make_mesh
from repro.optim.adamw import AdamWConfig
from repro.parallel import sharding as sh
from repro.train import steps as st

inp = pickle.load(open(sys.argv[1], "rb"))
spec = json.loads(sys.argv[3])
assert len(jax.devices()) == 2
out = {}
base = dataclasses.replace(get_smoke_config(spec["arch"]), dtype="float32", moe_impl="sorted_ep")
params = jax.tree.map(jnp.asarray, inp["params"])
opt = jax.tree.map(jnp.asarray, inp["opt"])
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
b, s = batch["tokens"].shape
for name, (model, cf) in spec["cases"].items():
    jc = base if cf is None else dataclasses.replace(base, capacity_factor=cf)
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
    out[name] = {"loss": float(met["loss"]), "aux": float(met["aux"]),
                 "grad_norm": float(met["grad_norm"]),
                 "params": [np.asarray(x).tolist() for x in jax.tree.leaves(new_p)]}

# one streamed-weight train step at the train plan's param_shardings
m = make_mesh((2 // spec["streamed_mesh"], spec["streamed_mesh"]), ("data", "model"))
wplan = WeightStreamPlan(base, st.abstract_params(base), layers_per_group=1)
plan = sh.make_plan(m, mode="train")
p_abs = st.abstract_params(base)
p_sh = sh.named_shardings(m, sh.param_specs(plan, p_abs))
sharder = sh.make_sharder(plan, p_abs, b, seq_len=s, seq_shard=True)
step = st.make_weight_streamed_train_step(
    base, AdamWConfig(**spec["opt"]), m, sharder, plan=wplan, param_shardings=p_sh,
    param_kind="pinned_host", prefetch=PrefetchSpec(buffer_size=wplan.n_groups + 2, distance=1))
state = jax.tree.map(lambda x: np.array(x), inp["state"])
try:
    with m:
        state, met = step(state, batch)
finally:
    step.close()
out["streamed"] = {"loss": float(met["loss"]), "n_groups": wplan.n_groups,
                   "param": {c: getattr(step.param_stats, c) for c in spec["counters"]},
                   "opt": {c: getattr(step.opt_stats, c) for c in spec["counters"]}}
json.dump(out, open(sys.argv[2], "w"))
"""

# ---------------------------------------------------------------------------
# the port on two gloo ranks
# ---------------------------------------------------------------------------

_PORT_CODE = r"""
import dataclasses, datetime, json, pickle, socket, sys, traceback
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
    from repro_torch.convert import opt_state_from_numpy, tensor_from_numpy
    from repro_torch.convert import weight_streamed_state_from_numpy
    from repro_torch.core import tree as tr
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.local import full_local
    from repro_torch.train import steps as st

    # count what each rank's capacity buffers drop, from the routing the
    # local routine is given
    drops = [0]
    local_routine = moe.moe_sorted_local

    def counting(cfg, p, x, e_local, e_offset):
        with torch.no_grad():
            top_i = moe._router(cfg, {"router": p["router"]}, x)[1].reshape(-1)
            n = torch.bincount(top_i, minlength=cfg.n_experts)[e_offset:e_offset + e_local]
            drops[0] += int(torch.clamp(n - moe._capacity(cfg, x.shape[0]), min=0).sum())
        return local_routine(cfg, p, x, e_local, e_offset)

    moe.moe_sorted_local = counting
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    inp = pickle.load(open(inp_path, "rb"))
    base = dataclasses.replace(get_smoke_config(spec["arch"]), dtype="float32",
                               moe_impl="sorted_ep")
    params = tr.tree_map(lambda x: tensor_from_numpy(np.asarray(x)), inp["params"])
    opt = opt_state_from_numpy(inp["opt"], "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["batch"].items()}
    b, s = batch["tokens"].shape
    out = {"rank": rank}
    for name, (model, cf) in spec["cases"].items():
        pc = base if cf is None else dataclasses.replace(base, capacity_factor=cf)
        m = make_local_mesh(model=model, device="cpu")
        plan = sh.make_plan(m, mode="train")
        p_specs = sh.param_specs(plan, params)
        o_specs = sh.opt_state_specs(plan, p_specs, params)
        sharder = sh.make_sharder(plan, params, b, seq_len=s, seq_shard=True)
        step = st.make_train_step(pc, AdamWConfig(**spec["opt"]), m, sharder)
        drops[0] = 0
        new_p, _, met = step(sh.distribute_tree(params, m, p_specs, src_data_rank=None),
                             sh.distribute_tree(opt, m, o_specs, src_data_rank=None), batch)
        out[name] = {"loss": float(full_local(met["loss"])), "aux": float(full_local(met["aux"])),
                     "grad_norm": float(full_local(met["grad_norm"])),
                     "params": [x.full_tensor().tolist() for x in tr.leaves(new_p)],
                     "drops": drops[0]}

    m = make_local_mesh(model=spec["streamed_mesh"], device="cpu")
    wplan = WeightStreamPlan(base, st.abstract_params(base), layers_per_group=1)
    plan = sh.make_plan(m, mode="train")
    p_abs = st.abstract_params(base)
    p_sh = sh.named_shardings(m, sh.param_specs(plan, p_abs))
    sharder = sh.make_sharder(plan, p_abs, b, seq_len=s, seq_shard=True)
    step = st.make_weight_streamed_train_step(
        base, AdamWConfig(**spec["opt"]), plan=wplan, param_kind="pinned_host",
        prefetch=PrefetchSpec(buffer_size=wplan.n_groups + 2, distance=1), device="cpu",
        mesh=m, sharder=sharder, param_shardings=p_sh)
    state = weight_streamed_state_from_numpy(inp["state"])
    try:
        _, met = step(state, batch)
    finally:
        step.close()
    out["streamed"] = {"loss": float(full_local(met["loss"])), "n_groups": wplan.n_groups,
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
    res = [q.get(timeout=220) for _ in procs]
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
    d = tmp_path_factory.mktemp("sorted_ep")
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


@pytest.mark.parametrize("case", CASES)
def test_sorted_ep_train_step_matches_jax_2way(runs, case):
    """One train step with the experts split over ``model`` and the tokens
    over ``data``, the partial outputs summed over ``model``: loss, aux
    loss, gradient norm and updated parameters within f32 tolerance of the
    JAX package's 2-device step; the ranks agree bitwise."""
    ref, ranks = runs
    want, got = ref[case], [r[case] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"] and got[0]["params"] == got[1]["params"]
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(got[0][k], want[k], **F32_TOL, err_msg=k)
    assert len(got[0]["params"]) == len(want["params"])
    for a, b in zip(got[0]["params"], want["params"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32_TOL)


def test_sorted_ep_drops_only_past_capacity(runs):
    """At the config's capacity factor the capacity buffers drop tokens
    (the matching cases above include drops); at ``n_experts / top_k`` no
    expert can overflow."""
    _, ranks = runs
    drops = {case: sum(r[case]["drops"] for r in ranks) for case in CASES}
    assert drops["mesh_1x2"] > 0 and drops["mesh_2x1"] > 0, drops
    assert drops["mesh_1x2-no_drops"] == 0, drops


def test_sorted_ep_streamed_train_step_matches_jax_2way(runs):
    """One streamed-weight train step from pinned host, every group staged
    at the train plan's ``param_shardings`` and its MoE layer under
    ``sorted_ep``: the loss within f32 tolerance of the JAX package's, the
    ranks bitwise equal; the weight and optimizer passes' H2D requests and
    bytes summed over the ranks its count."""
    ref, ranks = runs
    want, got = ref["streamed"], [r["streamed"] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"]
    assert all(g["n_groups"] == want["n_groups"] for g in got)
    np.testing.assert_allclose(got[0]["loss"], want["loss"], **F32_TOL)
    for which in ("param", "opt"):
        for c in SUMMED:
            assert sum(g[which][c] for g in got) == want[which][c], (which, c)
        assert want[which]["h2d_requests"] > 0


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------


def _moe_inputs(seed=0, t=48):
    cfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)).astype(np.float32) / np.sqrt(f)}
    return cfg, p, rng.standard_normal((t, d)).astype(np.float32)


@pytest.mark.parametrize("e_local, e_offset", [(4, 0), (2, 0), (2, 2), (1, 3)])
def test_moe_sorted_local_matches_jax(e_local, e_offset):
    """The rank-local routine over ``e_local`` experts from ``e_offset``
    (tokens past capacity dropped): the partial output and the aux loss
    within f32 tolerance of the JAX package's ``_moe_sorted_local``."""
    jc, p, x = _moe_inputs()
    pc = get_smoke_config(ARCH)
    sl = slice(e_offset, e_offset + e_local)
    jp = {k: jnp.asarray(v if k == "router" else v[sl]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v if k == "router" else v[sl].copy()) for k, v in p.items()}
    jy, jaux = jax_moe._moe_sorted_local(jc, jp, jnp.asarray(x), e_local, jnp.int32(e_offset))
    ty, taux = moe.moe_sorted_local(dataclasses.replace(pc, dtype="float32"), tp,
                                    torch.from_numpy(x), e_local, e_offset)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)


def test_sorted_ep_without_a_mesh_is_the_dispatch_bitwise():
    """``moe_impl="sorted_ep"`` without a mesh runs the dispatch: the
    training forward's hidden states and aux loss, and the loss, are the
    ``dispatch`` config's bits (prefill and decode never take a mesh)."""
    jc = _f32()
    params = params_from_numpy(jax.tree.map(np.asarray, jax_steps.init_train_state(
        jax.random.PRNGKey(2), jc)[0]), get_smoke_config(ARCH), "cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int64))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    out = {}
    for impl in ("dispatch", "sorted_ep"):
        pc = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", moe_impl=impl)
        x, aux = transformer.forward_hidden(pc, params, batch)
        loss, _ = transformer.lm_loss(pc, params, batch)
        out[impl] = (x, aux, loss)
    for a, b in zip(out["dispatch"], out["sorted_ep"]):
        assert torch.equal(a, b)


def test_sorted_ep_needs_experts_that_divide_the_model_axis():
    """As in the JAX package: the experts must split evenly over ``model``."""

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 3)
        ndim = 2

    pc = get_smoke_config(ARCH)
    with pytest.raises(AssertionError, match="must divide model axis 3"):
        moe.moe_sorted_ep(pc, {}, tensor_from_numpy(np.zeros((1, 2, pc.d_model), np.float32)),
                          Mesh())
