"""musicgen-medium and qwen2-vl-72b through the port's entry points, on the CPU.

Against the JAX package (its f32 weights converted, its batches as numpy):
one train step's loss and parameters within the f32 tolerance (rtol 2e-4 /
atol 2e-3); musicgen's greedy served tokens equal, unpaged and paged.
Inside the port: the streamed-weight train step gives the device route's
bits at every home for both configs, and one streamed step's update equals
the monolithic step's within the f32 tolerance, so the codebook heads'
gradient (the head path) reaches the embed group's update beside the
codebooks' (the gather path).  Serving an M-RoPE config is refused with a
named ``ValueError`` (the JAX package fails with ``KeyError``), and the
launchers run both families.
"""
import dataclasses
import functools
import json
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import SyntheticConfig as JaxSC
from repro.data.synthetic import synthetic_batch as jax_batch
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (opt_state_from_numpy, params_from_numpy, tensor_from_numpy,
                                 tree_to_numpy)
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.spillstore import SpillStore
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch
from repro_torch.launch import serve as sv
from repro_torch.launch import train as launch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as st

TOL = dict(rtol=2e-4, atol=2e-3)
FRONTENDS = ("musicgen-medium", "qwen2-vl-72b")
#: AdamW's first update of a leaf is lr * sign(g): a gradient within rounding
#: of zero may take either sign in two programs, so parameters are compared at
#: a learning rate whose step stays inside atol (as tests/test_torch_train.py)
PARITY_OPT = dict(peak_lr=2e-4, warmup_steps=1, total_steps=6)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=32)
SEED = 7


def _cfgs(arch, **kw):
    """(port config, JAX config): the smoke config in f32."""
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    _, jc = _cfgs(arch)
    p, o = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)


def _jax_batch(arch, step=0, seq=16, batch=2):
    _, jc = _cfgs(arch)
    return {k: np.asarray(v) for k, v in
            jax_batch(jc, JaxSC(jc.vocab_size, seq, batch, seed=1), step).items()}


def _t(tree):
    return tr.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


def _close(port, ref, tol=TOL):
    ours, theirs = tr.leaves(tree_to_numpy(port)), jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), **tol)


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_step_matches_jax(arch, chunk):
    """One AdamW step: the loss, the gradient norm, the updated parameters
    and moments (the codebooks and heads, the merger and the untied head
    among them)."""
    pc, jc = _cfgs(arch, loss_chunk=chunk)
    p, o = _jax_init(arch)
    b = _jax_batch(arch)
    jp, jo, jm = jax.jit(jax_steps.make_train_step(jc, JaxAdamW(**PARITY_OPT)))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, o), b)
    tp, to, tm = st.make_train_step(pc, AdamWConfig(**PARITY_OPT))(
        _t(p), opt_state_from_numpy(o, "cpu"), _t(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"]) == b["targets"].size
    _close(tp, jp)
    _close(to, jo)


# ---------------------------------------------------------------------------
# the streamed-weight train step
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    t = host_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).detach().cpu()
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _streamed(cfg, plan, kind, batches, state):
    """The streamed step at ``kind`` over ``batches`` from ``state``; returns
    (losses, state as bytes, param stats)."""
    with tempfile.TemporaryDirectory() as d:
        store = SpillStore(d, ephemeral=True) if kind == "disk_host" else None
        step = st.make_weight_streamed_train_step(cfg, AdamWConfig(**OPT), plan=plan,
                                                  param_kind=kind, spill_store=store,
                                                  device="cpu")
        s = state
        if kind == "device":
            s = st.device_weight_streamed_state(plan, s, "cpu")
        elif kind == "disk_host":
            s = st.spill_weight_streamed_state(plan, s, store)
        losses = []
        try:
            for b in batches:
                s, m = step(s, b)
                losses.append(float(m["loss"]))
            s = {part: {"groups": tr.tree_map(lambda x: _bits(x).copy(), s[part]["groups"])}
                 for part in ("params", "opt")}
        finally:
            step.close()
            if store is not None:
                store.close()
    return losses, s, step.param_stats


@pytest.mark.parametrize("arch", FRONTENDS)
def test_streamed_train_bitwise_vs_device_route(arch):
    """Two steps at the device home, pinned host and disk: the same losses,
    parameters and moments, bit for bit; one H2D request a fetched group.
    The codebook head's fetch group borrows the embed group's tree."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=3)
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=2)
    assert plan.head_reads_embed == bool(cfg.n_codebooks)
    assert plan.embed_keys == (("embed",) if cfg.n_codebooks else ("embed", "vision"))
    sc_ = SyntheticConfig(cfg.vocab_size, 16, 2, seed=0)
    batches = [synthetic_batch(cfg, sc_, k) for k in range(2)]
    state = st.init_weight_streamed_state(cfg, plan, 0, "cpu")
    ref_losses, ref_state, _ = _streamed(cfg, plan, "device", batches, state)
    assert all(np.isfinite(ref_losses))
    for kind in ("pinned_host", "disk_host"):
        losses, got, stats = _streamed(cfg, plan, kind, batches, state)
        assert losses == ref_losses, kind
        for part in ("params", "opt"):
            for key, tree in ref_state[part]["groups"].items():
                for x, y in zip(tr.leaves(got[part]["groups"][key]), tr.leaves(tree)):
                    assert np.array_equal(x, y), (kind, part, key)
        assert stats.per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0


@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_donated_state_gives_the_same_bits_and_is_let_go(kind):
    """``donate=True``: the step's values are the undonated step's, bit for
    bit, and the input state's groups are gone when it returns."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-vl-72b"), n_layers=2)
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=1)
    batch = synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 16, 2, seed=0), 0)
    out = {}
    for donate in (False, True):
        with tempfile.TemporaryDirectory() as d:
            store = SpillStore(d, ephemeral=True) if kind == "disk_host" else None
            state = st.init_weight_streamed_state(cfg, plan, 0, "cpu")
            if store is not None:
                state = st.spill_weight_streamed_state(plan, state, store)
            step = st.make_weight_streamed_train_step(cfg, AdamWConfig(**OPT), plan=plan,
                                                      param_kind=kind, spill_store=store,
                                                      donate=donate, device="cpu")
            try:
                new, m = step(state, batch)
                new, m2 = step(new, synthetic_batch(
                    cfg, SyntheticConfig(cfg.vocab_size, 16, 2, seed=0), 1))
                out[donate] = ([float(m["loss"]), float(m2["loss"])],
                               [_bits(x).copy() for x in tr.leaves(new)])
            finally:
                step.close()
                if store is not None:
                    store.close()
            left = sum(len(state[p]["groups"]) for p in ("params", "opt"))
            assert left == (0 if donate else 2 * plan.n_groups)
    assert out[True][0] == out[False][0]
    assert all(np.array_equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_state_spilled_as_drawn_is_the_spilled_state(tmp_path):
    """``init_weight_streamed_state(store=...)`` spills each group as it is
    drawn: the same chunks, bit for bit, as spilling the host state after."""
    cfg = dataclasses.replace(get_smoke_config("musicgen-medium"), n_layers=3)
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=2)
    with SpillStore(str(tmp_path / "a"), ephemeral=True) as a, \
            SpillStore(str(tmp_path / "b"), ephemeral=True) as b:
        drawn = st.init_weight_streamed_state(cfg, plan, 4, "cpu", store=a)
        after = st.spill_weight_streamed_state(
            plan, st.init_weight_streamed_state(cfg, plan, 4, "cpu"), b)
        for part in ("params", "opt"):
            assert drawn[part]["groups"].keys() == after[part]["groups"].keys()
            for key in after[part]["groups"]:
                x, y = drawn[part]["groups"][key], after[part]["groups"][key]
                assert all(np.array_equal(_bits(u), _bits(v))
                           for u, v in zip(tr.leaves(x), tr.leaves(y))), (part, key)
        assert plan.is_spilled(drawn["params"])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_streamed_step_update_equals_monolithic(arch):
    """In f32 one streamed step updates every leaf as the monolithic train
    step does: the embed group's update takes the summed gradient of the
    codebooks (gather path) and the codebook heads (head path), the vision
    merger's and the untied head's."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2, dtype="float32")
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=1)
    state = st.init_weight_streamed_state(cfg, plan, 3, "cpu")
    batch = synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 16, 2, seed=0), 0)
    step = st.make_weight_streamed_train_step(cfg, AdamWConfig(**PARITY_OPT), plan=plan,
                                              param_kind="pinned_host", device="cpu")
    try:
        new, m = step(state, batch)
    finally:
        step.close()
    params, opt = st.init_train_state(cfg, 3, "cpu")
    p2, _, m2 = st.make_train_step(cfg, AdamWConfig(**PARITY_OPT))(params, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m2["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m2["grad_norm"]), **TOL)
    whole = plan.init_home(p2)
    for key, tree in whole["groups"].items():
        for x, y in zip(tr.leaves(new["params"]["groups"][key]), tr.leaves(tree)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)
    if cfg.n_codebooks:
        moved = np.asarray(new["params"]["groups"]["g000_embed"]["embed"]["heads"])
        was = np.asarray(state["params"]["groups"]["g000_embed"]["embed"]["heads"])
        assert not np.array_equal(moved, was)  # the head path's gradient arrived


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


def _musicgen_params():
    pc, jc = _cfgs("musicgen-medium", attn_impl="pallas")
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    return params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")


def test_musicgen_serve_unpaged_equals_jax(mesh):
    """The JAX package's unpaged serve against the port's serve loop on the
    same weights and prompts: codebook 0's greedy stream, token for token."""
    pc, jc = _cfgs("musicgen-medium", attn_impl="pallas")
    ref = jax_serve.serve(jc, mesh, batch=2, prompt_len=9, gen=5, kv_kind="device",
                          kv_page_len=0, seed=SEED)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (2, 9), 1,
                                            jc.vocab_size), np.int32)
    res = sv.serve_loop(pc, _musicgen_params(), prompts, 5, device=torch.device("cpu"))
    assert res["generated"].shape == (2, 5) and res["generated"].dtype == np.int32
    np.testing.assert_array_equal(res["generated"], ref["generated"])


@pytest.mark.parametrize("kv_kind", ["device", "pinned_host", "disk_host"])
def test_musicgen_paged_session_equals_jax_and_unpaged(mesh, kv_kind):
    """The paged session (three requests through two slots) gives the JAX
    package's session's tokens and the port's unpaged tokens."""
    pc, jc = _cfgs("musicgen-medium", attn_impl="pallas")
    params = _musicgen_params()
    prompts = np.random.default_rng(0).integers(1, pc.vocab_size, (3, 13), dtype=np.int32)
    out = []
    for s in (sv.ServeSession(pc, slots=2, max_len=21, kv_kind=kv_kind, page_len=4,
                              params=params, device="cpu"),
              jax_serve.ServeSession(jc, mesh, slots=2, max_len=21, kv_kind=kv_kind, page_len=4,
                                     seed=SEED)):
        with s:
            rids = [s.submit(p, 6) for p in prompts]
            res = s.run()
            out.append([res[r] for r in rids])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    unpaged = sv.serve_loop(pc, params, prompts[:2], 6, device=torch.device("cpu"))
    np.testing.assert_array_equal(np.stack(out[0][:2]), unpaged["generated"])


def test_musicgen_serves_paged_and_unpaged_alike():
    """``serve`` with random weights: the paged and unpaged paths agree, and
    so does the streamed-weight path (tests/test_serve.py's codebook case)."""
    cfg = get_smoke_config("musicgen-medium")
    kw = dict(batch=2, prompt_len=9, gen=5, seed=0, device="cpu")
    u = sv.serve(cfg, kv_kind="device", kv_page_len=0, **kw)
    p = sv.serve(cfg, kv_kind="pinned_host", kv_page_len=4, **kw)
    w = sv.serve(cfg, kv_kind="device", kv_page_len=0, param_kind="disk_host",
                 device_budget_mb=0.2, **kw)
    assert u["generated"].shape == (2, 5)
    np.testing.assert_array_equal(u["generated"], p["generated"])
    np.testing.assert_array_equal(u["generated"], w["generated"])
    assert w["param_stats"].h2d_requests == w["param_stats"].unique_group_fetches > 0


def test_serving_refuses_mrope_with_its_reason(mesh):
    cfg = get_smoke_config("qwen2-vl-72b")
    prompts = np.ones((1, 4), np.int32)
    for call in (lambda: sv.serve(cfg, batch=1, prompt_len=4, gen=2, device="cpu"),
                 lambda: sv.serve(cfg, batch=1, prompt_len=4, gen=2, kv_page_len=0,
                                  device="cpu"),
                 lambda: sv.ServeSession(cfg, slots=1, max_len=8, device="cpu"),
                 lambda: sv.serve_loop(cfg, None, prompts, 2, device=torch.device("cpu"))):
        with pytest.raises(ValueError, match="builds no M-RoPE positions_3d"):
            call()
    # the JAX package has no such check: its prompt batch lacks the ids
    jc = jax_smoke("qwen2-vl-72b")
    with pytest.raises(KeyError, match="positions_3d"):
        jax_serve.serve(jc, mesh, batch=1, prompt_len=4, gen=2, kv_page_len=0, seed=0)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_cli_serves_musicgen_and_refuses_qwen2vl(monkeypatch, capsys):
    base = ["serve", "--smoke", "--device", "cpu", "--prompt-len", "12", "--gen", "4"]
    monkeypatch.setattr(sys, "argv", base + ["--arch", "musicgen-medium"])
    assert sv.main() == 0
    assert "served musicgen-medium" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", base + ["--arch", "qwen2-vl-72b"])
    with pytest.raises(SystemExit) as e:
        sv.main()
    assert e.value.code == 2 and "positions_3d" in capsys.readouterr().err


ROUTES = {"stream-opt": ["--policy", "host_opt", "--stream-opt"],
          "pinned_host": ["--param-kind", "pinned_host", "--verify-schedule"],
          "disk_host": ["--param-kind", "disk_host", "--device-budget-mb", "0.3"]}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_cli_routes_give_the_device_losses(monkeypatch, capsys, tmp_path, arch, route):
    """``launch.train --arch`` for both families: the streamed optimizer's
    and the streamed weights' losses are the device route's bits."""
    base = ["train", "--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch",
            "2", "--seq", "16", "--checkpoint-every", "2"]
    hist = {}
    for run, extra in (("device", []), (route, ROUTES[route])):
        hist[run] = tmp_path / f"{run}.json"
        monkeypatch.setattr(sys, "argv", base + ["--checkpoint-dir", str(tmp_path / run),
                                                 "--history-out", str(hist[run]), *extra])
        assert launch.main() == 0
    out = capsys.readouterr().out
    losses = {run: [h["loss"] for h in json.loads(p.read_text())] for run, p in hist.items()}
    assert losses[route] == losses["device"] and len(losses["device"]) == 3
    assert f"trained {arch} (smoke)" in out
