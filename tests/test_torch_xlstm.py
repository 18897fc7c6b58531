"""The port's xLSTM family held against the JAX package's, on the CPU.

Both sides get the same numpy inputs and, for the models, the same weights
(the JAX package's init, converted with ``params_from_numpy``), in f32, and
are compared at the JAX package's f32 model tolerance (rtol 2e-4, atol 2e-3,
``tests/test_kernels.py:_tol``): the mLSTM cell in its chunkwise, sequential
and step forms, the sLSTM cell, both blocks, the smoke model's logits,
caches and greedy tokens (the unrolled 3-layer smoke and a 6-layer period
stack, the layout of the full model), ``lm_loss`` and its gradients, the
JAX package's model properties, and lock-step serving.  The cells start from
a ``-inf`` stabilizer: their gradients must be finite.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jax_tf
from repro.models import xlstm as jx
from repro.train import steps as jax_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import home_from_numpy, params_from_numpy, tensor_from_numpy
from repro_torch.core import tree as tr
from repro_torch.core.weightstream import WeightStreamPlan, weight_stream_support
from repro_torch.launch import serve as sv
from repro_torch.launch import train as launch
from repro_torch.models import transformer
from repro_torch.models import xlstm as tx
from repro_torch.train import steps as st

F32_TOL = dict(rtol=2e-4, atol=2e-3)
ARCH = "xlstm-1.3b"
B, S, STEPS = 2, 32, 3


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **kw))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _close(ours, theirs, what, **tol):
    np.testing.assert_allclose(_np(ours), _np(theirs), err_msg=what, **(tol or F32_TOL))


def _trees_close(ours, theirs, what):
    lo, lt = tr.leaves(ours), jax.tree.leaves(theirs)
    assert len(lo) == len(lt), what
    for a, b in zip(lo, lt):
        assert tuple(a.shape) == b.shape, what
        _close(a, b, what)


def _cell_inputs(seed=0, b=B, s=S, h=2, dk=8, dv=16):
    rng = np.random.default_rng(seed)
    q, k = rng.standard_normal((2, b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = -np.log1p(np.exp(-rng.standard_normal((b, s, h)) - 3.0)).astype(np.float32)
    return q, k, v, li, lf


def _state(rng, b=B, h=2, dk=8, dv=16):
    return {"C": rng.standard_normal((b, h, dk, dv)).astype(np.float32),
            "n": rng.standard_normal((b, h, dk)).astype(np.float32),
            "m": rng.standard_normal((b, h)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_cells_match_jax(carried):
    """Chunkwise and sequential, each against the JAX package's and against
    each other, from a fresh (-inf) state and from a carried one."""
    xs = _cell_inputs()
    state = _state(np.random.default_rng(1)) if carried else None
    tstate = {k: _t(v) for k, v in state.items()} if carried else None
    jxs = [jnp.asarray(x) for x in xs]
    jc_h, jc_s = jx.mlstm_chunkwise(*jxs, state, chunk=8)
    js_h, js_s = jx.mlstm_sequential(*jxs, state)
    tc_h, tc_s = tx.mlstm_chunkwise(*map(_t, xs), tstate, chunk=8)
    ts_h, ts_s = tx.mlstm_sequential(*map(_t, xs), tstate)
    for (h, s_), (jh, js) in (((tc_h, tc_s), (jc_h, jc_s)), ((ts_h, ts_s), (js_h, js_s)),
                              ((tc_h, tc_s), (ts_h, ts_s))):
        _close(h, jh, "h")
        for k in ("C", "n", "m"):
            _close(s_[k], js[k], k)


def test_mlstm_gradients_finite_and_match_jax():
    """The -inf stabilizer and the -inf-masked chunk weights give finite
    gradients, the JAX package's."""
    xs = _cell_inputs(2)
    ins = [_t(x).requires_grad_(True) for x in xs]
    h, _ = tx.mlstm_chunkwise(*ins, chunk=8)
    grads = torch.autograd.grad((h * h).sum(), ins)
    want = jax.grad(lambda *a: jnp.sum(jx.mlstm_chunkwise(*a, chunk=8)[0] ** 2),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, xs))
    for name, g, w in zip(("q", "k", "v", "log_i", "log_f"), grads, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, name)
    # the sequential oracle's gradients are finite too
    ins = [_t(x).requires_grad_(True) for x in xs]
    h, _ = tx.mlstm_sequential(*ins)
    assert all(torch.isfinite(g).all() for g in torch.autograd.grad(h.sum(), ins))


def test_mlstm_step_chained_matches_chunkwise():
    q, k, v, li, lf = map(_t, _cell_inputs(3))
    h, state = tx.mlstm_chunkwise(q, k, v, li, lf, chunk=8)
    s_ = {"C": torch.zeros_like(state["C"]), "n": torch.zeros_like(state["n"]),
          "m": torch.full_like(state["m"], -torch.inf)}
    hs = []
    for t in range(S):
        ht, s_ = tx.mlstm_step(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], s_)
        hs.append(ht)
    _close(torch.stack(hs, 1), h, "h")
    for name in ("C", "n", "m"):
        _close(s_[name], state[name], name)


def test_chunkwise_refuses_a_ragged_sequence():
    xs = _cell_inputs(s=12)
    with pytest.raises(ValueError) as ours:
        tx.mlstm_chunkwise(*map(_t, xs), chunk=8)
    with pytest.raises(ValueError) as theirs:
        jx.mlstm_chunkwise(*map(jnp.asarray, xs), chunk=8)
    assert str(ours.value) == str(theirs.value) == "seq 12 % chunk 8 != 0"


def _block_params(jc, pc, kind):
    init = {"mlstm": jx.init_mlstm_block, "slstm": jx.init_slstm_block}[kind]
    jp = init(jax.random.PRNGKey(4), jc)
    return jp, tr.tree_map(_t, jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_jax(kind):
    """Each block over a sequence (from no state, then on from the state it
    left) and one decode step, in f32: outputs and states."""
    jc, pc = _cfgs()
    jp, tp = _block_params(jc, pc, kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    x2 = rng.standard_normal((B, 16, jc.d_model)).astype(np.float32)
    xt = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    train = {"mlstm": (jx.mlstm_block_train, tx.mlstm_block_train),
             "slstm": (jx.slstm_block_train, tx.slstm_block_train)}[kind]
    step = {"mlstm": (jx.mlstm_block_step, tx.mlstm_block_step),
            "slstm": (jx.slstm_block_step, tx.slstm_block_step)}[kind]
    jo, js = train[0](jc, jp, jnp.asarray(x))
    to, ts = train[1](pc, tp, _t(x))
    _close(to, jo, "train")
    _trees_close(ts, js, "train state")
    if kind == "mlstm":
        jo, js = train[0](jc, jp, jnp.asarray(x2), js)
        to, ts = train[1](pc, tp, _t(x2), ts)
        _close(to, jo, "train from a state")
    jo, js = step[0](jc, jp, jnp.asarray(xt), js)
    to, ts = step[1](pc, tp, _t(xt), ts)
    _close(to, jo, "step")
    _trees_close(ts, js, "step state")


def test_slstm_cell_matches_jax():
    jc, pc = _cfgs()
    jp, tp = _block_params(jc, pc, "slstm")
    rng = np.random.default_rng(6)
    d = jc.d_model
    st_ = {"h": rng.standard_normal((B, d)), "c": rng.standard_normal((B, d)),
           "n": np.abs(rng.standard_normal((B, d))), "m": rng.standard_normal((B, d))}
    st_ = {k: v.astype(np.float32) for k, v in st_.items()}
    xt = rng.standard_normal((B, d)).astype(np.float32)
    want = jx._slstm_cell_step(jc, jp, jnp.asarray(xt), st_)
    w = tx._slstm_f32(pc, tp)
    wx = (_t(xt) @ w["w"]).reshape(B, 4, d)
    got = tx._slstm_cell_step(pc, w, wx, {k: _t(v) for k, v in st_.items()})
    for k in ("h", "c", "n", "m"):
        _close(got[k], want[k], k)


def test_init_names_shapes_and_draws_match_jax():
    """The full and smoke trees carry the JAX package's names and shapes
    (``blocks.periods.pos_k.mlstm.w_up``, ``blocks.layer_###.slstm.r_z``),
    and the initial values follow its distributions."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke(ARCH))):
        names = {n: tuple(p.shape) for n, p in
                 transformer.init_model(ours, torch.Generator(), "meta").named_parameters()}
        flat = {".".join(str(k.key) for k in path): tuple(x.shape) for path, x in
                jax.tree_util.tree_flatten_with_path(jax_steps.abstract_params(theirs))[0]}
        assert names == flat
    assert "blocks.layer_002.slstm.r_z" in names  # the smoke's, unrolled
    full = {n: tuple(p.shape) for n, p in
            transformer.init_model(get_config(ARCH), torch.Generator(), "meta").named_parameters()}
    assert "blocks.periods.pos_0.mlstm.w_up" in full and "blocks.periods.pos_7.slstm.r_z" in full
    assert full["blocks.periods.pos_0.mlstm.w_up"] == (6, 2048, 8192)
    assert sum(int(np.prod(s_)) for s_ in full.values()) == 1_741_275_472
    _, pc = _cfgs()
    p = tx.init_mlstm_block(pc, generator=torch.Generator().manual_seed(0), device="cpu")
    assert float(p["b_i"][0]) == -10.0 and float(p["b_f"][0]) == 3.0
    assert abs(float(p["w_up"].std()) * pc.d_model ** 0.5 - 0.88) < 0.1  # truncated normal
    s_ = tx.init_slstm_block(pc, generator=torch.Generator().manual_seed(0), device="cpu")
    assert float(s_["r_z"].abs().max()) <= 0.1 * 2 / (pc.d_model // pc.n_heads) ** 0.5 + 1e-6


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _params(jc, pc, seed=0):
    jp = jax_steps.init_train_state(jax.random.PRNGKey(seed), jc)[0]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pc, "cpu")


@pytest.mark.parametrize("n_layers", [3, 6], ids=["unrolled", "period"])
def test_model_matches_jax(n_layers):
    """Prefill, then STEPS greedy decode steps: logits, greedy tokens and
    every cache (the f32 cell states)."""
    jc, pc = _cfgs(n_layers=n_layers)
    assert pc.period_scan == (n_layers == 6)
    jp, tp = _params(jc, pc)
    toks = np.random.default_rng(11).integers(1, jc.vocab_size, (B, S), dtype=np.int32)
    jcache = jax_tf.init_caches(jc, B, S + STEPS, jc.compute_dtype)
    jl, jcache = jax_tf.prefill(jc, jp, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.no_grad():
        cache = transformer.init_caches(pc, B, S + STEPS, pc.compute_dtype, "cpu")
        tl, cache = transformer.prefill(pc, tp, {"tokens": torch.from_numpy(toks).long()}, cache)
    _close(tl, jl, "prefill logits")
    _trees_close(cache, jcache, "prefill caches")
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for i in range(STEPS):
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt), f"greedy token {i}"
        jl, jcache = jax_tf.decode_step(jc, jp, {"tokens": jnp.asarray(nxt[:, None])}, jcache,
                                        jnp.asarray(S + i, jnp.int32))
        with torch.no_grad():
            tl, cache = transformer.decode_step(pc, tp, {"tokens": torch.tensor(nxt[:, None]).long()},
                                                cache, torch.tensor(S + i, dtype=torch.int32))
        _close(tl, jl, f"decode {i} logits")
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    _trees_close(cache, jcache, "decode caches")


@pytest.mark.parametrize("n_layers", [3, 6], ids=["unrolled", "period"])
def test_lm_loss_and_gradients_match_jax(n_layers):
    jc, pc = _cfgs(n_layers=n_layers)
    jp, tp = _params(jc, pc, seed=1)
    rng = np.random.default_rng(12)
    toks = rng.integers(1, jc.vocab_size, (B, S), dtype=np.int32)
    tg = rng.integers(0, jc.vocab_size, (B, S), dtype=np.int32)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_tf.lm_loss(jc, p, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}),
        has_aux=True)(jp)
    loss, _, grads = st.make_grad_step(pc)(tp, {"tokens": torch.from_numpy(toks).long(),
                                                "targets": torch.from_numpy(tg).long()})
    _close(loss, jloss, "loss")
    flat = {".".join(str(k.key) for k in path): g
            for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    ours = {".".join(path): g for path, g in _named(grads)}
    assert ours.keys() == flat.keys()
    for name, g in ours.items():
        assert torch.isfinite(g).all(), name
        _close(g, flat[name], name)


def _plain(tree):
    return tree.as_dict() if hasattr(tree, "as_dict") else tree


def _named(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_causality():
    """test_model_properties.py's check on the port: tokens after position
    ``cut`` never move the logits before it."""
    cfg = get_smoke_config(ARCH)
    params = st.init_params(cfg, 0, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(1))
    toks2 = toks.clone()
    toks2[:, 8:] = (toks2[:, 8:] + 7) % cfg.vocab_size
    with torch.no_grad():
        l1, _ = transformer.forward_train(cfg, params, {"tokens": toks})
        l2, _ = transformer.forward_train(cfg, params, {"tokens": toks2})
    np.testing.assert_allclose(_np(l1[:, :8]), _np(l2[:, :8]), rtol=1e-3, atol=1e-3)
    assert not np.allclose(_np(l1[:, 8:]), _np(l2[:, 8:]))


@pytest.mark.parametrize("s", [10, 33], ids=["within-a-chunk", "past-two-chunks"])
def test_prefill_then_decode_matches_longer_prefill(s):
    """test_model_properties.py's check on the port, at its tolerance (bf16):
    prefilling s - 1 tokens and decoding the last one gives the logits of
    the whole sequence.  At 33 = two smoke chunks of 16 and one token a
    prefill of 33 raises (its chunks do not divide it), so the sequence's
    logits come from the training forward at chunks of one."""
    cfg = get_smoke_config(ARCH)
    params = st.init_params(cfg, 0, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, s), generator=torch.Generator().manual_seed(2))
    _, cb = st.make_prefill_step(cfg, 1, s + 2)(params, {"tokens": toks[:, :-1]})
    lb, _ = st.make_decode_step(cfg)(params, cb, {"tokens": toks[:, -1:]}, s - 1)
    if s <= cfg.mlstm_chunk:
        la, _ = st.make_prefill_step(cfg, 1, s + 2)(params, {"tokens": toks})
    else:
        with pytest.raises(ValueError, match="% chunk"):
            st.make_prefill_step(cfg, 1, s + 2)(params, {"tokens": toks})
        with torch.no_grad():
            la, _ = transformer.forward_train(dataclasses.replace(cfg, mlstm_chunk=1), params,
                                              {"tokens": toks})
        la = la[:, -1:]
    np.testing.assert_allclose(_np(la), _np(lb), rtol=0.1, atol=0.15)


def test_smoke_forward_loss_and_train_step():
    """test_archs.py's smoke checks on the port: finite loss and logits of
    the vocabulary's width, and one optimizer step that moves the weights."""
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_smoke_config(ARCH)
    params, opt = st.init_train_state(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (2, 16), generator=g)}
    with torch.no_grad():
        logits, aux = transformer.forward_train(cfg, params, batch)
        loss, _ = transformer.lm_loss(cfg, params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size) and not torch.isnan(logits.float()).any()
    assert float(aux) == 0.0 and np.isfinite(float(loss)) and float(loss) > 0
    step = st.make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    new, new_opt, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(tr.leaves(_plain(new)), tr.leaves(_plain(params))))
    assert delta > 0 and int(new_opt["step"]) == 1


# ---------------------------------------------------------------------------
# serving and streamed weights
# ---------------------------------------------------------------------------

SEED, PROMPT, GEN = 7, 32, 6


def test_lockstep_serve_equals_jax():
    """The JAX package's weights and prompts through the port's serve loop:
    the same greedy tokens, in lock-step."""
    jc, pc = _cfgs()
    ref = jax_serve.serve(jc, make_local_mesh(), batch=B, prompt_len=PROMPT, gen=GEN,
                          kv_kind="device", kv_page_len=0, seed=SEED)
    _, params = _params(jc, pc, SEED)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (B, PROMPT), 1,
                                            jc.vocab_size), np.int32)
    assert sv.lock_step(pc)
    res = sv.serve_loop(pc, params, prompts, GEN, device=torch.device("cpu"))
    np.testing.assert_array_equal(res["generated"], ref["generated"])
    assert res["n_steps"] == ref["n_steps"] == GEN - 1


def test_serve_refuses_paged_and_streamed_weights_as_jax():
    """The recurrent caches do not page, and the period and unrolled layouts
    do not stream for serving: the JAX package's refusals, word for word."""
    jc, pc = _cfgs("bfloat16")
    with pytest.raises(ValueError, match="not pageable"):
        sv.serve(pc, batch=1, prompt_len=16, gen=2, kv_page_len=32, device="cpu")
    for over in ({}, {"n_layers": 6}):
        ours = weight_stream_support(dataclasses.replace(pc, **over))
        from repro.core.weightstream import weight_stream_support as jax_support

        theirs = jax_support(dataclasses.replace(jc, **over))
        assert (ours.supported, ours.layout, ours.serve_supported, ours.serve_reason) == (
            theirs.supported, theirs.layout, theirs.serve_supported, theirs.serve_reason)
        assert ours.supported and not ours.serve_supported
    with pytest.raises(ValueError, match="not group-pageable"):
        sv.serve(pc, batch=1, prompt_len=16, gen=2, kv_page_len=0, param_kind="pinned_host",
                 device="cpu")


def test_home_from_numpy_takes_the_xlstm_trees():
    """The JAX package's grouped homes of both layouts convert leaf for leaf."""
    from repro.core.weightstream import WeightStreamPlan as JaxPlan

    for over, lpg in (({}, 2), ({"n_layers": 6}, 1)):
        jc, pc = _cfgs("bfloat16", **over)
        jp = jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0])
        jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=lpg)
        plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=lpg)
        assert [g.key for g in plan.groups] == [g.key for g in jplan.groups]
        ours = plan.init_home(params_from_numpy(jp, pc, "cpu"))
        theirs = home_from_numpy(jplan.init_home(jp))
        for key in theirs["groups"]:
            for a, b in zip(tr.leaves(ours["groups"][key]), tr.leaves(theirs["groups"][key]),
                            strict=True):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), key


@pytest.mark.parametrize("cli", ["serve", "train", "train-streamed"])
def test_cli_runs_xlstm_on_cpu(monkeypatch, capsys, tmp_path, cli):
    if cli == "serve":
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                          "--kv-page-len", "0", "--batch", "2", "--prompt-len",
                                          "16", "--gen", "3"])
        assert sv.main() == 0
        assert f"served {ARCH}" in capsys.readouterr().out
        return
    argv = ["train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--checkpoint-dir", str(tmp_path / "ck")]
    if cli == "train-streamed":
        argv += ["--param-kind", "disk_host", "--param-layers-per-group", "2",
                 "--verify-schedule"]
    monkeypatch.setattr(sys, "argv", argv)
    assert launch.main() == 0
    assert f"trained {ARCH} (smoke) 2 steps" in capsys.readouterr().out
