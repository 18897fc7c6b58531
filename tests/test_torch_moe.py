"""The port's MoE layers and chunked attention held against the JAX package's.

Both packages get the same numpy inputs and the JAX package's initialized
parameters (converted with ``repro_torch.convert``), in f32, at the smoke
sizes of mixtral-8x7b (8 experts top-2 here) and qwen3-moe-235b (8 experts
top-2, qk-norm).  Routing indices must be equal exactly; weights, outputs
and the aux loss within the JAX package's f32 tolerance (rtol 2e-4 / atol
2e-3).  Inside the port, the routed subset of the expert stack gives the
full stack's bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import tree as tr
from repro_torch.models import moe, transformer
from repro_torch.train import steps as st

F32_TOL = dict(rtol=2e-4, atol=2e-3)
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")


def _cfgs(arch, **kw):
    """(port config, JAX config): the smoke config in f32 with 8 experts."""
    kw = {"dtype": "float32", "n_experts": 8, **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def _moe_params(jc):
    """Layer 0's ``moe`` subtree of the JAX package's init, as numpy."""
    p = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    return {k: np.asarray(v[0]) for k, v in p["blocks"]["moe"].items()}


def _t(tree):
    return tr.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_shapes_equal_jax(arch):
    pc, jc = _cfgs(arch)
    ours = moe.init_moe(pc, generator=torch.Generator().manual_seed(0), device="cpu")
    theirs = jax_moe.init_moe(jax.random.PRNGKey(0), jc)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape and ours[k].dtype == torch.float32
    # fan-in init: the same scale of draw
    for k in ours:
        np.testing.assert_allclose(float(ours[k].std()), float(np.std(theirs[k])), rtol=0.1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("lead", [(5, 7), (2, 3, 4)])
def test_router_matches_jax(arch, lead):
    pc, jc = _cfgs(arch)
    p = _moe_params(jc)
    x = _x(lead + (pc.d_model,), seed=len(lead))
    jw, ji, jp, jaux = jax_moe._router(jc, {"router": jnp.asarray(p["router"])}, jnp.asarray(x))
    tw, ti, tp, taux = moe._router(pc, _t({"router": p["router"]}), torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seq, group, capacity_factor", [
    (16, 64, 1.25),  # one chunk
    (24, 8, 1.25),  # three chunks
    (16, 16, 0.5),  # capacity drops tokens
])
def test_moe_dispatch_matches_jax(arch, seq, group, capacity_factor):
    pc, jc = _cfgs(arch, moe_group_size=group, capacity_factor=capacity_factor)
    p = _moe_params(jc)
    x = _x((2, seq, pc.d_model), seed=seq)
    jy, jaux = jax_moe.moe_dispatch(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    with torch.no_grad():
        ty, taux = moe.moe_dispatch(pc, _t(p), torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)
    if capacity_factor < 1:
        # past capacity a (token, choice) pair is dropped: some tokens then
        # get less than their full routed output, some nothing at all
        full, _ = moe.moe_dispatch(dataclasses.replace(pc, capacity_factor=8.0), _t(p),
                                   torch.from_numpy(x))
        assert not torch.allclose(ty, full)
        assert bool((ty.abs().sum(-1) == 0).any())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_gradients_match_jax(arch):
    """The chunked dispatch under checkpoints differentiates as JAX's."""
    pc, jc = _cfgs(arch, moe_group_size=8)
    p = _moe_params(jc)
    x = _x((2, 16, pc.d_model), seed=3)

    def jloss(q, xx):
        y, aux = jax_moe.moe_dispatch(jc, q, xx)
        return jnp.sum(y * y) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_dispatch(pc, tp, tx)
    (torch.sum(y * y) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32_TOL)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), err_msg=k, **F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_jax_and_subset_is_bitwise(arch):
    pc, jc = _cfgs(arch)
    p = _moe_params(jc)
    x = _x((3, 1, pc.d_model), seed=5)
    jy = jax_moe.moe_decode(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _t(p)
    with torch.no_grad():
        ty = moe.moe_decode(pc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    # the routed subset of the stack, top_i remapped into it: the same bits
    for dtype in (torch.float32, torch.bfloat16):
        xd = torch.from_numpy(x).to(dtype)
        pd = {k: v.to(dtype) for k, v in tp.items()}
        top_w, top_i = moe.decode_route(pc, pd, xd)
        full = moe.decode_apply(pc, {n: pd[n] for n in moe.EXPERT_NAMES if n in pd}, top_w,
                                top_i, xd)
        ids = torch.unique(top_i)
        assert len(ids) < pc.n_experts
        subset = {n: pd[n][ids] for n in moe.EXPERT_NAMES if n in pd}
        local = torch.searchsorted(ids, top_i.contiguous())
        assert torch.equal(moe.decode_apply(pc, subset, top_w, local, xd), full)
        assert torch.equal(moe.moe_decode(pc, pd, xd), full)


# ---------------------------------------------------------------------------
# the MoE layer in the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_prefill_decode_consistency(arch):
    """Greedy decode after prefill equals the full forward's last position
    (the JAX package's ``test_archs`` check; no-drop capacity, since a
    12-token chunk and a one-token decode drop different tokens)."""
    pc, _ = _cfgs(arch, capacity_factor=8 / 2 + 1.0)
    params = st.init_params(pc, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(1, pc.vocab_size, (2, 12)))
    with torch.no_grad():
        caches = transformer.init_caches(pc, 2, 16, pc.compute_dtype, "cpu")
        _, caches = transformer.prefill(pc, params, {"tokens": toks[:, :-1]}, caches)
        dec, _ = transformer.decode_step(pc, params, {"tokens": toks[:, -1:]}, caches,
                                         torch.tensor(11, dtype=torch.int32))
        full, _ = transformer.forward_train(pc, params, {"tokens": toks})
    np.testing.assert_allclose(dec.numpy(), full[:, -1:].numpy(), **F32_TOL)


def test_mixtral_causality():
    """Changing a later token never changes an earlier position's logits
    (the JAX package's ``test_model_properties`` check)."""
    pc, _ = _cfgs("mixtral-8x7b", capacity_factor=8 / 2 + 1.0)
    params = st.init_params(pc, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(1, pc.vocab_size, (1, 12)))
    other = toks.clone()
    other[0, 8:] = (other[0, 8:] + 7) % pc.vocab_size
    with torch.no_grad():
        a, _ = transformer.forward_train(pc, params, {"tokens": toks})
        b, _ = transformer.forward_train(pc, params, {"tokens": other})
    np.testing.assert_allclose(a[:, :8].numpy(), b[:, :8].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_block_decode_pre_moe_is_the_layer_body(arch):
    """The streamed decode's two halves (attention and the router, then the
    routed experts on a subset) give one layer's decode bits."""
    pc, _ = _cfgs(arch, dtype="bfloat16")
    params = st.init_params(pc, 0, "cpu")
    blocks = params.as_dict()["blocks"]
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, pc.vocab_size, (2, 9)))
    with torch.no_grad():
        caches = transformer.init_caches(pc, 2, 12, pc.compute_dtype, "cpu")
        _, caches = transformer.prefill(pc, params, {"tokens": toks}, caches)
        x = transformer.embed_stage(pc, params.as_dict(), {"tokens": toks[:, -1:]})
        pos = torch.tensor(9, dtype=torch.int32)
        angles = transformer.stage_angles(pc, {"tokens": toks[:, -1:]}, 1, pos=pos)
        one = {k: v.narrow(0, 0, 1) for k, v in caches.items()}
        two = {k: v.clone() for k, v in one.items()}
        layer0 = tr.tree_map(lambda a: a[:1], blocks)
        ref, _ = transformer.block_group_decode(pc, layer0, one, x, angles, pos)
        ne = {k: v for k, v in layer0.items() if k != "moe"}
        ne["moe"] = {"router": layer0["moe"]["router"]}
        x_attn, h2, top_w, top_i = transformer.block_decode_pre_moe(pc, ne, two, x, angles, pos)
        ids = torch.unique(top_i)
        stack = {n: layer0["moe"][n][0][ids] for n in moe.EXPERT_NAMES if n in layer0["moe"]}
        out = x_attn + moe.decode_apply(pc, stack, top_w,
                                        torch.searchsorted(ids, top_i.contiguous()), h2)
    assert torch.equal(out, ref)
    for k in one:
        assert torch.equal(two[k], one[k])


# ---------------------------------------------------------------------------
# attn_impl="chunked"
# ---------------------------------------------------------------------------


def _chunked_pair(arch, chunk, **kw):
    pc, jc = _cfgs(arch) if arch in MOE_ARCHS else (
        dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw),
        dataclasses.replace(jax_smoke(arch), dtype="float32", **kw))
    return (dataclasses.replace(pc, attn_impl="xla"),
            dataclasses.replace(pc, attn_impl="chunked", attn_chunk_q=chunk), jc)


@pytest.mark.parametrize("arch, chunk", [("internlm2-20b", 16), ("smollm-360m", 8),
                                         ("mixtral-8x7b", 4), ("olmo-1b", 48)])
def test_chunked_loss_equals_xla(arch, chunk):
    """Query blocks of ``attn_chunk_q`` (a window too, for mixtral) give the
    plain path's loss within the JAX package's bound (1e-4,
    ``tests/test_archs.py``) and its gradients within f32 tolerance; a block
    that does not divide the sequence falls back to one whole block."""
    xla, chunked, jc = _chunked_pair(arch, chunk)
    p = jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0])
    toks = np.random.default_rng(4).integers(1, xla.vocab_size, (2, 65), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    lx, _, gx = st.make_grad_step(xla)(params_from_numpy(p, xla, "cpu"), batch)
    lc, _, gc = st.make_grad_step(chunked)(params_from_numpy(p, chunked, "cpu"), batch)
    assert abs(float(lx) - float(lc)) < 1e-4
    for a, b in zip(tr.leaves(gc), tr.leaves(gx)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)


def test_chunked_prefill_matches_jax_chunked():
    """The port's chunked prefill against the JAX package's, windowed (a
    mixtral smoke config, window 16, four query blocks of 8)."""
    _, pc, jc = _chunked_pair("mixtral-8x7b", 8)
    jc = dataclasses.replace(jc, attn_impl="chunked", attn_chunk_q=8)
    p = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, p), pc, "cpu")
    toks = np.random.default_rng(6).integers(1, pc.vocab_size, (2, 32), dtype=np.int32)
    jcaches = jax_tf.init_caches(jc, 2, 34, jc.compute_dtype)
    jl, _ = jax_tf.prefill(jc, p, {"tokens": jnp.asarray(toks)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, 2, 34, pc.compute_dtype, "cpu")
        tl, _ = transformer.prefill(pc, params, {"tokens": torch.from_numpy(toks).long()}, caches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


def test_chunked_blocks_keep_the_plain_bits_when_one_block():
    """``S <= attn_chunk_q`` or a block that does not divide S is the plain
    path itself: the same bits."""
    pc = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32")
    params = st.init_params(pc, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, pc.vocab_size, (2, 12)))
    with torch.no_grad():
        ref, _ = transformer.forward_train(dataclasses.replace(pc, attn_impl="xla"), params,
                                           {"tokens": toks})
        for chunk in (16, 5):
            c = dataclasses.replace(pc, attn_impl="chunked", attn_chunk_q=chunk)
            out, _ = transformer.forward_train(c, params, {"tokens": toks})
            assert torch.equal(out, ref)
