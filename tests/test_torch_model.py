"""The port's model held against the JAX package's, on the CPU.

Both sides get the same weights (the JAX package's init, converted with
``repro_torch.convert.params_from_numpy``) and the same numpy tokens.  The
JAX side runs ``attn_impl="pallas"`` as its own tests do (the flash kernel
in interpret mode); the port runs with ``device="cpu"``, where its kernel
wrappers take their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer
from repro_torch.train import steps as st

#: the JAX package's model tolerance (test_kernels.py:_tol): f32, bf16
F32_TOL = dict(rtol=2e-4, atol=2e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

B, S, STEPS = 2, 13, 3


def _cfgs(dtype, impl, arch="smollm-360m"):
    jc = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype, attn_impl=impl)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=dtype, attn_impl=impl)
    return jc, pc


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _run_both(dtype, impl, last_pos=None, arch="smollm-360m"):
    """Prefill then STEPS vector-pos decode steps in both packages; yields
    (what, jax value, port value) for the logits and the caches."""
    jc, pc = _cfgs(dtype, impl, arch)
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, jc.vocab_size, (B, S), dtype=np.int32)
    max_len = S + STEPS + 1

    jcaches = jax_tf.init_caches(jc, B, max_len, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)}, jcaches,
                                 last_pos=last_pos)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, max_len, pc.compute_dtype, "cpu")
        pl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(tokens).long()},
                                         caches, last_pos=last_pos)
    yield "prefill logits", jl, pl
    for name in ("k", "v"):
        yield f"prefill cache {name}", jcaches[name], caches[name]

    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for i in range(STEPS):
        pos = np.asarray([S + i, S - 2 + i], np.int32)  # per-slot positions
        jl, jcaches = jax_tf.decode_step(jc, jparams, {"tokens": jnp.asarray(nxt[:, None])},
                                         jcaches, jnp.asarray(pos))
        with torch.no_grad():
            pl, caches = transformer.decode_step(
                pc, params, {"tokens": torch.tensor(nxt[:, None]).long()}, caches,
                torch.tensor(pos))
        yield f"decode {i} logits", jl, pl
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for name in ("k", "v"):
        yield f"decode cache {name}", jcaches[name], caches[name]


@pytest.mark.parametrize("last_pos", [None, 5])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax_f32(impl, last_pos):
    for what, ref, out in _run_both("float32", impl, last_pos):
        assert tuple(out.shape) == tuple(ref.shape), what
        np.testing.assert_allclose(_f32(out), _f32(ref), err_msg=what, **F32_TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "internlm2-20b", "minitron-4b"])
def test_other_dense_archs_match_jax(arch):
    """Non-parametric and parametric LayerNorm, MHA, squared-ReLU MLP and an
    untied head, on the kernel path."""
    for what, ref, out in _run_both("float32", "pallas", arch=arch):
        np.testing.assert_allclose(_f32(out), _f32(ref), err_msg=what, **F32_TOL)


def test_rope_and_sinusoidal_match_jax():
    from repro.models import rope as jax_rope
    from repro_torch.models import rope

    rng = np.random.default_rng(5)
    pos = (np.arange(37)[None] + np.array([[0], [900]])).astype(np.int32)
    x = rng.standard_normal((2, 37, 3, 64)).astype(np.float32)
    ja = jax_rope.rope_angles(jnp.asarray(pos), 64, 10_000.0)
    ta = rope.rope_angles(torch.from_numpy(pos), 64, 10_000.0)
    np.testing.assert_allclose(_f32(ta), _f32(ja), **F32_TOL)
    np.testing.assert_allclose(_f32(rope.apply_rope(torch.from_numpy(x), ta)),
                               _f32(jax_rope.apply_rope(jnp.asarray(x), ja)), **F32_TOL)
    np.testing.assert_allclose(_f32(rope.sinusoidal_embedding(torch.from_numpy(pos), 60)),
                               _f32(jax_rope.sinusoidal_embedding(jnp.asarray(pos), 60)), **F32_TOL)


def test_abstract_caches_match_jax():
    jc, pc = _cfgs("bfloat16", "pallas")
    j = jax_steps.abstract_caches(jc, 3, 40)
    t = st.abstract_caches(pc, 3, 40)
    assert j.keys() == t.keys()
    for name in j:
        assert tuple(t[name].shape) == j[name].shape and t[name].device.type == "meta"
        assert t[name].dtype == getattr(torch, j[name].dtype.name)


def test_prefill_and_decode_match_jax_bf16():
    """bf16 on the plain attention path, which rounds where the JAX
    package's XLA path rounds."""
    for what, ref, out in _run_both("bfloat16", "xla"):
        assert out.dtype == torch.bfloat16, what
        np.testing.assert_allclose(_f32(out), _f32(ref), err_msg=what, **BF16_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_scalar_pos_decode_matches_vector_pos(impl):
    _, pc = _cfgs("float32", impl)
    params = st.init_params(pc, 3, "cpu")
    tokens = torch.randint(1, pc.vocab_size, (B, S), generator=torch.Generator().manual_seed(0))
    prefill = st.make_prefill_step(pc, B, S + 1)
    decode = st.make_decode_step(pc)
    nxt = {"tokens": tokens[:, -1:]}
    _, c1 = prefill(params, {"tokens": tokens})
    _, c2 = prefill(params, {"tokens": tokens})
    l1, _ = decode(params, c1, nxt, S)
    l2, _ = decode(params, c2, nxt, torch.full((B,), S, dtype=torch.int32))
    assert torch.equal(l1, l2)


def test_params_from_numpy_keeps_bf16_bits_and_checks_names():
    jc, pc = _cfgs("bfloat16", "pallas")
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(1), jc)[0]
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, pc, "cpu")
    tok = params.embed.tok
    assert tok.dtype == torch.bfloat16
    want = np.asarray(tree["embed"]["tok"]).view(np.uint16)
    assert np.array_equal(tok.view(torch.int16).numpy().view(np.uint16), want)
    assert sorted(n for n, _ in params.named_parameters())[:2] == ["blocks.attn.wk", "blocks.attn.wo"]
    del tree["blocks"]["mlp"]["wg"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, pc, "cpu")
    assert tensor_from_numpy(np.zeros(3, np.int32)).dtype == torch.int32


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card, as at every entry point: without one
    it raises instead of leaving the parameters on the CPU."""
    jc, pc = _cfgs("float32", "pallas")
    tree = jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(2), jc)[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, pc)
    assert params_from_numpy(tree, pc, "cpu").embed.tok.device.type == "cpu"


# ---------------------------------------------------------------------------
# configs: a field-for-field copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    get_j, get_p = (jax_get_smoke_config, get_smoke_config) if smoke else (jax_get_config, get_config)
    jc, pc = get_j(arch), get_p(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.compute_dtype == getattr(torch, jc.dtype)
    assert (pc.gqa_groups, pc.uniform_blocks, pc.scan_period, pc.subquadratic) == (
        jc.gqa_groups, jc.uniform_blocks, jc.scan_period, jc.subquadratic)
    assert pc.param_count() == jc.param_count()


def test_registry_matches_jax():
    from repro.configs.base import SHAPES as JAX_SHAPES

    assert ARCHS == JAX_ARCHS
    assert SHAPES == JAX_SHAPES
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_families_match_jax(arch):
    """The MoE families init with the JAX package's names and shapes, and
    prefill and three scalar-position decode steps (the smoke mixtral's
    window ring) give its logits and caches, in f32."""
    ours = {n: tuple(p.shape) for n, p in
            transformer.init_model(get_smoke_config(arch), torch.Generator(), "meta").named_parameters()}
    theirs = jax_steps.abstract_params(jax_get_smoke_config(arch))
    flat = {".".join(str(k.key) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert ours == flat
    jc, pc = _cfgs("float32", "xla", arch)
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    tokens = np.random.default_rng(12).integers(1, jc.vocab_size, (B, S), dtype=np.int32)
    jcaches = jax_tf.init_caches(jc, B, S + STEPS, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, S + STEPS, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(tokens).long()},
                                         caches)
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(tl), _f32(jl), err_msg=f"step {i}", **F32_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
        jl, jcaches = jax_tf.decode_step(jc, jparams, {"tokens": jnp.asarray(nxt[:, None])}, jcaches,
                                         jnp.asarray(S + i, jnp.int32))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, {"tokens": torch.tensor(nxt[:, None]).long()},
                                                 caches, torch.tensor(S + i, dtype=torch.int32))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **F32_TOL)
    for name in jcaches:
        np.testing.assert_allclose(_f32(caches[name]), _f32(jcaches[name]), err_msg=name, **F32_TOL)


def test_unported_attention_modes_raise():
    """``attn_impl="chunked"`` prefills in query blocks (four of 4 here)
    within f32 tolerance of the plain path, and of the JAX package's chunked
    prefill; sliding-window rings are ported: an olmo-1b smoke config with
    ``attn_type="swa"``, window 4, prefills 9 tokens and decodes 5 steps
    (scalar positions) equal to the JAX package."""
    jc, pc = (dataclasses.replace(c, attn_impl="chunked", attn_chunk_q=4)
              for c in _cfgs("float32", "xla", "smollm-360m"))
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    tokens = np.random.default_rng(1).integers(1, jc.vocab_size, (B, 16), dtype=np.int32)
    jl, _ = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)},
                           jax_tf.init_caches(jc, B, 16, jc.compute_dtype))
    batch = {"tokens": torch.from_numpy(tokens).long()}
    chunked, _ = st.make_prefill_step(pc, B, 16)(params, batch)
    plain, _ = st.make_prefill_step(dataclasses.replace(pc, attn_impl="xla"), B, 16)(params, batch)
    np.testing.assert_allclose(_f32(chunked), _f32(plain), **F32_TOL)
    np.testing.assert_allclose(_f32(chunked), _f32(jl), **F32_TOL)
    jc, pc = _cfgs("float32", "pallas", "olmo-1b")
    jc, pc = (dataclasses.replace(c, attn_type="swa", window=4) for c in (jc, pc))
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    tokens = np.random.default_rng(12).integers(1, jc.vocab_size, (B, 9), dtype=np.int32)
    jcaches = jax_tf.init_caches(jc, B, 16, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, 16, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(tokens).long()}, caches)
    assert tuple(caches["slot_pos"].shape) == (pc.n_layers, 4)
    for i in range(5):
        np.testing.assert_allclose(_f32(tl), _f32(jl), err_msg=f"step {i}", **F32_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
        jl, jcaches = jax_tf.decode_step(jc, jparams, {"tokens": jnp.asarray(nxt[:, None])}, jcaches,
                                         jnp.asarray(9 + i, jnp.int32))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, {"tokens": torch.tensor(nxt[:, None]).long()},
                                                 caches, torch.tensor(9 + i, dtype=torch.int32))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **F32_TOL)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(_f32(caches[name]), _f32(jcaches[name]), err_msg=name, **F32_TOL)
