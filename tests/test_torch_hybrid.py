"""The port's recurrentgemma hybrid held against the JAX package's, on the CPU.

Both sides get the same weights (the JAX package's init, converted with
``repro_torch.convert.params_from_numpy``) and the same numpy tokens, in
f32.  The smoke config's window is 16, so a prompt of 21 tokens makes
prefill place keys on the ring and decode wrap it.  The port runs with
``device="cpu"``, where its kernel wrappers take their plain versions.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.kvpager import paged_cache_supported as jax_paged_cache_supported
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.models import attention as jax_attention
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.launch import serve as sv
from repro_torch.models import attention, transformer
from repro_torch.train import steps as st

#: the JAX package's model tolerance (test_kernels.py:_tol), f32
F32_TOL = dict(rtol=2e-4, atol=2e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "recurrentgemma-2b"
B, S, STEPS = 2, 21, 8


def _cfgs(impl="pallas", dtype="float32", **kw):
    jc = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype, attn_impl=impl, **kw)
    pc = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, attn_impl=impl, **kw)
    return jc, pc


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_close(jtree, ttree, what, **tol):
    j, t = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert j.keys() == t.keys(), what
    for name in j:
        assert tuple(t[name].shape) == j[name].shape, f"{what} {name}"
        np.testing.assert_allclose(_np(t[name]), _np(j[name]), err_msg=f"{what} {name}", **tol)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_attention_matches_jax(impl):
    """Prefill longer than the window, then decode steps that wrap."""
    jc, pc = _cfgs(impl)
    jp = jax_attention.init_attention(jax.random.PRNGKey(0), jc)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, jc.d_model)) * 0.5).astype(np.float32)
    w = jc.window
    jcache = jax_attention.init_cache(jc, B, w, jnp.float32)
    cache = attention.init_cache(pc, B, w, torch.float32)
    assert cache["slot_pos"].dtype == torch.int32 and bool((cache["slot_pos"] == -1).all())

    jo, jcache = jax_attention.attention_prefill(jc, jp, jnp.asarray(x), None, jcache)
    to, cache = attention.attention_prefill(pc, tp, torch.from_numpy(x), None, cache)
    np.testing.assert_allclose(_np(to), _np(jo), **F32_TOL)
    _assert_trees_close(jcache, cache, "prefill cache", **F32_TOL)
    assert sorted(cache["slot_pos"].tolist()) == list(range(S - w, S))

    for i in range(2 * w - S + 3):  # past the end of the ring, twice around
        xs = (rng.standard_normal((B, 1, jc.d_model)) * 0.5).astype(np.float32)
        jo, jcache = jax_attention.attention_decode(jc, jp, jnp.asarray(xs), None, jcache,
                                                    jnp.asarray(S + i, jnp.int32))
        to, cache = attention.attention_decode(pc, tp, torch.from_numpy(xs), None, cache,
                                               torch.tensor(S + i, dtype=torch.int32))
        np.testing.assert_allclose(_np(to), _np(jo), err_msg=f"step {i}", **F32_TOL)
    _assert_trees_close(jcache, cache, "decode cache", **F32_TOL)


def test_ring_takes_no_vector_positions():
    jc, pc = _cfgs()
    p = attention.init_attention(pc, generator=torch.Generator().manual_seed(0), device="cpu")
    cache = attention.init_cache(pc, B, pc.window, torch.float32)
    x = torch.zeros(B, 1, pc.d_model)
    with pytest.raises(NotImplementedError, match="ring slot_pos is shared across the batch"):
        attention.attention_decode(pc, p, x, None, cache, torch.tensor([3, 4], dtype=torch.int32))
    jp = jax_attention.init_attention(jax.random.PRNGKey(0), jc)
    with pytest.raises(NotImplementedError, match="ring slot_pos is shared across the batch"):
        jax_attention.attention_decode(jc, jp, jnp.zeros((B, 1, jc.d_model)), None,
                                       jax_attention.init_cache(jc, B, jc.window),
                                       jnp.asarray([3, 4], jnp.int32))


def test_ring_decode_kernel_lengths_equal_the_ring_mask():
    """Over a ring the valid slots are the prefix [0, min(pos + 1, W)):
    decode attention with those lengths equals the masked ring attention."""
    _, pc = _cfgs("pallas")
    xla = dataclasses.replace(pc, attn_impl="xla")
    p = attention.init_attention(pc, generator=torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    caches = [attention.init_cache(c, B, pc.window, torch.float32) for c in (pc, xla)]
    x = torch.from_numpy((rng.standard_normal((B, 5, pc.d_model)) * 0.5).astype(np.float32))
    for c, cache in zip((pc, xla), caches):
        attention.attention_prefill(c, p, x, None, cache)
    for pos in range(5, 5 + 2 * pc.window):
        xs = torch.from_numpy((rng.standard_normal((B, 1, pc.d_model)) * 0.5).astype(np.float32))
        outs = [attention.attention_decode(c, p, xs, None, cache, torch.tensor(pos))[0]
                for c, cache in zip((pc, xla), caches)]
        np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------

def _params(jc, pc, seed=0):
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(seed), jc)[0]
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n_layers", [3, 5, 8])
def test_hybrid_matches_jax(n_layers, impl):
    """Prefill then STEPS greedy decode steps in lock-step: logits, greedy
    tokens and every cache.  3 and 5 layers are the unrolled layout
    (``layer_000``...); 8 layers are two periods of (rec, rec, attn) and a
    tail of two rec layers, the layout of the full model."""
    jc, pc = _cfgs(impl, n_layers=n_layers)
    jparams, params = _params(jc, pc)
    tokens = np.random.default_rng(11).integers(1, jc.vocab_size, (B, S), dtype=np.int32)
    max_len = S + STEPS

    jcaches = jax_tf.init_caches(jc, B, max_len, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, max_len, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(tokens).long()},
                                         caches)
    np.testing.assert_allclose(_np(tl), _np(jl), err_msg="prefill logits", **F32_TOL)
    _assert_trees_close(jcaches, caches, "prefill caches", **F32_TOL)

    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for i in range(STEPS):
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt), f"greedy token {i}"
        jl, jcaches = jax_tf.decode_step(jc, jparams, {"tokens": jnp.asarray(nxt[:, None])},
                                         jcaches, jnp.asarray(S + i, jnp.int32))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, {"tokens": torch.tensor(nxt[:, None]).long()},
                                                 caches, torch.tensor(S + i, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"decode {i} logits", **F32_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    _assert_trees_close(jcaches, caches, "decode caches", **F32_TOL)


@pytest.mark.parametrize("arch", ["smollm-360m", ARCH])
def test_prefill_then_decode_matches_longer_prefill(arch):
    """test_model_properties.py's check on the port: prefilling s tokens
    equals prefilling s - 1 and decoding the last one."""
    cfg = get_smoke_config(arch)
    params = st.init_params(cfg, 0, "cpu")
    b, s = 1, 10
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(2))
    la, _ = st.make_prefill_step(cfg, b, s + 2)(params, {"tokens": toks})
    _, cb = st.make_prefill_step(cfg, b, s + 2)(params, {"tokens": toks[:, :-1]})
    lb, _ = st.make_decode_step(cfg)(params, cb, {"tokens": toks[:, -1:]}, s - 1)
    np.testing.assert_allclose(_np(la), _np(lb), rtol=0.1, atol=0.15)


def test_params_from_numpy_takes_the_period_tree():
    jc, pc = _cfgs(n_layers=8)
    tree = jax.tree.map(np.asarray, jax_tf.init_model(jax.random.PRNGKey(0), jc))
    params = params_from_numpy(tree, pc, "cpu")
    names = {n for n, _ in params.named_parameters()}
    assert names == {n for n, _ in _leaves(tree)}
    assert "blocks.periods.pos_0.rec.w_a" in names and "blocks.tail_1.mlp.wi" in names
    assert tuple(params.blocks.periods.pos_2.attn.wq.shape) == (2, jc.d_model, jc.n_heads, jc.head_dim)
    del tree["blocks"]["tail_1"]["rec"]["lambda"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, pc, "cpu")


@pytest.mark.parametrize("n_layers", [3, 8])
def test_abstract_caches_match_jax(n_layers):
    jc, pc = _cfgs(dtype="bfloat16", n_layers=n_layers)
    j = dict(_leaves(jax_steps.abstract_caches(jc, 3, 40)))
    t = dict(_leaves(st.abstract_caches(pc, 3, 40)))
    assert j.keys() == t.keys()
    for name in j:
        assert tuple(t[name].shape) == j[name].shape and t[name].device.type == "meta", name
        assert t[name].dtype == getattr(torch, j[name].dtype.name), name


@pytest.mark.parametrize("arch,swa", [("smollm-360m", False), (ARCH, False), ("olmo-1b", True)])
def test_paged_cache_supported_matches_jax(arch, swa):
    jc, pc = jax_get_smoke_config(arch), get_smoke_config(arch)
    if swa:
        jc = dataclasses.replace(jc, attn_type="swa", window=4)
        pc = dataclasses.replace(pc, attn_type="swa", window=4)
    want = jax_paged_cache_supported(jax_steps.abstract_caches(jc, 1, 16))
    assert st.paged_cache_supported(st.abstract_caches(pc, 1, 16)) is want
    assert want is (arch == "smollm-360m")
    assert st.paged_cache_supported({}) is False


# ---------------------------------------------------------------------------
# serving in lock-step
# ---------------------------------------------------------------------------

SEED, PROMPT, GEN = 7, 21, 8


@pytest.fixture(scope="module")
def jax_reference():
    jc, _ = _cfgs("pallas")
    return jax_serve.serve(jc, make_local_mesh(), batch=B, prompt_len=PROMPT, gen=GEN,
                           kv_kind="device", kv_page_len=0, seed=SEED)


@pytest.mark.parametrize("arch,lock", [("smollm-360m", False), ("recurrentgemma-2b", True),
                                       ("olmo-1b", False)])
def test_serve_schedule_follows_the_caches(arch, lock):
    """Full-attention caches prefill per request and decode at per-slot
    positions; ring and recurrent caches serve in lock-step."""
    cfg = get_smoke_config(arch)
    assert sv.lock_step(cfg) is lock
    assert sv.step_pos(cfg, 3, 9, "cpu").shape == (() if lock else (3,))
    assert sv.lock_step(dataclasses.replace(cfg, attn_type="swa", window=4))


def test_lockstep_serve_equals_jax(jax_reference):
    jc, pc = _cfgs("pallas")
    _, params = _params(jc, pc, SEED)
    # the prompts the JAX serve drew (repro/launch/serve.py:_serve_unpaged)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (B, PROMPT), 1,
                                            jc.vocab_size), np.int32)
    res = sv.serve_loop(pc, params, prompts, GEN, device=torch.device("cpu"))
    np.testing.assert_array_equal(res["generated"], jax_reference["generated"])
    assert res["n_steps"] == jax_reference["n_steps"] == GEN - 1
    assert res["paged"] is jax_reference["paged"] is False


def test_serve_runs_the_hybrid_and_the_kernel_path_on_cpu(monkeypatch):
    """``serve`` draws its own weights and prompts; on the CPU the kernel
    wrappers run their plain versions and count no launch."""
    _, pc = _cfgs("pallas", dtype="bfloat16")
    before = (flash_attention.launches, decode_attention.launches)
    res = sv.serve(pc, batch=2, prompt_len=20, gen=4, kv_page_len=0, seed=1, device="cpu")
    assert res["generated"].shape == (2, 4) and res["tokens_per_s"] > 0
    assert (flash_attention.launches, decode_attention.launches) == before
    # ring and recurrent caches cannot be paged, as in the JAX package
    with pytest.raises(ValueError, match="not pageable"):
        sv.serve(pc, batch=1, prompt_len=4, gen=2, kv_page_len=32, device="cpu")


def test_hybrid_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _cfgs("pallas", dtype="bfloat16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.serve(pc, batch=1, prompt_len=4, gen=2, kv_page_len=0)


def test_cli_serves_the_hybrid_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                      "--kv-page-len", "0", "--batch", "2", "--prompt-len", "20",
                                      "--gen", "3"])
    assert sv.main() == 0
    assert f"served {ARCH}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card: the attention kernels at the hybrid's head_dim 256
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, scale, device):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(300, 64), (1024, 0), (2100, 2048)])
def test_flash_kernel_at_head_dim_256_on_card(cuda, s, window):
    rng = np.random.default_rng(3)
    q = _bf16(rng, (1, s, 10, 256), 0.5, cuda)
    k, v = _bf16(rng, (1, s, 1, 256), 0.5, cuda), _bf16(rng, (1, s, 1, 256), 1.0, cuda)
    out = flash_attention(q, k, v, window=window)
    np.testing.assert_allclose(_np(out.cpu()), _np(attention_ref(q, k, v, window=window).cpu()), **BF16_TOL)


@pytest.mark.cuda
def test_decode_kernel_at_head_dim_256_on_card(cuda):
    """Over four 2048-slot rings, full and ragged; bitwise equal for every
    ring that fits (at most 3 stages at head_dim 256)."""
    rng = np.random.default_rng(5)
    q = _bf16(rng, (4, 10, 256), 0.5, cuda)
    k, v = _bf16(rng, (4, 2048, 1, 256), 0.5, cuda), _bf16(rng, (4, 2048, 1, 256), 1.0, cuda)
    lengths = torch.tensor([2048, 1000, 1, 0], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(_np(out.cpu()), _np(decode_attention_ref(q, k, v, lengths).cpu()),
                               **BF16_TOL)
    for spec in (PrefetchSpec(1, 1, 0), PrefetchSpec(3, 1, 2)):
        assert torch.equal(decode_attention(q, k, v, lengths, spec=spec), out)


@pytest.mark.cuda
def test_hybrid_kernel_path_matches_plain_path_on_card(cuda):
    """The smoke hybrid at a head dim the kernels take (64), bf16: the kernel
    path's logits within 5e-2 of the plain path's, relative to the largest
    logit (the gate chip_smoke.py holds the full-width models to)."""
    _, pc = _cfgs("pallas", dtype="bfloat16", head_dim=64)
    xla = dataclasses.replace(pc, attn_impl="xla")
    params = st.init_params(pc, 0, cuda)
    toks = torch.randint(1, pc.vocab_size, (2, S), generator=torch.Generator().manual_seed(4)).to(cuda)
    out = []
    for c in (pc, xla):
        logits, caches = st.make_prefill_step(c, 2, S + 4)(params, {"tokens": toks})
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits2, _ = st.make_decode_step(c)(params, caches, {"tokens": nxt},
                                            torch.tensor(S, dtype=torch.int32, device=cuda))
        out.append((logits, logits2))
    for a, b in zip(*out):
        assert bool(torch.isfinite(a).all())
        assert (a.float() - b.float()).abs().max().item() <= 5e-2 * b.float().abs().max().item()
