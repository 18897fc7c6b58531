"""Serving parameters built group by group (``train/steps.py::init_params``)
and the qwen3-moe grouping of 16 query heads a KV head, on the CPU.

``init_params`` draws the shell, then each layer (a period unit of a
period-scanned stack) and casts it into preallocated compute-dtype leaves:
bitwise the whole f32 draw of ``transformer.init_model`` cast at once, in
every layout.  A qwen3-moe smoke config at 16 query heads over 1 KV head
prefills and decodes as the JAX package does (its flash kernel in interpret
mode; the port's plain path), in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import tree as tr
from repro_torch.device import generator
from repro_torch.models import transformer
from repro_torch.train import steps as st

F32_TOL = dict(rtol=2e-4, atol=2e-3)  # the JAX package's f32 model tolerance


def _whole(cfg, seed):
    """The whole tree drawn in f32 at once, then cast."""
    return transformer.init_model(cfg, generator(seed, torch.device("cpu")), "cpu").to(
        cfg.compute_dtype).as_dict()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_groupwise_init_is_bitwise_the_whole_draw(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    got = st.init_params(cfg, 7, "cpu").as_dict()
    want = _whole(cfg, 7)
    (gl, gt), (wl, wt) = tr.flatten(got), tr.flatten(want)
    assert gt == wt
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype == cfg.compute_dtype and a.shape == b.shape
        assert a.is_contiguous() and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_groupwise_init_at_full_depth_of_a_cut_width():
    """Many layers of a uniform stack (each its own slice) and a different
    seed: still the whole draw's bits, and another seed's differ."""
    cfg = dataclasses.replace(get_smoke_config("internlm2-20b"), n_layers=9)
    got = tr.leaves(st.init_params(cfg, 3, "cpu").as_dict())
    want = tr.leaves(_whole(cfg, 3))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = tr.leaves(st.init_params(cfg, 4, "cpu").as_dict())
    assert not all(torch.equal(a, b) for a, b in zip(got, other))


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("olmo-1b")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            st.init_params(cfg, 0, device)


def test_qwen3_sixteen_query_heads_a_kv_head_match_jax():
    """qwen3-moe's smoke config at 16 query heads over 1 KV head (the G of
    its 64 over 4): prefill and three decode steps, logits and caches within
    the f32 tolerance of the JAX package's."""
    b, s, steps = 2, 13, 3
    kw = dict(n_heads=16, n_kv_heads=1, dtype="float32", attn_impl="pallas")
    jc = dataclasses.replace(jax_get_smoke_config("qwen3-moe-235b-a22b"), **kw)
    pc = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), **kw)
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    attn = params["blocks"]["attn"]
    assert attn["wq"].shape[-2] == 16 and attn["wk"].shape[-2] == 1 and "q_norm" in attn
    tokens = np.random.default_rng(13).integers(1, jc.vocab_size, (b, s), dtype=np.int32)
    jcaches = jax_tf.init_caches(jc, b, s + steps, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, b, s + steps, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(tokens).long()},
                                         caches)
    for i in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **F32_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
        pos = np.asarray([s + i, s - 1 + i], np.int32)  # per-slot positions
        jl, jcaches = jax_tf.decode_step(jc, jparams, {"tokens": jnp.asarray(nxt[:, None])},
                                         jcaches, jnp.asarray(pos))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params,
                                                 {"tokens": torch.tensor(nxt[:, None]).long()},
                                                 caches, torch.tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    for name in jcaches:
        np.testing.assert_allclose(caches[name].numpy(), np.asarray(jcaches[name]), err_msg=name,
                                   **F32_TOL)
