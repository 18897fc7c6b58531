"""The port's RG-LRU block and its ``rglru_scan`` kernel held against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs its Pallas kernel in interpret mode, as ``test_rglru_kernel.py``
runs it, and the port's wrapper runs its plain version on CPU tensors.
Tests marked ``cuda`` hold the CUDA kernel against the plain version on a
card and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.rglru_scan import linear_recurrence as jax_linear_recurrence
from repro.kernels.rglru_scan import linear_recurrence_ref as jax_linear_recurrence_ref
from repro.models import rglru as jax_rglru
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.rglru_scan import linear_recurrence, linear_recurrence_ref, ops
from repro_torch.models import rglru

#: tests/test_rglru_kernel.py: the kernel against its oracle, and the
#: block's kernel path against its associative-scan path
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)

CASES = [  # (B, S, W): test_rglru_kernel.CASES
    (2, 128, 256),
    (1, 64, 128),
    (3, 100, 130),
    (2, 8, 512),
    (1, 256, 64),
]


def _ab(b, s, w, seed=0):
    """a in (0, 1) like the RG-LRU decay; b arbitrary."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((b, s, w)) + 2.0)))
    return a.astype(np.float32), (rng.standard_normal((b, s, w)) * 0.5).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,w", CASES)
def test_linear_recurrence_matches_jax(b, s, w):
    a, bb = _ab(b, s, w)
    jax_kernel = jax_linear_recurrence(jnp.asarray(a), jnp.asarray(bb), chunk_t=32, block_w=128)
    jax_ref = jax_linear_recurrence_ref(jnp.asarray(a), jnp.asarray(bb))
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    for out in (linear_recurrence(ta, tb, chunk_t=32, block_w=128), linear_recurrence_ref(ta, tb)):
        assert out.shape == (b, s, w) and out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), _np(jax_kernel), **SCAN_TOL)
        np.testing.assert_allclose(_np(out), _np(jax_ref), **SCAN_TOL)


def test_linear_recurrence_decay_semantics():
    """a=0 forgets everything (h=b); a=1 integrates (h=cumsum b)."""
    b = torch.ones((1, 16, 128))
    assert torch.equal(linear_recurrence(torch.zeros_like(b), b), b)
    out = linear_recurrence(torch.ones_like(b), b)
    assert torch.equal(out[0, :, 0], torch.arange(1.0, 17.0))


def test_linear_recurrence_contract_errors():
    a = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="one shape"):
        linear_recurrence(a, a[:, :4])
    with pytest.raises(ValueError, match="multiple of 32"):
        linear_recurrence(a, a, block_w=100)
    with pytest.raises(ValueError, match="chunk_t"):
        linear_recurrence(a, a, chunk_t=0)


def test_kernel_tiling_fits_shared_memory():
    """The TPU's (128, 256) tile pair does not fit a Hopper block twice over:
    a stage holds what two stages of a and b fit; shorter inputs cut it."""
    assert ops.block_width(2560, 256) == 256 and ops.block_width(130, 256) == 160
    assert ops.stage_rows(3072, 128, 256) == 56
    assert ops.stage_rows(3072, 64, 128) == 64 and ops.stage_rows(100, 128, 128) == 104
    assert ops.stage_rows(3, 128, 1024) == 8
    for s, ct, bw in [(3072, 128, 256), (3072, 1 << 20, 32), (64, 128, 1024)]:
        assert ops.smem_bytes(ops.stage_rows(s, ct, bw), bw) <= ops.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block(seed=0):
    """The JAX smoke config's block params, as numpy and as the port's."""
    jc = jax_get_smoke_config("recurrentgemma-2b")
    pc = get_smoke_config("recurrentgemma-2b")
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(seed), jc)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jc, pc, jp, tp


def _state(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    return {"h": (rng.standard_normal((batch, w)) * 0.5).astype(np.float32),
            "conv": (rng.standard_normal((batch, cfg.conv_width - 1, w)) * 0.5).astype(np.float32)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rglru_block_train_matches_jax(use_kernel, carried):
    jc, pc, jp, tp = _block()
    x = (np.random.default_rng(3).standard_normal((2, 64, jc.d_model)) * 0.5).astype(np.float32)
    js, ts = _both(_state(jc, 2, 4)) if carried else (None, None)
    jy, jst = jax_rglru.rglru_block_train(jc, jp, jnp.asarray(x), js)
    ty, tst = rglru.rglru_block_train(pc, tp, torch.from_numpy(x), ts, use_kernel=use_kernel)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    for name in ("h", "conv"):
        assert tst[name].dtype == torch.float32
        np.testing.assert_allclose(_np(tst[name]), _np(jst[name]), err_msg=name, **BLOCK_TOL)


def test_rglru_scan_matches_the_sequential_recurrence():
    """The doubling scan against the plain loop, with a carried state and a
    length that is not a power of two."""
    _, _, _, tp = _block()
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((2, 37, 64)) * 0.5).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    y, h_last = rglru.rglru_scan(tp, x, h0)
    a, b = rglru._gates(tp, x)
    b[:, 0] += a[:, 0] * h0
    ref = linear_recurrence_ref(a, b)
    np.testing.assert_allclose(_np(y), _np(ref), **SCAN_TOL)
    assert torch.equal(h_last, y[:, -1])


def test_rglru_block_step_matches_jax():
    jc, pc, jp, tp = _block(1)
    x = (np.random.default_rng(6).standard_normal((3, 1, jc.d_model)) * 0.5).astype(np.float32)
    js, ts = _both(_state(jc, 3, 7))
    jy, jst = jax_rglru.rglru_block_step(jc, jp, jnp.asarray(x), js)
    ty, tst = rglru.rglru_block_step(pc, tp, torch.from_numpy(x), ts)
    assert ty.shape == (3, 1, jc.d_model)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[name]), _np(jst[name]), err_msg=name, **BLOCK_TOL)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv_matches_jax(with_prefix):
    jc, _, jp, tp = _block(2)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, jc.lru_width)).astype(np.float32)
    prefix = rng.standard_normal((2, jc.conv_width - 1, jc.lru_width)).astype(np.float32)
    jo, jt = jax_rglru._causal_conv(jp, jnp.asarray(x), jnp.asarray(prefix) if with_prefix else None)
    to, tt = rglru._causal_conv(tp, torch.from_numpy(x), torch.from_numpy(prefix) if with_prefix else None)
    np.testing.assert_allclose(_np(to), _np(jo), **BLOCK_TOL)
    np.testing.assert_allclose(_np(tt), _np(jt), **BLOCK_TOL)


def test_init_rglru_block_shapes_and_decay_range():
    jc, pc, jp, _ = _block()
    tp = rglru.init_rglru_block(pc, generator=torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    a = torch.exp(-rglru.C_RGLRU * torch.nn.functional.softplus(tp["lambda"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
    state = rglru.init_rglru_state(pc, 2, "cpu")
    jstate = jax_rglru.init_rglru_state(jc, 2)
    for name in ("h", "conv"):
        assert tuple(state[name].shape) == jstate[name].shape and state[name].dtype == torch.float32


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", CASES)
def test_rglru_kernel_matches_plain_on_card(cuda, b, s, w):
    a, bb = (torch.from_numpy(x).to(cuda) for x in _ab(b, s, w, seed=1))
    before = linear_recurrence.launches
    out = linear_recurrence(a, bb, chunk_t=32, block_w=128)
    assert linear_recurrence.launches == before + 1
    np.testing.assert_allclose(_np(out.cpu()), _np(linear_recurrence_ref(a, bb).cpu()), **SCAN_TOL)


@pytest.mark.cuda
def test_rglru_kernel_is_bitwise_invariant_to_tiling(cuda):
    a, b = (torch.from_numpy(x).to(cuda) for x in _ab(2, 128, 256, seed=2))
    outs = [linear_recurrence(a, b, chunk_t=ct, block_w=bw) for ct, bw in [(8, 128), (64, 128), (128, 256)]]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_rglru_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(1, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        linear_recurrence(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        linear_recurrence(a.transpose(1, 2), a.transpose(1, 2))


@pytest.mark.cuda
def test_rglru_block_kernel_path_matches_plain_path_on_card(cuda):
    _, pc, _, tp = _block()
    tp = {k: v.to(cuda) for k, v in tp.items()}
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 64, pc.d_model)) * 0.5)
                         .astype(np.float32)).to(cuda)
    cfg = dataclasses.replace(pc, dtype="float32")
    y0, s0 = rglru.rglru_block_train(cfg, tp, x, use_kernel=False)
    y1, s1 = rglru.rglru_block_train(cfg, tp, x, use_kernel=True)
    np.testing.assert_allclose(_np(y1.cpu()), _np(y0.cpu()), **BLOCK_TOL)
    np.testing.assert_allclose(_np(s1["h"].cpu()), _np(s0["h"].cpu()), **BLOCK_TOL)
