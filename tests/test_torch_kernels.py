"""The port's attention kernels held against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions and the JAX
side runs its Pallas kernels in interpret mode, as ``test_kernels.py`` runs
them.  Inputs are made with numpy from a seed and handed to both.  Tests
marked ``cuda`` run the CUDA kernels against the plain versions on a card
and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.core.refspec import PrefetchSpec as JaxPrefetchSpec
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import AUTO, ON_DEMAND, PrefetchSpec
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_paged,
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

#: the JAX package's tolerances: attention kernels vs oracle in f32
#: (test_kernels.py:93) and bf16 (test_kernels.py:_tol)
F32_TOL = dict(rtol=1e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, shapes, scales):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * c).astype(np.float32) for s, c in zip(shapes, scales)]


def _to(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(dtype) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FA_CASES = [
    # (B, S, T, N, KH, H, window, q_offset): a subset of test_kernels.FA_CASES
    (2, 128, 128, 4, 4, 64, 0, 0),
    (1, 256, 256, 8, 2, 64, 0, 0),
    (1, 256, 256, 4, 2, 64, 64, 0),
    (1, 100, 100, 4, 4, 64, 0, 0),
    (2, 64, 192, 4, 2, 64, 0, 128),
    (1, 128, 128, 10, 5, 64, 0, 0),
]


@pytest.mark.parametrize("b,s,t,n,kh,h,window,qo", FA_CASES)
def test_flash_attention_matches_jax(b, s, t, n, kh, h, window, qo):
    arrays = _inputs(0, [(b, s, n, h), (b, t, kh, h), (b, t, kh, h)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.float32)
    ref = jax_flash_attention(jq, jk, jv, causal=True, window=window, q_offset=qo,
                              block_q=64, block_kv=64)
    out = flash_attention(q, k, v, causal=True, window=window, q_offset=qo)
    np.testing.assert_allclose(_f32(out), _f32(ref), **F32_TOL)


def test_flash_attention_bf16_matches_jax():
    arrays = _inputs(1, [(1, 128, 6, 64), (1, 128, 2, 64), (1, 128, 2, 64)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.bfloat16)
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(jax_flash_attention(jq, jk, jv)), **BF16_TOL)


def test_flash_attention_fully_masked_rows_give_zero():
    """Queries past the window of every key give 0, as the TPU kernel."""
    arrays = _inputs(2, [(1, 8, 2, 64), (1, 8, 1, 64), (1, 8, 1, 64)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.float32)
    out = flash_attention(q, k, v, window=4, q_offset=16)
    ref = jax_flash_attention(jq, jk, jv, window=4, q_offset=16)
    assert torch.count_nonzero(out) == 0
    np.testing.assert_allclose(_f32(out), _f32(ref), **F32_TOL)


def test_flash_attention_contract_errors():
    q, k = torch.zeros(1, 8, 4, 64), torch.zeros(1, 100, 2, 64)
    with pytest.raises(NotImplementedError, match="block-aligned"):
        flash_attention(q, k, k, causal=False)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DA_CASES = [  # test_kernels.DA_CASES
    (2, 512, 4, 4, 64, [512, 300]),
    (2, 1024, 8, 2, 64, [1, 777]),
    (1, 300, 4, 1, 128, [300]),
    (2, 2048, 8, 4, 128, [2048, 100]),
    (1, 256, 10, 5, 64, [129]),
]


@pytest.mark.parametrize("b,t,n,kh,h,lens", DA_CASES)
def test_decode_attention_matches_jax(b, t, n, kh, h, lens):
    arrays = _inputs(3, [(b, n, h), (b, t, kh, h), (b, t, kh, h)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.float32)
    lengths = np.asarray(lens, np.int32)
    ref = jax_decode_attention(jq, jk, jv, jnp.asarray(lengths), block_kv=128)
    out = decode_attention(q, k, v, torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(out), _f32(ref), **F32_TOL)


def test_decode_attention_bf16_matches_jax():
    arrays = _inputs(4, [(2, 15, 64), (2, 300, 5, 64), (2, 300, 5, 64)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.bfloat16)
    lengths = np.asarray([300, 41], np.int32)
    ref = jax_decode_attention(jq, jk, jv, jnp.asarray(lengths))
    out = decode_attention(q, k, v, torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(out), _f32(ref), **BF16_TOL)


def test_decode_attention_zero_length_gives_zero():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, [(2, 4, 64), (2, 64, 2, 64), (2, 64, 2, 64)],
                                                     [0.5, 0.5, 1.0]))
    out = decode_attention(q, k, v, torch.tensor([0, 64], dtype=torch.int32))
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[1]) > 0


@pytest.mark.parametrize("page_len", [16, 64])
def test_decode_attention_paged_equals_dense(page_len):
    b, t, n, kh, h = 2, 256, 8, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, [(b, n, h), (b, t, kh, h), (b, t, kh, h)],
                                                     [0.5, 0.5, 1.0]))
    lengths = torch.tensor([256, 77], dtype=torch.int32)
    dense = decode_attention(q, k, v, lengths)
    paged = decode_attention_paged(q, k.split(page_len, dim=1), v.split(page_len, dim=1), lengths)
    assert torch.equal(dense, paged)
    with pytest.raises(ValueError):
        decode_attention_paged(q, [], [], lengths)


def test_decode_matches_flash_single_token():
    """Cross-kernel: decode(q_last) == flash(full prefix)[:, -1]."""
    b, t, n, kh, h = 1, 256, 4, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, [(b, t, n, h), (b, t, kh, h), (b, t, kh, h)],
                                                     [0.5, 0.5, 1.0]))
    full = flash_attention(q, k, v, causal=True)
    one = decode_attention(q[:, -1], k, v, torch.tensor([t], dtype=torch.int32))
    np.testing.assert_allclose(_f32(one), _f32(full[:, -1]), **F32_TOL)


# ---------------------------------------------------------------------------
# PrefetchSpec and the ring
# ---------------------------------------------------------------------------

BAD_SPECS = [
    dict(buffer_size=0),
    dict(elements_per_fetch=0),
    dict(distance=-1),
    dict(distance="soon"),
    dict(access="wo"),
    dict(buffer_size=2, elements_per_fetch=1, distance=3),
]


@pytest.mark.parametrize("kwargs", BAD_SPECS)
def test_prefetch_spec_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError) as jax_err:
        JaxPrefetchSpec(**kwargs)
    with pytest.raises(ValueError) as port_err:
        PrefetchSpec(**kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kwargs", [dict(), dict(buffer_size=5, distance=AUTO),
                                    dict(buffer_size=1, distance=0), dict(access="rw")])
def test_prefetch_spec_fields_match_jax(kwargs):
    j, p = JaxPrefetchSpec(**kwargs), PrefetchSpec(**kwargs)
    for attr in ("buffer_size", "elements_per_fetch", "distance", "access", "is_auto", "on_demand"):
        assert getattr(p, attr) == getattr(j, attr)
    assert p.numeric_distance(3) == j.numeric_distance(3)
    assert ON_DEMAND.on_demand


def test_static_auto_distance_matches_jax():
    for n in range(0, 12):
        assert static_auto_distance(n) == jax_engine.static_auto_distance(n)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler is no silent fallback: the build raises."""
    assert _build.sources() == ["decode_attention", "flash_attention", "streamed_matmul"]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,n,kh,h,window,qo", FA_CASES + [(1, 512, 512, 15, 5, 64, 0, 0)])
def test_flash_kernel_matches_plain_on_card(cuda, b, s, t, n, kh, h, window, qo):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(8, [(b, s, n, h), (b, t, kh, h), (b, t, kh, h)], [0.5, 0.5, 1.0]))
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, q_offset=qo)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, window=window, q_offset=qo)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n,kh,h,lens", DA_CASES + [(4, 544, 15, 5, 64, [544, 300, 77, 1])])
def test_decode_kernel_matches_plain_on_card(cuda, b, t, n, kh, h, lens):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(9, [(b, n, h), (b, t, kh, h), (b, t, kh, h)], [0.5, 0.5, 1.0]))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths)
    ref = decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), **BF16_TOL)
    for spec in (PrefetchSpec(1, 1, 0), PrefetchSpec(4, 1, 3), PrefetchSpec(5, distance=AUTO)):
        assert torch.equal(decode_attention(q, k, v, lengths, spec=spec), out)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])  # float32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(qb, qb[:, :, :2], qb[:, :, :2])
    with pytest.raises(RuntimeError, match="CUDA error"):  # a ring deeper than shared memory
        decode_attention(qb[:, 0], qb[:, :, :2].contiguous(), qb[:, :, :2].contiguous(),
                         torch.ones(1, dtype=torch.int32, device=cuda),
                         spec=PrefetchSpec(buffer_size=20, distance=3))
