"""The port's attention kernels held against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions and the JAX
side runs its Pallas kernels in interpret mode, as ``test_kernels.py`` runs
them.  Inputs are made with numpy from a seed and handed to both.  Tests
marked ``cuda`` run the CUDA kernels against the plain versions on a card
and skip without one.
"""
import importlib.util
from pathlib import Path

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
    # head_dim 128, one and eight query heads per KV head, with a window
    (1, 128, 128, 8, 8, 128, 32, 0),
    (1, 128, 128, 8, 1, 128, 32, 0),
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
# head dim 256 (recurrentgemma's local attention) and shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,window", [(64, 16), (100, 0)])
def test_flash_attention_head_dim_256_matches_jax(s, window):
    arrays = _inputs(10, [(1, s, 10, 256), (1, s, 1, 256), (1, s, 1, 256)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.float32)
    ref = jax_flash_attention(jq, jk, jv, causal=True, window=window, block_q=64, block_kv=64)
    out = flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), **F32_TOL)


def test_decode_attention_head_dim_256_matches_jax():
    arrays = _inputs(11, [(2, 10, 256), (2, 48, 1, 256), (2, 48, 1, 256)], [0.5, 0.5, 1.0])
    (jq, jk, jv), (q, k, v) = _to(arrays, torch.float32)
    lengths = np.asarray([48, 17], np.int32)
    ref = jax_decode_attention(jq, jk, jv, jnp.asarray(lengths))
    out = decode_attention(q, k, v, torch.from_numpy(lengths), spec=PrefetchSpec(3, 1, 2))
    np.testing.assert_allclose(_f32(out), _f32(ref), **F32_TOL)


def test_attention_refuses_what_does_not_fit_shared_memory_on_every_device():
    """A ring or tile over the 232,448 bytes a block may use raises
    ``ValueError`` before any launch, on the CPU too."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    assert fa.smem_bytes(256) == 197_672 <= fa.SMEM_LIMIT < fa.smem_bytes(512)
    assert da.smem_bytes(256, 3) == 3 * 65_536 + 768 + 8_192 <= da.SMEM_LIMIT < da.smem_bytes(256, 4)
    q, k = torch.zeros(1, 10, 256), torch.zeros(1, 64, 1, 256)
    one = torch.ones(1, dtype=torch.int32)
    assert decode_attention(q, k, k, one, spec=PrefetchSpec(3, 1, 2)).shape == q.shape
    with pytest.raises(ValueError, match="at most 3 stages"):
        decode_attention(q, k, k, one, spec=PrefetchSpec(4, 1, 3))
    with pytest.raises(ValueError, match="232448"):
        flash_attention(torch.zeros(1, 8, 2, 512), torch.zeros(1, 8, 1, 512), torch.zeros(1, 8, 1, 512))


def test_flash_smem_bytes_counts_what_the_kernel_takes():
    """The alignment pad (1024), the bf16 q tile of two warpgroups of 64
    rows, 4 / 3 / 2 stages of 64 keys of K and V at head dim 64 / 128 / 256,
    and an 8-byte mbarrier for q and two per stage."""
    from repro_torch.kernels.flash_attention import ops as fa

    for h, stages in zip(fa.HEAD_DIMS, (4, 3, 2)):
        assert fa.smem_bytes(h) == 1024 + 2 * 64 * h * 2 + stages * (2 * 64 * h * 2) + 8 * (1 + 2 * stages)
    assert [fa.smem_bytes(h) for h in fa.HEAD_DIMS] == [83_016, 132_152, 197_672]


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
    assert _build.sources() == ["decode_attention", "flash_attention", "rglru_scan", "streamed_matmul"]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_fault_check_plants_each_fault_on_one_kernel_line():
    """``fault_check.py`` edits one line of a kernel source per fault: the
    line must stand exactly once in the source it names."""
    path = Path(__file__).resolve().parents[1] / "fault_check.py"
    spec = importlib.util.spec_from_file_location("fault_check", path)
    fault_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fault_check)
    assert fault_check.FAULTS
    for source, line, planted in fault_check.FAULTS.values():
        assert (_build.CSRC / source).read_text().count(line) == 1
        assert planted != line


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


# (G, H): every head dim of the kernel, over 1 to 10 query heads per KV head
FLASH_GROUPS = [(1, 128), (3, 64), (5, 64), (8, 128), (10, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100, 2048])
@pytest.mark.parametrize("g,h", FLASH_GROUPS)
def test_flash_kernel_groups_and_windows_on_card(cuda, g, h, window):
    kh = 1 if g == 10 else 2
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(12, [(2, 300, g * kh, h), (2, 300, kh, h), (2, 300, kh, h)], [0.5, 0.5, 1.0]))
    out = flash_attention(q, k, v, window=window)
    ref = attention_ref(q, k, v, window=window)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,n,kh,h,window,qo", [
    (2, 100, 164, 10, 1, 256, 0, 64),      # q_offset > 0: the cache holds 64 earlier keys
    (1, 300, 200, 8, 2, 128, 0, 0),        # T < S: keys past T are padding
    (1, 2200, 2200, 10, 1, 256, 2048, 0),  # the window cuts the prefix
    (2, 70, 70, 3, 1, 64, 16, 33),
])
def test_flash_kernel_offsets_and_short_keys_on_card(cuda, b, s, t, n, kh, h, window, qo):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(13, [(b, s, n, h), (b, t, kh, h), (b, t, kh, h)], [0.5, 0.5, 1.0]))
    out = flash_attention(q, k, v, window=window, q_offset=qo)
    ref = attention_ref(q, k, v, window=window, q_offset=qo)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,n,kh,h,window", [(100, 128, 8, 2, 64, 0), (100, 192, 10, 1, 256, 50)])
def test_flash_kernel_non_causal_on_card(cuda, s, t, n, kh, h, window):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(15, [(1, s, n, h), (1, t, kh, h), (1, t, kh, h)], [0.5, 0.5, 1.0]))
    out = flash_attention(q, k, v, causal=False, window=window)
    ref = attention_ref(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 128, 256])
def test_flash_kernel_fully_masked_rows_give_zero_on_card(cuda, h):
    """Queries past the window of every key give 0; the rest as the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(14, [(1, 8, 2, h), (1, 8, 1, h), (1, 8, 1, h)], [0.5, 0.5, 1.0]))
    assert torch.count_nonzero(flash_attention(q, k, v, window=4, q_offset=16)) == 0
    out = flash_attention(q, k, v, window=4, q_offset=6)  # query 0 sees keys 3..6, 5..7 none
    ref = attention_ref(q, k, v, window=4, q_offset=6)
    assert torch.count_nonzero(out[:, 5:]) == 0 and torch.count_nonzero(out[:, :1]) > 0
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
    with pytest.raises(ValueError, match="232448"):  # a ring deeper than shared memory
        decode_attention(qb[:, 0], qb[:, :, :2].contiguous(), qb[:, :, :2].contiguous(),
                         torch.ones(1, dtype=torch.int32, device=cuda),
                         spec=PrefetchSpec(buffer_size=20, distance=3))
