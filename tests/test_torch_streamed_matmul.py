"""The port's streamed matmul held against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version and the JAX
side runs its Pallas kernel in interpret mode, as ``test_kernels.py`` runs
it; inputs are made with numpy from a seed and handed to both, at the JAX
tests' shapes and tolerances (``_tol``: bf16 2e-2, f32 rtol 2e-4 / atol
2e-3).  Tests marked ``cuda`` hold the CUDA kernel against the plain
version on a card, bit for bit across rings, and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.refspec import PrefetchSpec as JaxPrefetchSpec
from repro.kernels.streamed_matmul import streamed_matmul as jax_streamed_matmul
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.kernels.streamed_matmul import matmul_ref, ops, streamed_matmul

MM_SHAPES = [(128, 256, 128), (64, 100, 200), (7, 384, 512), (1, 128, 128), (130, 130, 130)]
RINGS = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 4)]  # test_kernels.py (distance, slots)
DTYPES = [torch.float32, torch.bfloat16]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-3)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(dtype) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_matmul_matches_jax(m, k, n, dtype):
    (jx, jw), (x, w) = _both(_inputs(0, (m, k), (k, n)), dtype)
    out = streamed_matmul(x, w)
    assert out.dtype == dtype and out.shape == (m, n)
    np.testing.assert_allclose(_f32(out), _f32(jax_streamed_matmul(jx, jw)), **_tol(dtype))


def test_streamed_matmul_batched_matches_jax():
    (jx, jw), (x, w) = _both(_inputs(1, (2, 3, 32, 96), (96, 64)), torch.float32)
    out = streamed_matmul(x, w)
    assert out.shape == (2, 3, 32, 64)
    np.testing.assert_allclose(_f32(out), _f32(jax_streamed_matmul(jx, jw)), rtol=1e-4, atol=1e-3)


def test_streamed_matmul_auto_matches_jax():
    (jx, jw), (x, w) = _both(_inputs(2, (64, 256), (256, 192)), torch.float32)
    ref = jax_streamed_matmul(jx, jw, spec=JaxPrefetchSpec(buffer_size=5, distance="auto"))
    out = streamed_matmul(x, w, spec=PrefetchSpec(buffer_size=5, distance=AUTO))
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(torch.float32))


@pytest.mark.parametrize("dist,slots", RINGS)
def test_streamed_matmul_prefetch_invariance(dist, slots):
    """Paper §3.1: prefetch settings never change the value."""
    _, (x, w) = _both(_inputs(3, (64, 256), (256, 192)), torch.float32)
    base = streamed_matmul(x, w, spec=PrefetchSpec(1, 1, 0))
    assert torch.equal(streamed_matmul(x, w, spec=PrefetchSpec(slots, 1, dist)), base)


def test_matmul_ref_accumulates_in_f32():
    _, (x, w) = _both(_inputs(4, (16, 512), (512, 8)), torch.bfloat16)
    want = (x.float() @ w.float()).to(torch.bfloat16)
    assert torch.equal(matmul_ref(x, w), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_that_does_not_fit_raises(dtype):
    """A ring deeper than shared memory holds is refused, never clamped."""
    most = ops.SMEM_LIMIT // ops.stage_bytes(dtype)
    assert most >= 10  # the repo's deepest spec (quickstart listing 2) fits
    _, (x, w) = _both(_inputs(5, (8, 64), (64, 8)), dtype)
    streamed_matmul(x, w, spec=PrefetchSpec(buffer_size=most, distance=1))
    with pytest.raises(ValueError, match=f"{ops.SMEM_LIMIT} bytes"):
        streamed_matmul(x, w, spec=PrefetchSpec(buffer_size=most + 1, distance=1))


def test_lookahead_past_the_wait_switch_raises():
    _, (x, w) = _both(_inputs(6, (8, 64), (64, 8)), torch.bfloat16)
    spec = PrefetchSpec(buffer_size=ops.MAX_DISTANCE + 2, distance=ops.MAX_DISTANCE + 1)
    with pytest.raises(ValueError, match="lookahead"):
        streamed_matmul(x, w, spec=spec)


def test_ring_resolution():
    """``(distance, slots)`` as the TPU kernel resolves them, over the
    kernel's own K tiles; "auto" through static_auto_distance."""
    assert ops.ring_of(PrefetchSpec(1, 1, 0), 256, torch.float32) == (0, 1)
    assert ops.ring_of(PrefetchSpec(3, 1, 3), 256, torch.float32) == (3, 4)
    assert ops.ring_of(PrefetchSpec(5, 1, AUTO), 256, torch.float32) == (4, 5)  # 8 tiles
    assert ops.ring_of(PrefetchSpec(2, 1, AUTO), 64, torch.float32) == (1, 2)  # 2 tiles


def test_contract_errors():
    x, w = torch.zeros(4, 8), torch.zeros(8, 2)
    with pytest.raises(TypeError):
        streamed_matmul(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError):
        streamed_matmul(x.double(), w.double())
    with pytest.raises(ValueError):
        streamed_matmul(x, torch.zeros(7, 2))
    with pytest.raises(ValueError):
        streamed_matmul(x, w, block_k=0)
    before = streamed_matmul.launches
    streamed_matmul(x, w)
    assert streamed_matmul.launches == before  # the plain version is no launch


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_SHAPES + [(2048, 960, 2560), (2048, 2560, 960)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_matmul_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in _inputs(7, (m, k), (k, n)))
    before = streamed_matmul.launches
    out = streamed_matmul(x, w)
    assert streamed_matmul.launches == before + 1
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(dtype))
    specs = [PrefetchSpec(slots, 1, dist) for dist, slots in RINGS] + [PrefetchSpec(5, 1, AUTO)]
    for spec in specs:
        assert torch.equal(streamed_matmul(x, w, spec=spec), out)


@pytest.mark.cuda
def test_streamed_matmul_kernel_batched_and_stage_bytes_on_card(cuda):
    from repro_torch.kernels import _build

    lib = _build.load("streamed_matmul", ops._SIGNATURES)
    assert lib.repro_streamed_matmul_stage_bytes(0) == ops.stage_bytes(torch.float32)
    assert lib.repro_streamed_matmul_stage_bytes(1) == ops.stage_bytes(torch.bfloat16)
    x, w = (torch.from_numpy(a).to(cuda) for a in _inputs(8, (2, 3, 32, 96), (96, 64)))
    out = streamed_matmul(x, w)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        streamed_matmul(x, w, spec=PrefetchSpec(buffer_size=20, distance=1))
    xb = torch.zeros(4, 7, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        streamed_matmul(xb, torch.zeros(7, 8, device=cuda, dtype=torch.bfloat16))
