"""The port's streamed matmul held against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version and the JAX
side runs its Pallas kernel in interpret mode, as ``test_kernels.py`` runs
it; inputs are made with numpy from a seed and handed to both, at the JAX
tests' shapes and tolerances (``_tol``: bf16 2e-2, f32 rtol 2e-4 / atol
2e-3).  Tests marked ``cuda`` hold the CUDA kernel against the plain
version on a card, bit for bit across rings, and skip without one.
"""
import importlib.util
import inspect
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.refspec import PrefetchSpec as JaxPrefetchSpec
from repro.kernels.streamed_matmul import streamed_matmul as jax_streamed_matmul
from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.kernels.streamed_matmul import matmul_ref, ops, streamed_matmul

MM_SHAPES = [(128, 256, 128), (64, 100, 200), (7, 384, 512), (1, 128, 128), (130, 130, 130)]
RINGS = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 4)]  # test_kernels.py (distance, slots)
DTYPES = [torch.float32, torch.bfloat16]
#: the deepest ring the repo asks for in each dtype: f32 quickstart listing 2's
#: buffer_size 10; bf16 chip_smoke.py's PrefetchSpec(5, 1, AUTO) at the MLP shapes
DEEPEST_RING = {torch.float32: 10, torch.bfloat16: 5}


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
    most = ops.max_slots(dtype)
    assert most >= DEEPEST_RING[dtype]  # the repo's deepest spec of the dtype fits
    assert ops.ring_bytes(dtype, most) <= ops.SMEM_LIMIT < ops.ring_bytes(dtype, most + 1)
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


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_route_follows_dtype_and_alignment(m, k, n, dtype):
    """bf16 with K and N multiples of 8 (16-byte rows for TMA) takes the
    tensor cores; f32, and bf16 of other strides, the CUDA cores."""
    _, (x, w) = _both(_inputs(9, (m, k), (k, n)), dtype)
    tensor_cores = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
    assert ops.route(x, w) == ("tensor_cores" if tensor_cores else "cuda_cores")


def test_route_needs_16_byte_aligned_pointers():
    _, (x, w) = _both(_inputs(10, (64, 64), (64, 64)), torch.bfloat16)
    assert ops.route(x, w) == "tensor_cores"
    shifted = torch.zeros(4 + 64 * 64, dtype=torch.bfloat16)[4:].view(64, 64)  # 8 bytes off
    assert shifted.data_ptr() % 16 == 8
    assert ops.route(shifted, w) == ops.route(x, shifted) == "cuda_cores"
    assert ops.route(x[:, :0], w[:0]) == "cuda_cores"  # K = 0: no tile to load


def test_stage_and_ring_bytes():
    """One ring stage per dtype: f32 the f32 route's tile (64 x 32 of x,
    32 x 64 of w, x's rows swizzled in place, not padded), bf16 the
    tensor-core tile (128 x 64 of x, 64 x 128 of w); each ring adds its
    1024-byte alignment pad and its 8-byte mbarriers: two a stage in f32
    (full, empty), one in bf16."""
    assert ops.stage_bytes(torch.float32) == (64 * 32 + 32 * 64) * 4 == 16_384
    assert ops.stage_bytes(torch.bfloat16) == (128 * 64 + 64 * 128) * 2 == 32_768
    assert ops.ring_bytes(torch.float32, 13) == 1024 + 13 * (16_384 + 16) == 214_224
    assert ops.ring_bytes(torch.bfloat16, 7) == 1024 + 7 * (32_768 + 8) == 230_456
    assert (ops.max_slots(torch.float32), ops.max_slots(torch.bfloat16)) == (14, 7)


@pytest.mark.parametrize("k", [960, 2560])
def test_ring_of_counts_the_dtypes_k_tiles(k):
    """``"auto"`` resolves from the tile count of the dtype's route: bf16
    k-tiles of 64, f32 of 32."""
    spec = PrefetchSpec(5, 1, AUTO)
    bf16 = static_auto_distance(-(-k // ops.TC_BLOCK_K))
    f32 = static_auto_distance(-(-k // ops.BLOCK_K))
    assert ops.ring_of(spec, k, torch.bfloat16) == (bf16, max(5, bf16 + 1))
    assert ops.ring_of(spec, k, torch.float32) == (f32, max(5, f32 + 1))


# every ring the repo asks for: chip_smoke.py's six (f32 at K = 256, bf16 at
# smollm-360m's MLP reductions), quickstart listing 4, the 512^3 f32 sweep
REPO_RINGS = (
    [(PrefetchSpec(s, 1, d), 256, torch.float32) for d, s in RINGS]
    + [(PrefetchSpec(s, 1, d), k, torch.bfloat16) for d, s in RINGS for k in (960, 2560)]
    + [(PrefetchSpec(5, 1, AUTO), k, dt) for k, dt in ((256, torch.float32), (960, torch.bfloat16),
                                                         (2560, torch.bfloat16))]
    + [(PrefetchSpec(3, 1, 2), 512, torch.float32)]
    + [(PrefetchSpec(s, 1, d), 512, torch.float32) for d, s in [(0, 1), (1, 2), (2, 3), (4, 5)]]
)


@pytest.mark.parametrize("spec,k,dtype", REPO_RINGS)
def test_every_ring_the_repo_asks_for_fits(spec, k, dtype):
    distance, slots = ops.ring_of(spec, k, dtype)
    assert slots <= ops.max_slots(dtype)
    deeper = PrefetchSpec(ops.max_slots(dtype) + 1, 1, distance)
    with pytest.raises(ValueError, match=f"at most {ops.max_slots(dtype)} stages"):
        ops.ring_of(deeper, k, dtype)


# ---------------------------------------------------------------------------
# the f32 route's split of K
# ---------------------------------------------------------------------------

#: K (and, for the plan alone, N) at the edges of a k-tile and of a split
_EDGES = (0, 1, ops.BLOCK_K - 1, ops.BLOCK_K, ops.BLOCK_K + 1, ops.MIN_SPLIT_KT * ops.BLOCK_K,
          2 * ops.MIN_SPLIT_KT * ops.BLOCK_K + 1)
#: shapes (M, K, N) whose plans are held: the JAX tests', the sweep's 512^3,
#: quickstart listing 4, chip_smoke's bitwise shape, and K at the edges
PLAN_SHAPES = MM_SHAPES + [
    (512, 512, 512), (256, 512, 256), (64, 256, 192), (2048, 2048, 1), (3, 5, 100_000),
] + [(130, k, 70) for k in _EDGES]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES + [(130, 70, n) for n in _EDGES])
def test_split_plan_takes_every_k_tile_once_in_order(m, k, n):
    """The splits are runs of whole k-tiles: together, in split order, they
    are the k-tiles 0, 1, ..., each once; no split is empty but at K = 0."""
    plan = ops.split_plan(m, n, k)
    runs = plan.k_tiles(k)
    n_kt = -(-k // ops.BLOCK_K)
    assert plan.splits == len(runs) >= 1
    assert [t for run in runs for t in run] == list(range(n_kt))
    assert all(len(run) == plan.tiles_per_split for run in runs[:-1])
    assert all(len(run) >= 1 for run in runs) or n_kt == 0
    assert all(len(run) >= min(ops.MIN_SPLIT_KT, n_kt) for run in runs[:-1])
    # each run starts on a k-tile boundary of the reduction: k = BLOCK_K * t
    assert [run.start * ops.BLOCK_K for run in runs] == [s * plan.tiles_per_split * ops.BLOCK_K
                                                        for s in range(plan.splits)]
    assert plan.tile == (ops.BLOCK_M, ops.BLOCK_N)
    assert plan.grid == (-(-m // ops.BLOCK_M), -(-n // ops.BLOCK_N), plan.splits)


def test_split_plan_is_the_same_for_every_ring():
    """The plan is a function of (M, N, K) alone: no ring can reach it and
    change the order of the sum."""
    assert list(inspect.signature(ops.split_plan).parameters) == ["m", "n", "k"]


def test_split_plan_fills_the_card():
    """At the sweep's 512^3 the blocks fill at least one wave of the H100's
    132 SMs; at listing 4's 256 x 512 x 256 more blocks run than its 16
    output tiles; short K is not split."""
    big = ops.split_plan(512, 512, 512)
    assert math.prod(big.grid) >= 132 and big.splits > 1
    listing4 = ops.split_plan(256, 256, 512)
    assert math.prod(listing4.grid) > (256 // 64) * (256 // 64)
    assert ops.split_plan(130, 130, ops.MIN_SPLIT_KT * ops.BLOCK_K).splits == 1


@pytest.mark.parametrize("k", [0, 1, ops.BLOCK_K - 1, ops.BLOCK_K, ops.BLOCK_K + 1])
def test_split_plan_and_deepest_ring_at_k_edges(k):
    """At K = 0, 1, BK - 1, BK, BK + 1 the plan is one split holding every
    k-tile, and the f32 ring of 10 (listing 2) still fits."""
    plan = ops.split_plan(64, 64, k)
    assert plan.splits == 1 and [list(r) for r in plan.k_tiles(k)] == [list(range(-(-k // ops.BLOCK_K)))]
    distance, slots = ops.ring_of(PrefetchSpec(DEEPEST_RING[torch.float32], 1, 1), k, torch.float32)
    assert (distance, slots) == (1, 10)
    assert ops.ring_bytes(torch.float32, slots) <= ops.SMEM_LIMIT
    assert ops.stage_bytes(torch.float32) < ops.SMEM_LIMIT // 10


def test_uses_tma_follows_strides_and_alignment():
    """The f32 route fills its stages by TMA where K and N are multiples of
    4 and both pointers 16-byte aligned; by cp.async otherwise."""
    _, (x, w) = _both(_inputs(14, (8, 64), (64, 12)), torch.float32)
    assert ops.uses_tma(x, w)
    assert not ops.uses_tma(x[:, :62].contiguous(), w[:62])  # K % 4
    assert not ops.uses_tma(x, w[:, :10].contiguous())  # N % 4
    shifted = torch.zeros(1 + 64 * 12)[1:].view(64, 12)  # 4 bytes off
    assert shifted.data_ptr() % 16 == 4 and not ops.uses_tma(x, shifted)
    assert not ops.uses_tma(x[:, :0], w[:0])  # K = 0: no tile to load


@pytest.mark.parametrize("script", ["fault_check.py", "matmul_tile_sweep.py"])
def test_matmul_tools_edit_lines_that_stand_once(script):
    """``fault_check.py`` plants the f32 route's faults and
    ``matmul_tile_sweep.py`` sets its tile and plan by editing copies line by
    line: each line must stand once in the file it edits."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(Path(script).stem, root / script)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    if script == "fault_check.py":
        edits = [(f"csrc/{src}", line) for name, (src, line, _) in tool.FAULTS.items() if "f32" in name]
        assert len(edits) == 2
    else:
        edits = [(rel, line) for variant in tool.VARIANTS.values() for rel, line, _ in variant]
        assert len(tool.VARIANTS) >= 3
    for rel, line in edits:
        assert (root / "src" / "repro_torch" / rel).read_text().count(line) == 1, (script, line)


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
    splits = ops.split_plan(m, n, k).splits if dtype == torch.float32 else 1
    assert streamed_matmul.launches == before + (2 if splits > 1 else 1)  # the combine counts
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(dtype))
    specs = [PrefetchSpec(slots, 1, dist) for dist, slots in RINGS] + [PrefetchSpec(5, 1, AUTO)]
    for spec in specs:
        assert torch.equal(streamed_matmul(x, w, spec=spec), out)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(200, 968, 264), (2048, 960, 2560), (2048, 2560, 960)])
def test_tensor_core_route_bitwise_across_rings_on_card(cuda, m, k, n):
    """M, N and K that are not multiples of the 128 x 128 x 64 tile: TMA
    zero-fills the edges, the epilogue masks; every ring gives the same bits."""
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(11, (m, k), (k, n)))
    assert ops.route(x, w) == "tensor_cores"
    before, before_tc = streamed_matmul.launches, streamed_matmul.launches_tc
    out = streamed_matmul(x, w)
    assert (streamed_matmul.launches, streamed_matmul.launches_tc) == (before + 1, before_tc + 1)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(torch.bfloat16))
    specs = [PrefetchSpec(slots, 1, dist) for dist, slots in RINGS]
    specs += [PrefetchSpec(5, 1, AUTO), PrefetchSpec(ops.max_slots(torch.bfloat16), 1, 1)]
    for spec in specs:
        assert torch.equal(streamed_matmul(x, w, spec=spec), out)
    assert streamed_matmul.launches_tc == before_tc + 1 + len(specs)


@pytest.mark.cuda
def test_misaligned_bf16_takes_the_cuda_cores_on_card(cuda):
    x = torch.from_numpy(_inputs(12, (64 * 64 + 4,))[0]).to(cuda, torch.bfloat16)[4:].view(64, 64)
    w = torch.from_numpy(_inputs(13, (64, 64))[0]).to(cuda, torch.bfloat16)
    before, before_tc = streamed_matmul.launches, streamed_matmul.launches_tc
    out = streamed_matmul(x, w)
    assert (streamed_matmul.launches, streamed_matmul.launches_tc) == (before + 1, before_tc)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_streamed_matmul_kernel_batched_and_stage_bytes_on_card(cuda):
    from repro_torch.kernels import _build

    lib = _build.load("streamed_matmul", ops._SIGNATURES)
    assert lib.repro_streamed_matmul_stage_bytes(0) == ops.stage_bytes(torch.float32)
    assert lib.repro_streamed_matmul_stage_bytes(1) == ops.stage_bytes(torch.bfloat16)
    for slots in range(1, ops.max_slots(torch.bfloat16) + 2):
        assert lib.repro_streamed_matmul_tc_smem_bytes(slots) == ops.ring_bytes(torch.bfloat16, slots)
    for slots in range(1, ops.max_slots(torch.float32) + 2):
        assert lib.repro_streamed_matmul_f32_smem_bytes(slots) == ops.ring_bytes(torch.float32, slots)
    x, w = (torch.from_numpy(a).to(cuda) for a in _inputs(8, (2, 3, 32, 96), (96, 64)))
    out = streamed_matmul(x, w)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        streamed_matmul(x, w, spec=PrefetchSpec(buffer_size=20, distance=1))
    xb = torch.zeros(4, 7, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        streamed_matmul(xb, torch.zeros(7, 8, device=cuda, dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (130, 130, 130), (7, 384, 512), (1, 128, 128)])
def test_f32_route_bitwise_across_rings_on_card(cuda, m, k, n):
    """The split plan fixes the order of the sum, so all six rings give the
    same bits, by TMA (K, N multiples of 4) and by cp.async (130^3); each
    is within the f32 tolerance of the plain version."""
    x, w = (torch.from_numpy(a).to(cuda) for a in _inputs(15, (m, k), (k, n)))
    assert ops.uses_tma(x, w) == (k % 4 == 0 and n % 4 == 0)
    specs = [PrefetchSpec(slots, 1, dist) for dist, slots in RINGS] + [PrefetchSpec(5, 1, AUTO)]
    outs = [streamed_matmul(x, w, spec=spec) for spec in specs]
    np.testing.assert_allclose(_f32(outs[0].cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(torch.float32))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_f32_kernel_refuses_a_plan_that_misses_or_repeats_a_k_tile_on_card(cuda, m, k, n):
    """The kernel takes the wrapper's plan as it is, and refuses before any
    launch a plan with a split too few or too many, or splits a k-tile too
    short or too long."""
    from repro_torch.kernels import _build

    lib = _build.load("streamed_matmul", ops._SIGNATURES)
    x, w = torch.zeros((m, k), device=cuda), torch.zeros((k, n), device=cuda)
    y, work = torch.empty((m, n), device=cuda), torch.empty((16, m, n), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    plan = ops.split_plan(m, n, k)
    n_kt = -(-k // ops.BLOCK_K)

    def launch(splits, kps):
        return lib.repro_streamed_matmul_f32(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(),
                                             m, n, k, splits, kps, 0, 1, 2, stream)

    def takes_each_once(splits, kps):  # no split empty (one at K = 0), none past K
        if n_kt == 0:
            return splits == 1
        return kps >= 1 and (splits - 1) * kps < n_kt <= splits * kps

    s, t = plan.splits, plan.tiles_per_split
    bad = [p for p in [(s - 1, t), (s + 1, t), (s, t - 1), (s, t + 1)] if not takes_each_once(*p)]
    assert takes_each_once(s, t) and bad
    assert all(launch(*p) != 0 for p in bad)
    assert launch(s, t) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_f32_route_misaligned_takes_cp_async_on_card(cuda):
    """A 4-byte-offset pointer cannot take TMA: the cp.async route, split
    the same way, gives the TMA route's bits."""
    x0, w = (torch.from_numpy(a).to(cuda) for a in _inputs(16, (256, 512), (512, 256)))
    x = torch.empty(1 + x0.numel(), device=cuda)[1:].view_as(x0).copy_(x0)
    assert not ops.uses_tma(x, w) and ops.uses_tma(x0, w)
    assert torch.equal(streamed_matmul(x, w), streamed_matmul(x0, w))


@pytest.mark.cuda
def test_f32_route_runs_no_plain_product_on_card(cuda, monkeypatch):
    """On a CUDA tensor the f32 route launches its kernels or raises: neither
    ``torch.matmul`` nor the plain version runs, split or not."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain product ran on a CUDA tensor")

    inputs = [(torch.from_numpy(a).to(cuda) for a in _inputs(17, (m, k), (k, n)))
              for m, k, n in [(512, 512, 512), (64, 100, 200)]]
    inputs = [tuple(pair) for pair in inputs]
    monkeypatch.setattr(torch, "matmul", refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    monkeypatch.setattr(ops, "matmul_ref", refuse)
    outs = [streamed_matmul(x, w) for x, w in inputs]
    monkeypatch.undo()
    for (x, w), out in zip(inputs, outs):
        np.testing.assert_allclose(_f32(out.cpu()), _f32(matmul_ref(x, w).cpu()), **_tol(torch.float32))
