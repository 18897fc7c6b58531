"""Wrapper for the streamed-matmul kernel: ``y = x @ w`` with ``w`` passed by
reference and streamed through an on-chip ring.

Replaces the JAX package's Pallas kernel ``_streamed_matmul_kernel`` /
``streamed_matmul_p`` (``repro/kernels/streamed_matmul/kernel.py``), the
paper's §3.1 mechanism one level down: the weights stay in device memory
and ``(BLOCK_K, BLOCK_N)`` tiles go through a shared-memory ring of
``max(buffer_size, distance + 1)`` stages, each copy issued ``distance``
tiles ahead (``0``: issue, then wait).  ``"auto"`` resolves once, through
:func:`~repro_torch.core.engine.static_auto_distance`, since the ring is
sized at launch.  The ``PrefetchSpec`` changes the copy schedule, never the
value.

The CUDA kernel is ``repro_torch/csrc/streamed_matmul.cu``.  It reads
``(M, K)`` and ``(K, N)`` in place (no padding copies) by one of two routes,
chosen by :func:`route` from the dtype and the alignment alone:

* ``"tensor_cores"``: bf16 whose K and N are multiples of 8 and whose
  pointers are 16-byte aligned (TMA's row strides).  ``wgmma`` on
  ``TC_BLOCK_M x TC_BLOCK_N x TC_BLOCK_K`` tiles that TMA copies into the
  ring, mbarriers reporting each stage.
* ``"cuda_cores"``: f32 (whose tolerance rules out TF32), and bf16 of other
  strides.  f32 runs f32 FMAs on ``BLOCK_M x BLOCK_N`` output tiles, 8 x 4
  outputs a thread, over k-tiles of ``BLOCK_K``, filled by TMA where K and N
  are multiples of 4 and both pointers 16-byte aligned, else by 4-byte
  ``cp.async``; full/empty mbarriers per slot.  K is split across blocks by
  :func:`split_plan`, a function of the shapes alone that the kernel takes
  as arguments, and a second kernel adds the splits' partials in split
  order, so the value is the same for every ``PrefetchSpec``.  A stage is
  small enough that a ring ``buffer_size = 10`` deep fits the card's shared
  memory.  bf16 of other strides takes 4-byte ``cp.async`` tiles of 64 x 64
  x 32 with a block barrier per k-tile.

Neither is a fallback for the other: a launch that fails raises.  The ring
limits are one answer per dtype, each from the stage that bounds it (bf16:
the tensor-core stage), on every device: a ring that does not fit raises
``ValueError`` naming the limit, and the schedule is never clamped quietly.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

_DEFAULT_SPEC = PrefetchSpec(buffer_size=2, elements_per_fetch=1, distance=1)

#: the f32 route's output tile and k-tile (``f32::BM``, ``f32::BN``, ``f32::BK``)
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32
#: the split plan's aims: enough splits for this many blocks (two on each of
#: the H100's 132 SMs), each split at least this many k-tiles long
TARGET_BLOCKS = 256
MIN_SPLIT_KT = 2
#: the tensor-core route's tile (``tc::BM``, ``tc::BN``, ``tc::BK``)
TC_BLOCK_M, TC_BLOCK_N, TC_BLOCK_K = 128, 128, 64
#: the k-tile that counts a dtype's ring tiles (``"auto"`` resolves from it)
_BLOCK_K_OF = {torch.float32: BLOCK_K, torch.bfloat16: TC_BLOCK_K}
#: each ring's 1024-byte alignment pad (the swizzle's repeat) and its
#: mbarriers per slot: the tensor-core ring one, the f32 ring two (full, empty)
_ALIGN_PAD, _BARRIER_BYTES = 1024, 8
_BARRIERS = {torch.float32: 2, torch.bfloat16: 1}
_DTYPES = (torch.float32, torch.bfloat16)
#: deepest lookahead of every route: the bf16 CUDA-core route's
#: ``cp.async.wait_group`` switch covers 15 (the mbarrier rings have no such limit)
MAX_DISTANCE = 15

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_streamed_matmul_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_streamed_matmul_bf16": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_streamed_matmul_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_streamed_matmul_stage_bytes": ([_I], ctypes.c_int),
    "repro_streamed_matmul_f32_smem_bytes": ([_I], ctypes.c_int),
    "repro_streamed_matmul_tc_smem_bytes": ([_I], ctypes.c_int),
}


class SplitPlan(NamedTuple):
    """How the f32 route cuts ``(M, K) @ (K, N)``: ``tile`` outputs a block,
    K in ``splits`` runs of ``tiles_per_split`` k-tiles of ``BLOCK_K`` (the
    last run may be shorter), one block per (M tile, N tile, split)."""

    tile: tuple[int, int]
    splits: int
    tiles_per_split: int
    grid: tuple[int, int, int]

    def k_tiles(self, k: int) -> list[range]:
        """Each split's k-tiles, in split order."""
        n_kt = -(-k // BLOCK_K)
        return [range(s * self.tiles_per_split, min((s + 1) * self.tiles_per_split, n_kt))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=256)
def split_plan(m: int, n: int, k: int) -> SplitPlan:
    """The f32 route's split of K, from the shapes alone (never the
    ``PrefetchSpec``, the card or a timing, so the value is the same for
    every ring): as many splits as bring the blocks to ``TARGET_BLOCKS``,
    while each keeps ``MIN_SPLIT_KT`` k-tiles; ``1`` where K is too short.
    The kernel takes it as arguments and refuses a plan that does not take
    every k-tile once."""
    tiles_m, tiles_n = -(-m // BLOCK_M), -(-n // BLOCK_N)
    n_kt = -(-k // BLOCK_K)
    want = -(-TARGET_BLOCKS // max(1, tiles_m * tiles_n))
    s = max(1, min(want, n_kt // MIN_SPLIT_KT))
    per = -(-n_kt // s)
    splits = -(-n_kt // per) if per else 1
    return SplitPlan((BLOCK_M, BLOCK_N), splits, per, (tiles_m, tiles_n, splits))


def stage_bytes(dtype: torch.dtype) -> int:
    """Bytes of one ring stage of the dtype's bounding route: f32, an x tile
    and a w tile of the f32 route; bf16, an x tile and a w tile of the
    tensor-core route."""
    if dtype == torch.bfloat16:
        return (TC_BLOCK_M * TC_BLOCK_K + TC_BLOCK_K * TC_BLOCK_N) * 2
    return (BLOCK_M * BLOCK_K + BLOCK_K * BLOCK_N) * 4


def ring_bytes(dtype: torch.dtype, slots: int) -> int:
    """Shared memory of a ring of ``slots`` stages of the dtype's bounding
    route, with its alignment pad and its mbarriers."""
    return _ALIGN_PAD + slots * (stage_bytes(dtype) + _BARRIERS[dtype] * _BARRIER_BYTES)


def max_slots(dtype: torch.dtype) -> int:
    """The deepest ring of ``dtype`` that fits a block's shared memory."""
    slots = SMEM_LIMIT // stage_bytes(dtype)
    while ring_bytes(dtype, slots) > SMEM_LIMIT:
        slots -= 1
    return slots


def ring_of(spec: PrefetchSpec, k: int, dtype: torch.dtype) -> tuple[int, int]:
    """``(distance, slots)`` of the kernel's ring for a reduction of length
    ``k``, counted in the dtype's k-tiles.  Raises ``ValueError`` when the
    ring does not fit the card."""
    n_k = -(-k // _BLOCK_K_OF[dtype])
    distance = spec.numeric_distance(static_auto_distance(n_k))
    slots = max(spec.buffer_size, distance + 1, 1)
    if distance > MAX_DISTANCE:
        raise ValueError(f"streamed_matmul: distance {distance} exceeds the kernel's "
                         f"lookahead limit of {MAX_DISTANCE} tiles")
    need = ring_bytes(dtype, slots)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"streamed_matmul: a ring of {slots} stages x {stage_bytes(dtype)} bytes "
            f"({dtype}) needs {need} bytes of shared memory, more than the "
            f"{SMEM_LIMIT} bytes a block can use on the H100 "
            f"(at most {max_slots(dtype)} stages)"
        )
    return distance, slots


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route of ``x (M, K) @ w (K, N)``: ``"tensor_cores"`` for
    bf16 with K and N multiples of 8 (16-byte rows) and 16-byte aligned
    pointers, ``"cuda_cores"`` otherwise."""
    k, n = w.shape
    if (x.dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tensor_cores"
    return "cuda_cores"


def uses_tma(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the f32 route fills its stages by TMA: K and N multiples of 4
    (16-byte rows) and both pointers 16-byte aligned; else by ``cp.async``."""
    k, n = w.shape
    return k > 0 and k % 4 == 0 and n % 4 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def _check_4_byte_rows(x: torch.Tensor, w: torch.Tensor, k: int, n: int) -> None:
    """The bf16 CUDA-core route copies 4 bytes at a time: K and N even,
    both pointers 4-byte aligned."""
    if k % 2 or n % 2 or x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError(f"the CUDA kernel takes rows of a multiple of 4 bytes: K={k}, N={n} "
                         f"in {x.dtype} (bf16 needs K and N even)")


def streamed_matmul(
    x: torch.Tensor,  # (..., K)
    w: torch.Tensor,  # (K, N)
    *,
    spec: PrefetchSpec = _DEFAULT_SPEC,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """``y[..., n] = x[..., k] @ w[k, n]`` with ``w`` streamed by reference;
    the value of :func:`matmul_ref` for every ``spec``.

    ``x`` may carry leading batch dims; they are flattened into M.  f32 and
    bf16 (the same for both operands); the result is in ``x``'s dtype.  On a
    CUDA tensor this launches the kernel (contiguous operands) or raises; on
    a CPU tensor it runs the plain version (on a meta tensor, its shapes).
    ``block_m`` / ``block_n`` / ``block_k`` are the Pallas kernel's VMEM
    blocks, kept so that callers of the JAX wrapper run unchanged; each
    route's tile is fixed, so they must be positive and are not otherwise
    read.
    """
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"block sizes must be >= 1, got ({block_m}, {block_n}, {block_k})")
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"expected x (..., K) and w (K, N); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"streamed_matmul takes float32 or bfloat16 operands of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    *lead, k = x.shape
    n = w.shape[1]
    distance, slots = ring_of(spec, k, x.dtype)
    if x.device.type in ("cpu", "meta"):  # meta: a lowering's shapes, nothing runs
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"streamed_matmul runs on cuda or cpu tensors, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x and w")
    m = math.prod(lead)
    x2 = x if x.dim() == 2 else x.reshape(m, k)  # a reshape costs the host a microsecond
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, n)
    # the current stream's raw handle, without building a torch.cuda.Stream
    # (a few microseconds of host time a call, more than the kernel takes at 512^3)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    lib = _build.load("streamed_matmul", _SIGNATURES)
    if x.dtype == torch.float32:
        plan = split_plan(m, n, k)
        # the partials, held until the launch is enqueued (the allocator's
        # stream order keeps them until the combine has read them)
        work = (torch.empty(plan.splits * m * n, dtype=torch.float32, device=x.device)
                if plan.splits > 1 else None)
        rc = lib.repro_streamed_matmul_f32(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           None if work is None else work.data_ptr(), m, n, k,
                                           plan.splits, plan.tiles_per_split, int(uses_tma(x2, w)),
                                           distance, slots, stream)
        _build.check(lib, rc, "streamed_matmul launch (f32)")
        streamed_matmul.launches += 2 if plan.splits > 1 else 1
    elif route(x2, w) == "tensor_cores":
        rc = lib.repro_streamed_matmul_tc(x2.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                          distance, slots, stream)
        _build.check(lib, rc, "streamed_matmul launch (tensor cores)")
        streamed_matmul.launches += 1
        streamed_matmul.launches_tc += 1
    else:
        _check_4_byte_rows(x2, w, k, n)
        rc = lib.repro_streamed_matmul_bf16(x2.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                            distance, slots, stream)
        _build.check(lib, rc, "streamed_matmul launch (bf16, CUDA cores)")
        streamed_matmul.launches += 1
    return out if x.dim() == 2 else out.reshape(*lead, n)


#: kernels launched so far on every route (an f32 call that splits K
#: launches two: the split kernel and the combine; CPU calls do not count),
#: and those of the tensor-core route
streamed_matmul.launches = 0
streamed_matmul.launches_tc = 0
