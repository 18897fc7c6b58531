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
  strides.  f32 FMAs on ``BLOCK_M x BLOCK_N x BLOCK_K`` tiles staged by
  ``cp.async``, chosen so that a ring ``buffer_size = 10`` deep fits the
  card's shared memory in f32.

Neither is a fallback for the other: a launch that fails raises.  The ring
limits are one answer per dtype, each from the stage that bounds it (bf16:
the tensor-core stage), on every device: a ring that does not fit raises
``ValueError`` naming the limit, and the schedule is never clamped quietly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

_DEFAULT_SPEC = PrefetchSpec(buffer_size=2, elements_per_fetch=1, distance=1)

#: the CUDA-core route's tile (BM, BN, BK in ``csrc/streamed_matmul.cu``)
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32
#: the tensor-core route's tile (``tc::BM``, ``tc::BN``, ``tc::BK``)
TC_BLOCK_M, TC_BLOCK_N, TC_BLOCK_K = 128, 128, 64
#: the k-tile that counts a dtype's ring tiles (``"auto"`` resolves from it)
_BLOCK_K_OF = {torch.float32: BLOCK_K, torch.bfloat16: TC_BLOCK_K}
#: padded row of the CUDA-core route's f32 x tile in shared memory, in elements
_X_STRIDE_F32 = BLOCK_K + 4
#: the tensor-core ring's 1024-byte alignment pad (the 128-byte swizzle's
#: atom) and its one mbarrier per slot
_TC_ALIGN_PAD, _TC_BARRIER_BYTES = 1024, 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: deepest lookahead the kernel's ``cp.async.wait_group`` switch covers
MAX_DISTANCE = 15

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_streamed_matmul": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_streamed_matmul_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_streamed_matmul_stage_bytes": ([_I], ctypes.c_int),
    "repro_streamed_matmul_tc_smem_bytes": ([_I], ctypes.c_int),
}


def stage_bytes(dtype: torch.dtype) -> int:
    """Bytes of one ring stage of the dtype's bounding route: f32, an x tile
    (rows padded) and a w tile of the CUDA-core route; bf16, an x tile and
    a w tile of the tensor-core route."""
    if dtype == torch.bfloat16:
        return (TC_BLOCK_M * TC_BLOCK_K + TC_BLOCK_K * TC_BLOCK_N) * 2
    return (BLOCK_M * _X_STRIDE_F32 + BLOCK_K * BLOCK_N) * 4


def ring_bytes(dtype: torch.dtype, slots: int) -> int:
    """Shared memory of a ring of ``slots`` stages of the dtype's bounding
    route: the tensor-core ring adds its alignment pad and its mbarriers."""
    if dtype == torch.bfloat16:
        return _TC_ALIGN_PAD + slots * (stage_bytes(dtype) + _TC_BARRIER_BYTES)
    return slots * stage_bytes(dtype)


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
                         f"cp.async lookahead limit of {MAX_DISTANCE} tiles")
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


def _chunk_bytes(x: torch.Tensor, w: torch.Tensor, k: int, n: int) -> int:
    """Width of the kernel's ``cp.async`` copies: 16 bytes when every row
    and both pointers are 16-byte aligned, else 4."""
    es = x.element_size()
    if (k * es) % 16 == 0 and (n * es) % 16 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return 16
    if (k * es) % 4 or (n * es) % 4 or x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError(f"the CUDA kernel takes rows of a multiple of 4 bytes: K={k}, N={n} "
                         f"in {x.dtype} (bf16 needs K and N even)")
    return 4


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
    a CPU tensor it runs the plain version.  ``block_m`` / ``block_n`` /
    ``block_k`` are the Pallas kernel's VMEM blocks, kept so that callers of
    the JAX wrapper run unchanged; each route's tile is fixed, so they must
    be positive and are not otherwise read.
    """
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"block sizes must be >= 1, got ({block_m}, {block_n}, {block_k})")
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"expected x (..., K) and w (K, N); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"streamed_matmul takes float32 or bfloat16 operands of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    *lead, k = x.shape
    n = w.shape[1]
    distance, slots = ring_of(spec, k, x.dtype)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"streamed_matmul runs on cuda or cpu tensors, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x and w")
    m = math.prod(lead)
    x2 = x.reshape(m, k)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load("streamed_matmul", _SIGNATURES)
    if route(x2, w) == "tensor_cores":
        rc = lib.repro_streamed_matmul_tc(x2.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                          distance, slots, stream)
        _build.check(lib, rc, "streamed_matmul launch (tensor cores)")
        streamed_matmul.launches_tc += 1
    else:
        chunk = _chunk_bytes(x2, w, k, n)
        rc = lib.repro_streamed_matmul(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, _DTYPE_CODE[x.dtype], chunk,
            distance, slots, stream,
        )
        _build.check(lib, rc, "streamed_matmul launch (CUDA cores)")
    streamed_matmul.launches += 1
    return out.reshape(*lead, n)


#: kernel launches so far, both routes (CPU calls do not count), and those
#: of the tensor-core route
streamed_matmul.launches = 0
streamed_matmul.launches_tc = 0
