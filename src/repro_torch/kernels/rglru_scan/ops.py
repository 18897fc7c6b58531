"""Wrapper for the linear-recurrence kernel (the RG-LRU's scan over time).

Replaces the JAX package's Pallas kernel ``_lru_kernel`` /
``linear_recurrence_p`` (``repro/kernels/rglru_scan/kernel.py``) behind the
contract of its wrapper (``ops.py:linear_recurrence``): ``h_t = a_t h_{t-1}
+ b_t`` over axis 1 with ``h_0 = 0``, any ``(B, S, W)``, the value of
``linear_recurrence_ref``.  The JAX wrapper pads time with identity steps
and channels with zeros; the CUDA kernel handles both edges in place.

``chunk_t`` and ``block_w`` are the TPU kernel's tile, and upper bounds, as
the JAX wrapper already cuts them to the input (``min(chunk_t, ...)``):
``block_w`` channels go to one block of threads, and each stage of its
double-buffered shared-memory ring holds at most ``chunk_t`` time steps of
``a`` and ``b``.  A (128, 256) f32 tile pair is 256 KB, more than a Hopper
block's 227 KB, so a stage holds as many steps as two stages fit
(:func:`stage_rows`).  The tiling never changes the value.

The CUDA kernel is ``repro_torch/csrc/rglru_scan.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.rglru_scan.ref import linear_recurrence_ref

#: ring stages x arrays (a, b) x bytes per f32
_STAGE_FACTOR = 2 * 2 * 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_rglru_scan_f32": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "repro_rglru_scan_smem_bytes": ([_I, _I], ctypes.c_int),
}


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def block_width(w: int, block_w: int) -> int:
    """Threads (channels) per block: ``block_w`` cut to the channels there
    are, in whole warps."""
    return min(block_w, _ceil_to(w, 32))


def stage_rows(s: int, chunk_t: int, bw: int) -> int:
    """Time steps per ring stage: ``chunk_t`` cut to the sequence (in
    multiples of 8, as the JAX wrapper cuts it) and to what two stages of
    ``bw``-wide f32 tiles of ``a`` and ``b`` fit in shared memory."""
    return max(1, min(chunk_t, _ceil_to(s, 8), SMEM_LIMIT // (_STAGE_FACTOR * bw)))


def smem_bytes(rows: int, bw: int) -> int:
    """Shared memory of the ring (``repro_rglru_scan_smem_bytes``)."""
    return _STAGE_FACTOR * rows * bw


def linear_recurrence(
    a: torch.Tensor,  # (B, S, W) f32
    b: torch.Tensor,
    *,
    chunk_t: int = 128,
    block_w: int = 256,
) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over axis 1, ``h_0 = 0``: ``(B, S, W)`` f32.

    On a CUDA tensor this launches the kernel (f32, contiguous) or raises;
    on a CPU tensor it runs the plain version.
    """
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a, b (B,S,W) of one shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if chunk_t < 1 or block_w < 32 or block_w % 32 or block_w > 1024:
        raise ValueError(f"chunk_t >= 1 and block_w a multiple of 32 in [32, 1024]; "
                         f"got chunk_t={chunk_t}, block_w={block_w}")
    if a.device.type == "cpu":
        return linear_recurrence_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"linear_recurrence runs on cuda or cpu tensors, not {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 a/b, got {a.dtype}/{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous a/b")
    bsz, s, w = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    bw = block_width(w, block_w)
    rows = stage_rows(s, chunk_t, bw)
    vec = int(w % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = _build.load("rglru_scan", _SIGNATURES)
    rc = lib.repro_rglru_scan_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, w, rows, bw, vec,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, rc, "rglru_scan launch")
    linear_recurrence.launches += 1
    return out


#: kernel launches so far (CPU calls do not count)
linear_recurrence.launches = 0
