"""Wrapper for the flash-attention kernel (GQA, causal, sliding window).

Replaces the JAX package's Pallas kernel ``_flash_kernel`` /
``flash_attention_p`` (``repro/kernels/flash_attention/kernel.py``) behind
the same contract as its wrapper (``ops.py:flash_attention``): keys past
``T`` are treated as padding that causality removes, non-causal attention
with a key length that is not a multiple of the kernel's key block raises,
and a query row that no key may attend to gives 0.

The CUDA kernel is ``repro_torch/csrc/flash_attention.cu``: ``wgmma`` on
the tensor cores, fed by TMA, which reads the ``(B, S, N, H)`` /
``(B, T, KH, H)`` layouts in place (no transpose, no padding copy) into a
K/V ring under mbarriers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.flash_attention.ref import attention_ref

#: the CUDA kernel's key block (rows of K/V per ring stage), its q rows per
#: warpgroup (queries x the G heads of one KV head: at most 64 heads per KV
#: head), its warpgroups per block, and its K/V ring's stages per head dim
#: (``stages_of<H>``; two for a head dim it does not take)
BLOCK_KV = 64
WARPGROUP_ROWS = 64
WARPGROUPS = 2
STAGES = {64: 4, 128: 3, 256: 2}
HEAD_DIMS = (64, 128, 256)
#: the 1024-byte alignment pad of the kernel's shared memory (the 128-byte
#: swizzle's atom)
_ALIGN_PAD = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_flash_attention_bf16": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "repro_flash_attention_smem_bytes": ([_I], ctypes.c_int),
}


def smem_bytes(h: int) -> int:
    """Shared memory of one block of the kernel at head dim ``h``: the
    alignment pad, the bf16 q tile of both warpgroups, the stages of K and
    V, and the mbarriers: one for q, a full and an empty one per stage
    (``Smem<H>`` in the CUDA source)."""
    stages = STAGES.get(h, 2)
    q_tile = WARPGROUPS * WARPGROUP_ROWS * h * 2
    stage = 2 * BLOCK_KV * h * 2
    return _ALIGN_PAD + q_tile + stages * stage + 8 * (1 + 2 * stages)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,N,H), k/v (B,T,KH,H); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, n, h = q.shape
    if k.shape[0] != b or k.shape[3] != h or n % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if smem_bytes(h) > SMEM_LIMIT:
        raise ValueError(f"flash_attention: a tile at head dim {h} needs {smem_bytes(h)} bytes "
                         f"of shared memory, more than the {SMEM_LIMIT} bytes a block can use "
                         "on the H100")


def flash_attention(
    q: torch.Tensor,  # (B, S, N, H)
    k: torch.Tensor,  # (B, T, KH, H)
    v: torch.Tensor,  # (B, T, KH, H)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA flash attention; the value of :func:`attention_ref`.

    On a CUDA tensor this launches the kernel (bf16, contiguous, head dim
    64, 128 or 256) or raises; on a CPU tensor it runs the plain version.
    A head dim whose tile does not fit the card's shared memory raises
    ``ValueError`` on every device.
    """
    _check(q, k, v)
    b, s, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    if not causal and t % BLOCK_KV:
        raise NotImplementedError(
            "non-causal flash attention requires block-aligned key length "
            f"(T={t}, block_kv={BLOCK_KV})"
        )
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q/k/v")
    if h not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {h}")
    if n // kh > WARPGROUP_ROWS:
        raise ValueError(f"at most {WARPGROUP_ROWS} query heads per KV head, got {n // kh}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    rc = lib.repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, n, kh, h, int(causal), window, q_offset, h ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_attention launch")
    flash_attention.launches += 1
    return out


#: kernel launches so far (CPU calls do not count)
flash_attention.launches = 0
