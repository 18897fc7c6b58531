"""Wrapper for the decode-attention kernel (one query token vs a KV cache).

Replaces the JAX package's Pallas kernel ``_decode_kernel`` /
``decode_attention_p`` (``repro/kernels/decode_attention/kernel.py``): the
cache stays in device memory, passed by reference, and streams through a
shared-memory ring of ``max(buffer_size, distance + 1)`` key blocks filled
``distance`` blocks ahead (``distance=0``: fetch, then wait).  Only
``ceil(length / BLOCK_KV)`` blocks are fetched for each sequence.  The
``PrefetchSpec`` changes the copy schedule, never the value: the kernel's
arithmetic is the same for every ring.

The CUDA kernel is ``repro_torch/csrc/decode_attention.cu``.  It reads the
``(B, T, KH, H)`` cache in place: no transpose, no padding copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import static_auto_distance
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DEFAULT_SPEC = PrefetchSpec(buffer_size=2, elements_per_fetch=1, distance=1)

#: key rows per ring stage and the most query heads per KV head (the CUDA
#: kernel's BKV and MAXG)
BLOCK_KV = 64
MAX_GROUP = 16
HEAD_DIMS = (64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_decode_attention_bf16": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "repro_decode_attention_smem_bytes": ([_I, _I], ctypes.c_int),
}


def smem_bytes(h: int, slots: int) -> int:
    """Shared memory of one block of the kernel at head dim ``h`` with a
    ring of ``slots`` stages: K (rows padded by 8) and V per stage, then the
    f32 q, scores and softmax state (``Smem<H>`` in the CUDA source)."""
    return slots * BLOCK_KV * (2 * h + 8) * 2 + (MAX_GROUP * h + MAX_GROUP * BLOCK_KV + 3 * MAX_GROUP) * 4


def ring_of(spec: PrefetchSpec, cache_len: int, h: int) -> tuple[int, int]:
    """``(distance, slots)`` of the kernel's ring for a cache of
    ``cache_len`` rows at head dim ``h``; ``"auto"`` resolves to a static
    head start.  Raises ``ValueError`` when the ring does not fit the card."""
    n_t = -(-cache_len // BLOCK_KV)
    distance = spec.numeric_distance(static_auto_distance(n_t))
    slots = max(spec.buffer_size, distance + 1, 1)
    if smem_bytes(h, slots) > SMEM_LIMIT:
        fit = (SMEM_LIMIT - smem_bytes(h, 0)) // (smem_bytes(h, 1) - smem_bytes(h, 0))
        raise ValueError(
            f"decode_attention: a ring of {slots} stages at head dim {h} needs "
            f"{smem_bytes(h, slots)} bytes of shared memory, more than the {SMEM_LIMIT} "
            f"bytes a block can use on the H100 (at most {fit} stages)"
        )
    return distance, slots


def decode_attention(
    q: torch.Tensor,  # (B, N, H)
    k: torch.Tensor,  # (B, T, KH, H)
    v: torch.Tensor,  # (B, T, KH, H)
    lengths: torch.Tensor,  # (B,) int32 — valid prefix per sequence
    *,
    spec: PrefetchSpec = _DEFAULT_SPEC,
) -> torch.Tensor:
    """One-token GQA attention vs a KV cache; the value of
    :func:`decode_attention_ref`.

    On a CUDA tensor this launches the kernel (bf16 q/k/v, int32 lengths,
    contiguous, head dim 64, 128 or 256) or raises; on a CPU tensor it runs
    the plain version.  Lengths are clamped to ``[0, T]`` by the kernel.  A
    ring deeper than the card's shared memory holds raises ``ValueError``
    before any launch, on every device.
    """
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,N,H), k/v (B,T,KH,H); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != h or n % kh or lengths.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)}, k/v {tuple(k.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not match")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("q, k, v and lengths must be on one device")
    distance, slots = ring_of(spec, t, h)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or lengths.dtype != torch.int32:
        raise TypeError("the CUDA kernel takes bfloat16 q/k/v and int32 lengths, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}/{lengths.dtype}")
    if not all(x.is_contiguous() for x in (q, k, v, lengths)):
        raise ValueError("the CUDA kernel takes contiguous q/k/v/lengths")
    if h not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {h}")
    if n // kh > MAX_GROUP:
        raise ValueError(f"at most {MAX_GROUP} query heads per KV head, got {n // kh}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("decode_attention", _SIGNATURES)
    rc = lib.repro_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, n, kh, h, distance, slots, h ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "decode_attention launch")
    decode_attention.launches += 1
    return out


#: kernel launches so far (CPU calls do not count)
decode_attention.launches = 0


def decode_attention_paged(
    q: torch.Tensor,  # (B, N, H)
    k_pages,  # sequence of (B, Tp, KH, H) device-resident pages
    v_pages,  # sequence of (B, Tp, KH, H)
    lengths: torch.Tensor,  # (B,) int32 — valid prefix per sequence
    *,
    spec: PrefetchSpec = _DEFAULT_SPEC,
) -> torch.Tensor:
    """Decode attention over a paged KV-cache view: the pages are joined
    along the time axis, then :func:`decode_attention` runs on the dense
    cache, so the value equals the dense call's bit for bit."""
    k_pages, v_pages = tuple(k_pages), tuple(v_pages)
    if not k_pages or len(k_pages) != len(v_pages):
        raise ValueError("k_pages / v_pages must be equal-length, non-empty")
    k = torch.cat(k_pages, dim=1)
    v = torch.cat(v_pages, dim=1)
    return decode_attention(q, k, v, lengths, spec=spec)
