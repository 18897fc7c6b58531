"""Wrapper for the decode-attention kernel (one query token vs a KV cache).

Replaces the JAX package's Pallas kernel ``_decode_kernel`` /
``decode_attention_p`` (``repro/kernels/decode_attention/kernel.py``): the
cache stays in device memory, passed by reference, and streams through a
shared-memory ring of ``max(buffer_size, distance + 1)`` stages of
``BLOCK_KV`` keys filled ``distance`` stages ahead (``distance=0``: fetch,
then wait).  The ``PrefetchSpec`` changes the copy schedule, never the
value.

The CUDA kernel is ``repro_torch/csrc/decode_attention.cu``.  It reads the
``(B, T, KH, H)`` cache in place and splits the key axis across blocks:
each (row, KV head) gets ``ceil(T / SPLIT_KV)`` blocks, block ``s`` taking
keys ``[s * SPLIT_KV, (s + 1) * SPLIT_KV)`` of the valid prefix through its
own ring (:func:`split_plan`).  The blocks write unnormalised partials to a
workspace that this wrapper allocates, and a combine merges them in split
order, so the value depends on neither T nor the ring.  The grid is sized
from T: the wrapper never reads ``lengths`` on the host.
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

#: keys per block of the split, key rows per ring stage, warps along a
#: stage's keys and the most query heads per KV head (the CUDA kernel's
#: SPLIT_KV, BKV, KGROUPS and MAXG)
SPLIT_KV = 128
BLOCK_KV = 64
KEY_GROUPS = 4
MAX_GROUP = 16
HEAD_DIMS = (64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_decode_attention_bf16": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "repro_decode_attention_smem_bytes": ([_I, _I], ctypes.c_int),
    "repro_decode_attention_split_kv": ([], ctypes.c_int),
}


def smem_bytes(h: int, slots: int) -> int:
    """Shared memory of one block of the kernel at head dim ``h`` with a
    ring of ``slots`` stages: K and V bf16 per stage (no pad: the chunks are
    swizzled), then the key groups' f32 softmax state and merge weights,
    and above head dim 128 the exchange of S's halves between the two
    warps of each key group (``Smem<H>`` in the CUDA source)."""
    exchange = KEY_GROUPS * 2 * 32 * 8 * 4 if h > 128 else 0
    return slots * BLOCK_KV * h * 2 * 2 + 3 * KEY_GROUPS * MAX_GROUP * 4 + exchange


def n_splits(cache_len: int) -> int:
    """Blocks per (row, KV head) for a cache of ``cache_len`` rows."""
    return -(-cache_len // SPLIT_KV)


def split_plan(cache_len: int, length: int) -> list[list[range]]:
    """A model of the kernel's walk, for the tests: the keys each block of
    one (row, KV head) reads, for each split of the grid its ring stages in
    order, none for a split at or past the length (clamped to
    ``[0, cache_len]``, as the kernel clamps it).  A split starts at a
    multiple of ``SPLIT_KV`` and a stage at a multiple of ``BLOCK_KV``,
    whatever the cache length.  The wrapper does not call it (the grid
    holds ``n_splits`` blocks per (row, KV head)); the tests on the card
    hold the kernel to the plain version at this plan's edges."""
    length = max(0, min(length, cache_len))
    plan = []
    for s in range(n_splits(cache_len)):
        start, stop = s * SPLIT_KV, min((s + 1) * SPLIT_KV, length)
        plan.append([range(t, min(t + BLOCK_KV, stop)) for t in range(start, stop, BLOCK_KV)])
    return plan


def ring_of(spec: PrefetchSpec, cache_len: int, h: int) -> tuple[int, int]:
    """``(distance, slots)`` of each block's ring for a cache of
    ``cache_len`` rows at head dim ``h``; ``"auto"`` resolves to a static
    head start over the stages of one split.  Raises ``ValueError`` when the
    ring does not fit the card."""
    n_t = min(-(-cache_len // BLOCK_KV), SPLIT_KV // BLOCK_KV)
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
    the plain version.  Lengths are clamped to ``[0, T]`` by the kernel and
    never read on the host.  A ring deeper than the card's shared memory
    holds raises ``ValueError`` before any launch, on every device.
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
    # each block's unnormalised O, then its (m, l), per (row, head, split)
    work = torch.empty(b * n * n_splits(t) * (h + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    rc = lib.repro_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        work.data_ptr(), b, t, n, kh, h, distance, slots, h ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "decode_attention launch")
    decode_attention.launches += 2  # the split kernel, then the combine
    return out


#: kernel launches so far, two a call: the split kernel and the combine
#: (CPU calls do not count)
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
