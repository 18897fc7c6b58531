"""GQA attention: full / sliding-window, with ring-buffer KV caches.

Layouts follow the JAX package: q/k/v weights ``(D, N, H)`` / ``(D, K, H)``,
output weight ``(N, H, D)``; activations ``(B, S, N, H)``.  GQA is computed
grouped: q ``(B, S, K, G, H)`` against k/v ``(B, T, K, H)``; KV heads are
never materialized ``G``-fold.  Softmax in f32.

Cache layout (the JAX package's):
  full attention: ``{"k": (B, T, K, H), "v": ...}`` — slot ``t`` holds
  position ``t``.
  sliding window (``swa``, and the hybrid's local attention):
  ``{"k": (B, W, K, H), "v": ..., "slot_pos": (W,) int32}`` — a ring;
  ``slot_pos[j]`` is the absolute position held in slot ``j`` (-1 = empty),
  shared across the batch, so a ring decodes with one scalar position.

``cfg.attn_impl == "pallas"`` (the JAX name of the kernel path) routes
prefill (and a training forward without gradients) through the
flash-attention kernel (with the window) and decode through the
decode-attention kernel.  Over a ring the valid slots are
always the prefix ``[0, min(pos + 1, W))`` and softmax does not depend on
the order of the keys, so decode takes ``lengths = min(pos + 1, W)``.
``attn_impl="chunked"`` runs the training and prefill attention in query
blocks of ``cfg.attn_chunk_q`` (:func:`_gqa_attend_chunked`); decode is one
query and runs the plain path.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers, rope
from repro_torch.models.layers import Params
from repro_torch.parallel import local

NEG_INF = -1e30

def _window_of(cfg: ModelConfig) -> int:
    return cfg.window if (cfg.attn_type == "swa" or cfg.family == "hybrid") else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, *, generator: torch.Generator, device: torch.device) -> dict:
    d, n, k, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    p = {
        "wq": layers.fan_in_init((d, n, h), d, **kw),
        "wk": layers.fan_in_init((d, k, h), d, **kw),
        "wv": layers.fan_in_init((d, k, h), d, **kw),
        "wo": layers.fan_in_init((n, h, d), n * h, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h), device=device)
        p["bk"] = torch.zeros((k, h), device=device)
        p["bv"] = torch.zeros((k, h), device=device)
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms_head_norm(h, device)
        p["k_norm"] = layers.init_rms_head_norm(h, device)
    return p


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
               device: Optional[torch.device] = None) -> dict:
    k, h = cfg.n_kv_heads, cfg.head_dim
    cache = {
        "k": torch.zeros((batch, cache_len, k, h), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, k, h), dtype=dtype, device=device),
    }
    if cfg.attn_type == "swa" or (cfg.family == "hybrid" and cfg.window):
        cache["slot_pos"] = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# qkv projection (shared by all modes)
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = layers.head_norm_apply(p["q_norm"], q)
        k = layers.head_norm_apply(p["k_norm"], k)
    return q, k, v


def _gqa_attend(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, S, N, H)
    k: torch.Tensor,  # (B, T, K, H)
    v: torch.Tensor,  # (B, T, K, H)
    mask: torch.Tensor,  # (S, T) or (B, S, T) bool — True = attend
) -> torch.Tensor:
    b, s, n, h = q.shape
    kh = k.shape[2]
    g = n // kh
    qg = q.reshape(b, s, kh, g, h)
    # scores come out of the product in q.dtype, then widen (as in JAX)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores * (h ** -0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)  # cast before PV
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, n, h)


def _gqa_attend_chunked(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, S, N, H)
    k: torch.Tensor,  # (B, T, K, H)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Attention in query blocks of ``cfg.attn_chunk_q`` (the JAX package's
    ``_gqa_attend_chunked``): each block sees the full key length T under its
    own causal (or banded) mask, so peak score memory is ``(B, K, G, bq, T)``
    instead of ``(B, K, G, S, T)``.  One whole block when ``S <= bq`` or
    ``bq`` does not divide ``S``.  With gradients on, each block runs under a
    checkpoint, as the JAX package remats each block, so the backward keeps
    no block's scores."""
    b, s, n, h = q.shape
    t = k.shape[1]
    bq = cfg.attn_chunk_q or 512
    if s <= bq or s % bq != 0:
        return _gqa_attend(cfg, q, k, v, causal_mask(s, window, device=q.device))
    kpos = torch.arange(t, device=q.device)[None, :]

    def block(qblk, lo):
        qpos = lo + torch.arange(bq, device=q.device)[:, None]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        return _gqa_attend(cfg, qblk, k, v, mask)

    remat = torch.is_grad_enabled() and q.requires_grad
    outs = []
    for lo in range(0, s, bq):
        qblk = q[:, lo:lo + bq]
        outs.append(ckpt.checkpoint(block, qblk, lo, use_reentrant=False,
                                    preserve_rng_state=False) if remat else block(qblk, lo))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, window: int = 0, offset: int = 0, device=None) -> torch.Tensor:
    """(S, S+offset) causal (optionally banded) mask.  ``offset`` supports
    attending over a prefix (queries start at position ``offset``)."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(s + offset, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _out_proj(p: Params, out: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------

def attention_train(
    cfg: ModelConfig, p: Params, x: torch.Tensor, angles: Optional[torch.Tensor]
) -> torch.Tensor:
    """Full-sequence causal attention (training / scoring).  As in the JAX
    package, only ``swa`` configs band it (the hybrid's training attention is
    full causal).  Under ``attn_impl="pallas"`` with no window it runs the
    flash kernel, which is forward-only (the reference's cannot be
    differentiated either): with gradients on it raises."""
    q, k, v = _project_qkv(cfg, p, x)
    out = _on_local(functools.partial(_train_core, cfg), q, k, v, angles)
    return _out_proj(p, out, x.dtype)


def _train_core(cfg: ModelConfig, q, k, v, angles, cache, pos) -> torch.Tensor:
    if angles is not None:
        q = rope.apply_rope(q, angles)
        k = rope.apply_rope(k, angles)
    window = cfg.window if cfg.attn_type == "swa" else 0
    if cfg.attn_impl == "chunked":
        return _gqa_attend_chunked(cfg, q, k, v, window=window)
    if cfg.attn_impl == "pallas" and window == 0:
        if torch.is_grad_enabled() and q.requires_grad:
            raise NotImplementedError(
                "attn_impl='pallas' runs the forward-only flash kernel; train with "
                "attn_impl='xla' (the JAX package cannot differentiate its flash kernel either)"
            )
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    return _gqa_attend(cfg, q, k, v, causal_mask(q.shape[1], window, device=q.device))


def attention_prefill(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    angles: Optional[torch.Tensor],
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """Causal attention over the prompt + populate the KV cache.

    The cache is written in place (the JAX package returns an updated copy).
    A full cache's first ``min(S, T)`` slots receive the prompt's keys and
    values; a ring of W slots keeps the last ``min(S, W)`` at slots
    ``position % W``, matching ring-buffer decode.
    """
    q, k, v = _project_qkv(cfg, p, x)
    out = _on_local(functools.partial(_prefill_core, cfg), q, k, v, angles, cache)
    return _out_proj(p, out, x.dtype), cache


def _prefill_core(cfg: ModelConfig, q, k, v, angles, cache, pos) -> torch.Tensor:
    if angles is not None:
        q = rope.apply_rope(q, angles)
        k = rope.apply_rope(k, angles)
    window = _window_of(cfg)
    if cfg.attn_impl == "chunked":
        out = _gqa_attend_chunked(cfg, q, k, v, window=window)
    elif cfg.attn_impl == "pallas":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                              window=window)
    else:
        out = _gqa_attend(cfg, q, k, v, causal_mask(q.shape[1], window, device=q.device))
    s, cache_len = q.shape[1], cache["k"].shape[1]
    take = min(s, cache_len)
    if "slot_pos" in cache:
        positions = torch.arange(s - take, s, device=q.device)
        slots = positions % cache_len
        cache["k"][:, slots] = k[:, s - take:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, s - take:].to(cache["v"].dtype)
        cache["slot_pos"][slots] = positions.to(torch.int32)
    else:
        cache["k"][:, :take] = k[:, :take].to(cache["k"].dtype)
        cache["v"][:, :take] = v[:, :take].to(cache["v"].dtype)
    return out


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, D)
    angles: Optional[torch.Tensor],  # (B, 1, H/2) for this position
    cache: dict,
    pos: Union[int, torch.Tensor],  # next position to write; or (B,) per slot
) -> tuple[torch.Tensor, dict]:
    """One decode step with KV-cache append (ring for windowed archs).

    ``pos`` may be a per-batch-slot vector (the serving path: every slot
    decodes its own context position); that needs a full-attention cache,
    since a ring's ``slot_pos`` is shared across the batch.  The new K/V row
    is written into the cache in place (the JAX package returns an updated
    copy): at ``pos`` in a full cache, at ``pos % W`` in a ring.  Attention
    then covers slots ``[0, pos]``, or the ring's valid slots.  Under
    ``attn_impl="pallas"`` that is the decode kernel with ``lengths = pos +
    1``, or ``min(pos + 1, W)`` over a ring.
    """
    q, k, v = _project_qkv(cfg, p, x)
    out = _on_local(functools.partial(_decode_core, cfg), q, k, v, angles, cache, pos)
    return _out_proj(p, out, x.dtype), cache


def _decode_core(cfg: ModelConfig, q, k, v, angles, cache, pos) -> torch.Tensor:
    if angles is not None:
        q = rope.apply_rope(q, angles)
        k = rope.apply_rope(k, angles)
    b, cache_len = cache["k"].shape[:2]
    pos = torch.as_tensor(pos, device=q.device)
    if "slot_pos" in cache:
        if pos.dim() == 1:
            raise NotImplementedError(
                "per-slot decode positions require a full-attention cache "
                "(ring slot_pos is shared across the batch)"
            )
        return _ring_decode(cfg, q, k, v, cache, pos)
    pos = pos.expand(b)  # a scalar: every slot's position
    rows = torch.arange(b, device=q.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    if cfg.attn_impl == "pallas":
        lengths = (pos + 1).to(torch.int32).contiguous()
        return decode_attention(q[:, 0], cache["k"], cache["v"], lengths)[:, None]
    mask = (torch.arange(cache_len, device=q.device)[None, :] <= pos[:, None])[:, None, :]
    return _gqa_attend(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)


def _ring_decode(cfg: ModelConfig, q, k, v, cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """Decode against a ring at the scalar position ``pos`` (a 0-d tensor):
    indexed by tensors, so no step waits on the device."""
    b, cache_len = cache["k"].shape[:2]
    slot = (pos % cache_len).reshape(1).long()
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["slot_pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
    if cfg.attn_impl == "pallas":
        lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32).expand(b).contiguous()
        return decode_attention(q[:, 0], cache["k"], cache["v"], lengths)[:, None]
    sp = cache["slot_pos"]
    valid = (sp >= 0) & (sp >= pos - cache_len + 1) & (sp <= pos)
    return _gqa_attend(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), valid[None])


def _on_local(core, q, k, v, angles, cache: Optional[dict] = None, pos=None) -> torch.Tensor:
    """``core(q, k, v, angles, cache, pos) -> out (B, S, N, H)``: the rotary
    rotation, the cache write and the attention.  On plain tensors it runs
    as is.  On DTensors (a mesh) it runs on the rank's local shards at
    :func:`~repro_torch.parallel.local.attention_placements` (the kernels
    take raw pointers): the batch over the data axes, the heads over
    ``model`` when they divide it, else replicated.  Per-row angles and
    per-slot positions are cut to the rank's rows, the caches (``k``/``v``
    at that layout, ``slot_pos`` replicated) are written back at their own
    placements, and the output is rewrapped at that layout."""
    if not local.is_dtensor(q):
        return core(q, k, v, angles, cache, pos)
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    pl = local.attention_placements(mesh, q.shape[0], q.shape[2], k.shape[2])
    lo, n = local.local_range(mesh, pl, q.shape, 0)

    def rows(t):
        t = local.full_local(t)
        if not isinstance(t, torch.Tensor) or t.dim() == 0 or t.shape[0] == 1:
            return t
        return t[lo:lo + n]

    q_l, k_l, v_l = (local.to_local_at(t, pl) for t in (q, k, v))
    ang = local.full_local(angles) if angles is not None and angles.dim() == 2 else rows(angles)
    at = {}
    if cache is not None:
        for name, c in cache.items():
            cpl = pl if c.dim() == 4 else (Replicate(),) * mesh.ndim
            at[name] = (cpl, local.to_local_at(c, cpl))
    out = core(q_l, k_l, v_l, ang, {name: t for name, (_, t) in at.items()} if cache else None,
               rows(pos))
    for name, (cpl, t) in at.items():
        local.write_back(cache[name], t, cpl)
    return local.rewrap(out, mesh, pl, q.shape)
