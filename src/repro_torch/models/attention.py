"""GQA attention over full-attention KV caches.

Layouts follow the JAX package: q/k/v weights ``(D, N, H)`` / ``(D, K, H)``,
output weight ``(N, H, D)``; activations ``(B, S, N, H)``; the cache is
``{"k": (B, T, K, H), "v": ...}`` with slot ``t`` holding position ``t``.
GQA is computed grouped: q ``(B, S, K, G, H)`` against k/v ``(B, T, K, H)``;
KV heads are never materialized ``G``-fold.  Softmax in f32.

``cfg.attn_impl == "pallas"`` (the JAX name of the kernel path) routes
prefill through the flash-attention kernel and decode through the
decode-attention kernel.  Sliding-window ring caches and
``attn_impl="chunked"`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers, rope
from repro_torch.models.layers import Params

NEG_INF = -1e30

_RING_TODO = (
    "sliding-window ring KV caches are not ported yet "
    "(ROADMAP.md, queue 1 item 1: recurrentgemma through rglru_scan)"
)


def _window_of(cfg: ModelConfig) -> int:
    return cfg.window if (cfg.attn_type == "swa" or cfg.family == "hybrid") else 0


def _check_impl(cfg: ModelConfig) -> None:
    if cfg.attn_impl == "chunked":
        raise NotImplementedError(
            "attn_impl='chunked' is not ported yet "
            "(ROADMAP.md, queue 1 item 7: the other model families)"
        )
    if _window_of(cfg):
        raise NotImplementedError(_RING_TODO)


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
    if cfg.attn_type == "swa" or (cfg.family == "hybrid" and cfg.window):
        raise NotImplementedError(_RING_TODO)
    k, h = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, k, h), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, k, h), dtype=dtype, device=device),
    }


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

def attention_prefill(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    angles: Optional[torch.Tensor],
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """Causal attention over the prompt + populate the KV cache.

    The cache is written in place (the JAX package returns an updated copy):
    the first ``min(S, T)`` slots receive the prompt's keys and values.
    """
    _check_impl(cfg)
    q, k, v = _project_qkv(cfg, p, x)
    if angles is not None:
        q = rope.apply_rope(q, angles)
        k = rope.apply_rope(k, angles)
    if cfg.attn_impl == "pallas":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    else:
        out = _gqa_attend(cfg, q, k, v, causal_mask(x.shape[1], device=x.device))
    out = _out_proj(p, out, x.dtype)

    take = min(x.shape[1], cache["k"].shape[1])
    cache["k"][:, :take] = k[:, :take].to(cache["k"].dtype)
    cache["v"][:, :take] = v[:, :take].to(cache["v"].dtype)
    return out, cache


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, D)
    angles: Optional[torch.Tensor],  # (B, 1, H/2) for this position
    cache: dict,
    pos: Union[int, torch.Tensor],  # next position to write; or (B,) per slot
) -> tuple[torch.Tensor, dict]:
    """One decode step with KV-cache append.

    ``pos`` may be a per-batch-slot vector (the serving path: every slot
    decodes its own context position).  The new K/V row is written into
    the cache in place at ``pos`` (the JAX package returns an updated copy);
    attention then covers slots ``[0, pos]``.  Under ``attn_impl="pallas"``
    that is the decode kernel with ``lengths = pos + 1``.
    """
    _check_impl(cfg)
    q, k, v = _project_qkv(cfg, p, x)
    if angles is not None:
        q = rope.apply_rope(q, angles)
        k = rope.apply_rope(k, angles)

    b, cache_len = cache["k"].shape[:2]
    pos = torch.as_tensor(pos, device=x.device).expand(b)  # a scalar: every slot's position
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)

    if cfg.attn_impl == "pallas":
        lengths = (pos + 1).to(torch.int32).contiguous()
        out = decode_attention(q[:, 0], cache["k"], cache["v"], lengths)[:, None]
    else:
        mask = (torch.arange(cache_len, device=x.device)[None, :] <= pos[:, None])[:, None, :]
        out = _gqa_attend(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
    return _out_proj(p, out, x.dtype), cache
