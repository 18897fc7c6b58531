"""Plain PyTorch version of single-token decode attention over a KV cache."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (B, N, H) — one new token per sequence
    k: torch.Tensor,  # (B, T, KH, H) — cache
    v: torch.Tensor,  # (B, T, KH, H)
    length: torch.Tensor,  # (B,) int32 — valid cache prefix per sequence
) -> torch.Tensor:
    """GQA decode attention over the valid prefix ``[0, length)`` of the
    cache, as the JAX package's ``decode_attention_ref``.  A sequence of
    length 0 gives 0, as the kernels give it."""
    b, n, h = q.shape
    kh = k.shape[2]
    g = n // kh
    qg = q.reshape(b, kh, g, h)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k).float()
    scores = scores * (h ** -0.5)
    valid = torch.arange(k.shape[1], device=q.device)[None] < length[:, None].to(q.device)  # (B, T)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1)[:, None, None, None], probs, 0.0).to(q.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v)
    return out.reshape(b, n, h)
