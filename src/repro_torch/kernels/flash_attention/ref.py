"""Plain PyTorch version of blockwise (flash) attention."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, S, N, H)
    k: torch.Tensor,  # (B, T, KH, H)
    v: torch.Tensor,  # (B, T, KH, H)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-materialization GQA attention with f32 softmax, as the JAX
    package's ``attention_ref``.

    ``window > 0`` restricts key position ``t`` to ``qpos - window < t``;
    ``q_offset`` places query 0 at absolute position ``q_offset``.  A query
    row that no key may attend to gives 0, as the kernels give it.
    """
    b, s, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = n // kh
    qg = q.reshape(b, s, kh, g, h)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores * (h ** -0.5)
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, n, h)
