"""Rotary position embeddings: standard RoPE and sinusoidal.

Conventions as in the JAX package: rotate-half layout (x1 = x[..., :H/2],
x2 = x[..., H/2:]), f32 angles, cos/sin cast to ``x.dtype`` before the
rotation.  M-RoPE (Qwen2-VL) follows with the VLM family (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (..., S) int -> angles (..., S, head_dim/2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, N, H), angles (B, S, H/2) or (S, H/2) -> rotated x."""
    if angles.dim() == 2:  # (S, H/2) -> broadcast batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)  # (B,S,1,H/2)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int, max_scale: float = 10000.0) -> torch.Tensor:
    """Classic transformer sinusoidal absolute embedding: (..., S) -> (..., S, D)."""
    half = d_model // 2
    freq = torch.exp(
        -math.log(max_scale) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
