"""Plain PyTorch version of the first-order linear recurrence."""
from __future__ import annotations

import torch


def linear_recurrence_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1, ``h_0 = 0``, as the JAX
    package's ``linear_recurrence_ref``: a sequential loop over time.

    a, b: (B, S, W) f32.  Returns h: (B, S, W) f32.  Each step is a product
    then a sum, each rounded to f32, which is what the CUDA kernel computes.
    """
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
