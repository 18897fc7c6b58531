"""Plain PyTorch version of the streamed matmul."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` with f32 accumulation, result in ``x.dtype``, as the
    JAX package's ``matmul_ref``.  The value the kernel must give for every
    ``PrefetchSpec`` (paper §3.1: prefetching never changes the result)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)
