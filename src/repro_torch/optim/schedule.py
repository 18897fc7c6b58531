"""Learning-rate schedules (the JAX package's ``optim/schedule.py``, op for op, in f32)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_ratio * peak_lr``.  ``step`` is
    a tensor (its device is the result's) or a number; the result is an f32
    0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
