"""Device resolution for the port's entry points.

The port runs on the card.  The CPU is taken only when the caller asks for
it (``device="cpu"``); a missing card is an error, never a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` when a CUDA device
    is asked for (or defaulted to) and none is present.

    Also turns TF32 off for matmuls and cuDNN: the port is held against the
    JAX package's float32 reference, and TF32 keeps only ~3 decimal digits,
    far outside the parity tolerances.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def generator(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """An explicit ``torch.Generator`` seeded with ``seed`` on ``device``."""
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(seed)
    return g
