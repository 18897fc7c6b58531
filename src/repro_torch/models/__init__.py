"""Model substrate: the uniform decoder stack and the recurrentgemma hybrid, in PyTorch."""
from repro_torch.models import attention, layers, rglru, rope, transformer
from repro_torch.models.transformer import decode_step, init_caches, init_model, prefill

__all__ = [
    "attention",
    "layers",
    "rglru",
    "rope",
    "transformer",
    "init_model",
    "init_caches",
    "prefill",
    "decode_step",
]
