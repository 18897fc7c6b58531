"""Model substrate: the uniform decoder stack, the recurrentgemma hybrid and the
xLSTM stack, in PyTorch."""
from repro_torch.models import attention, layers, rglru, rope, transformer, xlstm
from repro_torch.models.transformer import decode_step, init_caches, init_model, prefill

__all__ = [
    "attention",
    "layers",
    "rglru",
    "rope",
    "transformer",
    "xlstm",
    "init_model",
    "init_caches",
    "prefill",
    "decode_step",
]
