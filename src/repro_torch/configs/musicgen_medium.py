"""MusicGen-medium [arXiv:2306.05284; hf:facebook/musicgen-medium].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens: 4 codebooks, input embedding = sum over codebooks, 4 parallel
LM heads.  EnCodec itself is a STUB (assignment: precomputed frame tokens via
``input_specs``).  GELU MLP, LayerNorm, sinusoidal positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_type="sinusoidal",
    n_codebooks=4,
    source="arXiv:2306.05284; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, n_codebooks=2, remat="none",
    )
