"""OLMo-1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304 — non-parametric LN,
SwiGLU, RoPE, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    mlp_type="swiglu",
    norm_type="layernorm_nonparam",
    pos_type="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, remat="none",
    )
