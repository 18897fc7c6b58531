"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf:google/recurrentgemma-2b].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 (GeGLU) vocab=256000
— RG-LRU + local attention, pattern (rec, rec, attn) cycled, window 2048,
lru_width 2560, sqrt(d) embedding scale, logit softcap 30, tied embeddings.
Heterogeneous blocks => unrolled layer loop.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=10_000.0,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv_width=4,
    scale_embeddings=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    use_scan=True,  # period-scan over (rec,rec,attn) triples + unrolled tail
    source="arXiv:2402.19427; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256, window=16, lru_width=64, remat="none",
    )
