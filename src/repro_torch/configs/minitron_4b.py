"""Minitron-4B [arXiv:2407.14679; hf:nvidia/Minitron-4B-Base].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000 — pruned Nemotron:
squared-ReLU MLP, LayerNorm, RoPE, untied (large 256k vocab).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    mlp_type="relu2",
    norm_type="layernorm",
    pos_type="rope",
    rope_theta=10_000.0,
    source="arXiv:2407.14679; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512, remat="none",
    )
