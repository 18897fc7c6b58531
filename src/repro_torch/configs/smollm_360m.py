"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 — llama-arch small.
15 heads do not divide the 16-way model axis: attention runs data-parallel
with MLP/vocab tensor-parallel (see parallel/sharding.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=96, vocab_size=256, remat="none",
    )
