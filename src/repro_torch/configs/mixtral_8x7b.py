"""Mixtral-8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L d_model=4096 32H (GQA kv=8) per-expert d_ff=14336 vocab=32000 — 8 experts
top-2, sliding-window attention (W=4096).  SWA makes long_500k decode
O(window): this arch RUNS the 500k cell (ring-buffer KV).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    attn_type="swa",
    window=4096,
    n_experts=8,
    moe_top_k=2,
    capacity_factor=1.25,
    moe_group_size=2048,
    fsdp=True,
    source="arXiv:2401.04088; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, window=16, n_experts=4, moe_top_k=2,
        moe_group_size=64, fsdp=False, remat="none",
    )
