"""Qwen3-235B-A22B MoE [hf:Qwen/Qwen3-235B-A22B; family ref Qwen/Qwen3-30B-A3B].

94L d_model=4096 64H (GQA kv=4, head_dim=128 — q proj 4096->8192) per-expert
d_ff=1536, vocab=151936, MoE 128 experts top-8, qk-norm.  The flagship cell
for the paper's technique: expert weights dominate (~227B routed params) and
are the state class host-offload + streaming target.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    capacity_factor=1.25,
    moe_group_size=2048,
    fsdp=True,
    source="hf:Qwen/Qwen3-235B-A22B",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, moe_top_k=2, moe_group_size=64,
        fsdp=False, remat="none",
    )
