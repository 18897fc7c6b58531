"""Qwen2-VL-72B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE (sections
16/24/24), qkv bias, dynamic-resolution vision (STUB frontend per assignment:
``input_specs`` provides precomputed patch embeddings; 1/8 of the sequence is
vision prefix).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    vision_embed=True,
    fsdp=True,
    source="arXiv:2409.12191; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        mrope_sections=(2, 3, 3), d_ff=128, vocab_size=256, fsdp=False, remat="none",
    )
