"""InternLM2-20B [arXiv:2403.17297; hf:internlm/internlm2-20b].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544 — GQA, SwiGLU,
RMSNorm, RoPE (theta 1e6).  Large enough that FSDP is on by default.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1_000_000.0,
    fsdp=True,
    source="arXiv:2403.17297; hf",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256, fsdp=False, remat="none",
    )
