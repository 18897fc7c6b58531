"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48 blocks d_model=2048 4H vocab=50304, d_ff=0 (no separate FFN — xLSTM blocks
carry their own up/down projections, proj_factor 2, qk at half width).
Pattern: one sLSTM block every 8 (xLSTM[7:1]); the rest mLSTM with
chunkwise-parallel training.  O(1) decode state: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    mlp_type="none",
    norm_type="layernorm",
    pos_type="none",
    slstm_every=8,
    proj_factor=2.0,
    mlstm_chunk=128,
    conv_width=4,
    tie_embeddings=True,
    use_scan=True,  # period-scan over (7x mLSTM + sLSTM) groups
    source="arXiv:2405.04517; unverified",
)


def smoke() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=256, slstm_every=3, mlstm_chunk=16, remat="none",
    )
