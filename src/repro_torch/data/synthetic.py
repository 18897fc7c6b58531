"""Deterministic synthetic LM batches: ``step index -> batch``, stateless.

Statelessness is a fault-tolerance property: after restart-from-checkpoint
at step S, batch S+1 is bit-identical to the batch the failed run would have
produced, so loss curves are reproducible across failures.

The task is the JAX package's (``data/synthetic.py``): each row repeats a
random period of ``induction_period`` tokens, 10% of positions are replaced
by noise, and tokens lie in ``[1, vocab)``, so a small model shows a real,
decreasing loss.  The JAX package draws with ``jax.random`` (threefry),
which this port cannot import; here an explicit ``torch.Generator`` seeded
from ``(seed, step)`` draws on the CPU.  The tokens therefore differ from
the JAX package's; the parity tests feed the JAX package's own batches, as
numpy, to both packages.  The draw order is fixed: the period, the noise
mask, the noise tokens, then a vision model's patch embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    induction_period: int = 16  # tokens repeat with this period (learnable)


def batch_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator that is a pure function of ``(seed, step)``."""
    return torch.Generator().manual_seed((seed * 0x9E3779B97F4A7C15 + step) % 2**63)


def synthetic_batch(cfg: ModelConfig, sc: SyntheticConfig, step: int) -> dict:
    """Batch for ``step`` (pure function of (seed, step)), on the CPU: int64
    ``tokens`` and ``targets`` of shape (global_batch, seq_len), in the JAX
    package's three kinds.

    A codebook model (``n_codebooks`` K) gets ``codes`` and ``targets``
    (B, K, S) instead: the token stream broadcast over the codebooks, modulo
    the vocabulary.  A vision model adds ``vision_embeds`` (B, max(S // 8,
    1), D) in the compute dtype, N(0, 0.02^2) patch embeddings drawn from the
    step's generator after the tokens; its targets stay (B, S) (the loss
    pads them over the prefix).  An M-RoPE model adds ``positions_3d``
    (B, 3, S + prefix) int32, ``arange`` in all three planes."""
    g = batch_generator(sc.seed, step)
    b, s, v, p = sc.global_batch, sc.seq_len, sc.vocab_size, sc.induction_period
    base = torch.randint(1, v, (b, p), generator=g)
    reps = (s + 2 * p - 1) // p
    seq = base.repeat(1, reps)[:, : s + 1]
    noise = torch.rand(seq.shape, generator=g) < 0.1
    seq = torch.where(noise, torch.randint(1, v, seq.shape, generator=g), seq)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    if cfg.n_codebooks:
        k = cfg.n_codebooks
        return {"codes": (tokens[:, None] % cfg.vocab_size).expand(b, k, s).contiguous(),
                "targets": (targets[:, None] % cfg.vocab_size).expand(b, k, s).contiguous()}
    batch = {"tokens": tokens.contiguous(), "targets": targets.contiguous()}
    s_img = 0
    if cfg.vision_embed:
        s_img = max(s // 8, 1)
        vis = torch.randn((b, s_img, cfg.d_model), generator=g) * 0.02
        batch["vision_embeds"] = vis.to(cfg.compute_dtype)
    if cfg.pos_type == "mrope":
        pos = torch.arange(s + s_img, dtype=torch.int32)
        batch["positions_3d"] = pos.expand(b, 3, s + s_img).contiguous()
    return batch
