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
numpy, to both packages.
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
    """Batch for ``step`` (pure function of (seed, step)): int64 ``tokens``
    and ``targets`` of shape (global_batch, seq_len), on the CPU."""
    if cfg.n_codebooks or cfg.vision_embed or cfg.pos_type == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: synthetic codebook / vision / M-RoPE batches are not ported yet "
            "(ROADMAP.md, queue 1 item 7: the other model families)"
        )
    g = batch_generator(sc.seed, step)
    b, s, v, p = sc.global_batch, sc.seq_len, sc.vocab_size, sc.induction_period
    base = torch.randint(1, v, (b, p), generator=g)
    reps = (s + 2 * p - 1) // p
    seq = base.repeat(1, reps)[:, : s + 1]
    noise = torch.rand(seq.shape, generator=g) < 0.1
    seq = torch.where(noise, torch.randint(1, v, seq.shape, generator=g), seq)
    return {"tokens": seq[:, :-1].contiguous(), "targets": seq[:, 1:].contiguous()}
