"""Open-loop load generator: seeded Poisson arrivals over bursty phases.

A copy of the JAX package's ``repro.serve.loadgen`` (numpy only), with the
same names and dataclasses, so that a trace compares field by field.

Real serving traffic is not a fixed ``--requests`` list: requests arrive
on their own clock (open loop — arrivals do not wait for completions),
rates burst, and prompt/output lengths are mixed.  This module synthesizes
that shape deterministically: a seeded :func:`numpy.random.default_rng`
drives exponential inter-arrival times per :class:`Phase` (piecewise-
constant rate — the bursty pattern), categorical prompt/output length
mixtures, and an optional shared system prompt (``shared_prefix_len``
identical leading tokens on a ``shared_frac`` fraction of requests — the
traffic shape copy-on-write prefix sharing exists for).

Everything is derived from ``LoadGenConfig.seed``: the same config always
yields the same offered trace, which is what makes the scheduler's SLO
reports and the ``serve_slo`` bench gates reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Phase", "LoadGenConfig", "OfferedRequest", "generate"]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One piecewise-constant arrival-rate segment."""

    duration_s: float
    rate_rps: float

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        if self.rate_rps < 0:
            raise ValueError("rate_rps must be >= 0")


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """Knobs of one offered-traffic trace (fully seeded — deterministic)."""

    seed: int = 0
    #: bursty arrival profile: steady -> burst -> steady by default
    phases: tuple = (
        Phase(duration_s=4.0, rate_rps=2.0),
        Phase(duration_s=1.0, rate_rps=8.0),
        Phase(duration_s=4.0, rate_rps=2.0),
    )
    #: prompt-length mixture (categorical over ``prompt_lens``)
    prompt_lens: tuple = (8, 24, 48)
    prompt_mix: tuple = (0.5, 0.3, 0.2)
    #: output-length mixture
    gen_lens: tuple = (4, 8, 16)
    gen_mix: tuple = (0.5, 0.3, 0.2)
    #: shared system prompt: this many identical leading tokens on a
    #: ``shared_frac`` fraction of requests (0 disables)
    shared_prefix_len: int = 0
    shared_frac: float = 1.0
    vocab_size: int = 256

    def __post_init__(self) -> None:
        if not self.phases:
            raise ValueError("at least one phase is required")
        if len(self.prompt_lens) != len(self.prompt_mix):
            raise ValueError("prompt_lens and prompt_mix must align")
        if len(self.gen_lens) != len(self.gen_mix):
            raise ValueError("gen_lens and gen_mix must align")
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError("shared_frac must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class OfferedRequest:
    """One offered request: when it arrives and what it asks for."""

    arrival_s: float
    prompt: np.ndarray  # (s,) int32
    gen: int
    #: True when the prompt starts with the trace's shared system prompt
    shared: bool


def _normalized(mix: Sequence[float]) -> np.ndarray:
    w = np.asarray(mix, np.float64)
    if w.sum() <= 0:
        raise ValueError("mixture weights must sum to > 0")
    return w / w.sum()


def generate(cfg: LoadGenConfig) -> list[OfferedRequest]:
    """The offered trace: arrival-sorted requests over the phase profile."""
    rng = np.random.default_rng(cfg.seed)
    shared_prefix = None
    if cfg.shared_prefix_len > 0:
        shared_prefix = rng.integers(
            1, cfg.vocab_size, size=cfg.shared_prefix_len, dtype=np.int32
        )
    p_mix = _normalized(cfg.prompt_mix)
    g_mix = _normalized(cfg.gen_mix)

    out: list[OfferedRequest] = []
    phase_start = 0.0
    for phase in cfg.phases:
        phase_end = phase_start + phase.duration_s
        if phase.rate_rps > 0:
            t = phase_start
            while True:
                # open loop: exponential inter-arrival at the phase rate,
                # independent of anything the server does
                t += rng.exponential(1.0 / phase.rate_rps)
                if t >= phase_end:
                    break
                plen = int(rng.choice(cfg.prompt_lens, p=p_mix))
                gen = int(rng.choice(cfg.gen_lens, p=g_mix))
                shared = (
                    shared_prefix is not None
                    and rng.random() < cfg.shared_frac
                )
                if shared:
                    tail = rng.integers(
                        1, cfg.vocab_size,
                        size=max(0, plen - len(shared_prefix)),
                        dtype=np.int32,
                    )
                    prompt = np.concatenate([shared_prefix, tail])[:plen]
                else:
                    prompt = rng.integers(
                        1, cfg.vocab_size, size=plen, dtype=np.int32
                    )
                out.append(
                    OfferedRequest(
                        arrival_s=t,
                        prompt=np.asarray(prompt, np.int32),
                        gen=gen,
                        shared=bool(shared),
                    )
                )
        phase_start = phase_end
    return out
