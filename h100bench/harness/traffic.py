"""The one traffic generator: a traffic file's parameters and ``--seed``
give the requests of a run.

Every seed gets the same set of sizes and, in an open loop, the same set of
gaps between arrivals, in another order: the lengths are the quantiles of
their distribution and the gaps the quantiles of the exponential at the
phase's rate (the arithmetic of a Poisson process, as the port's
``serve/loadgen.py`` draws it, made exact so that seeds differ only in
order and token ids).  So runs of different seeds do the same work.

Parameters (a traffic file):

- ``loop``: ``"closed"`` (``slots`` requests in flight, a finished one
  replaced at once) or ``"open"`` (requests due on their own clock).
- ``slots``: the session's batch lanes.
- ``prompt_len``, ``output_len``: ``[lo, hi]`` tokens, drawn log-uniformly
  (``"dist": "log_uniform"``, the default) or uniformly (``"uniform"``).
- ``pool``: requests in a closed loop's pool (cycled if exhausted), a
  multiple of ``slots``.  The pool runs in rounds of ``slots`` requests,
  each round one request from each of ``slots`` strata of the lengths, in
  an order fixed for every seed: a window of any seed fills its slots with
  the same sizes at the same times, and the seed changes only which slot
  takes which, the pairing of prompt and output lengths, and the ids.
- ``phases``: open loop, ``[{"share": s, "rate_rps": r}, ...]``: the window
  split by share, each part with its own steady rate.
- ``shared_prefix_len``, ``shared_frac``: optional shared leading tokens on
  a share of the prompts (the prefix cache's traffic).
- ``prime_s``: seconds the traffic runs in the set-up before the window
  opens (an open loop: arrivals at the first phase's rate), so that the
  window starts on a session under its load.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One offered request.  ``due_s`` is when it is due, from the window's
    start (``None`` in a closed loop: due when a slot frees)."""

    index: int
    prompt: np.ndarray
    gen: int
    due_s: Optional[float] = None


def rng_of(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator from a seed of any size (negative too) and tags."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), *tags]))


def quantile_lengths(lo: int, hi: int, n: int, dist: str = "log_uniform") -> np.ndarray:
    """``n`` lengths in ``[lo, hi]`` at the mid-quantiles of the distribution."""
    u = (np.arange(n) + 0.5) / n
    if dist == "log_uniform":
        x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif dist == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps at the mid-quantiles of the exponential at ``rate``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def arrivals(phases: list, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times over the window: each phase takes its share of ``seconds``
    and ``round(rate * length)`` arrivals, whose gaps are the exponential's
    quantiles in the seed's order, scaled so that the phase's last arrival
    falls half a mean gap before its end."""
    shares = np.array([float(p["share"]) for p in phases])
    bounds = np.concatenate([[0.0], np.cumsum(shares / shares.sum())]) * seconds
    out = []
    for p, t0, t1 in zip(phases, bounds[:-1], bounds[1:]):
        rate = float(p["rate_rps"])
        n = int(round(rate * (t1 - t0)))
        if n == 0:
            continue
        gaps = rng.permutation(exponential_gaps(rate, n))
        t = np.cumsum(gaps)
        out.append(t0 + t * (t1 - t0) / (t[-1] + 0.5 * (t1 - t0) / n))
    return np.concatenate(out) if out else np.zeros(0)


def rounds(sorted_lengths: np.ndarray, slots: int, rng: np.random.Generator) -> np.ndarray:
    """A closed loop's pool order: round ``r`` holds the ``r``-th length of
    each of ``slots`` strata (the sorted lengths cut in ``slots`` runs), the
    rounds in one order fixed for every seed, the members of a round in the
    seed's order."""
    n = len(sorted_lengths)
    if n % slots:
        raise ValueError(f"pool {n} is not a multiple of the {slots} slots")
    per = n // slots
    fixed = np.random.default_rng(0).permutation(per)
    out = [rng.permutation(sorted_lengths[np.arange(slots) * per + r]) for r in fixed]
    return np.concatenate(out)


def generate(spec: dict, seed: int, seconds: float, vocab: int, part: int = 0) -> list:
    """The requests of ``seconds`` of traffic, in the order they are offered;
    ``part`` picks an independent draw of the same seed."""
    rng = rng_of(seed, 1, part) if part else rng_of(seed, 1)
    dist = spec.get("dist", "log_uniform")
    if spec["loop"] == "closed":
        n = int(spec["pool"])
        due = None
        prompts = rounds(quantile_lengths(*spec["prompt_len"], n, dist), int(spec["slots"]), rng)
        gens = rounds(quantile_lengths(*spec["output_len"], n, dist), int(spec["slots"]), rng)
    elif spec["loop"] == "open":
        due = arrivals(spec["phases"], seconds, rng)
        n = len(due)
        prompts = rng.permutation(quantile_lengths(*spec["prompt_len"], n, dist))
        gens = rng.permutation(quantile_lengths(*spec["output_len"], n, dist))
    else:
        raise ValueError(f"unknown loop {spec['loop']!r}")
    shared_len = int(spec.get("shared_prefix_len", 0))
    shared = rng.integers(1, vocab, size=shared_len, dtype=np.int32) if shared_len else None
    frac = float(spec.get("shared_frac", 1.0))
    out = []
    for i in range(n):
        ids = rng.integers(1, vocab, size=int(prompts[i]), dtype=np.int32)
        if shared is not None and rng.random() < frac:
            k = min(shared_len, len(ids))
            ids[:k] = shared[:k]
        out.append(Request(i, ids, int(gens[i]), None if due is None else float(due[i])))
    return out


def timeline(spec: dict, seed: int, seconds: float, vocab: int, after: float = 0.0) -> tuple:
    """``(requests, start)``: a run's requests, numbered in the order offered,
    and the loop's start (``-prime_s``).  An open loop's are the priming
    arrivals at the first phase's rate, due before 0, the window's, and
    ``after`` seconds more of the window's mix (a traced window that
    follows it), each part its own fixed set of sizes and gaps; a closed
    loop's are its pool."""
    start = -float(spec.get("prime_s", 0.0))
    if spec["loop"] == "closed":
        return generate(spec, seed, seconds, vocab), start
    parts = [(generate(spec, seed, seconds, vocab), 0.0)]
    if start < 0:
        first = dict(spec, phases=[{"share": 1.0, "rate_rps": spec["phases"][0]["rate_rps"]}])
        parts.insert(0, (generate(first, seed, -start, vocab, part=1), start))
    if after > 0:
        parts.append((generate(spec, seed, after, vocab, part=2), seconds))
    out = [dataclasses.replace(r, index=0, due_s=r.due_s + shift)
           for reqs, shift in parts for r in reqs]
    for k, r in enumerate(out):
        r.index = k
    return out, start
