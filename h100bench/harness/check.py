"""Whether what the timed path served is correct: the served tokens of a
sample of the window's requests, drawn from the seed, held against the plain
reference run over each prompt with its served tokens.

The numbers compared (each against the cell's limit in ``cells/<cell>.json``):

- ``max_logit_gap``: the widest gap by which a served token's logit lies
  below the reference's best logit at its position;
- ``mean_logit_gap``: that gap's mean over every compared token;
- ``p90_logit_gap``: its 90th percentile over every compared token (0 while
  fewer than a tenth of the tokens fall below the reference's best).

A cell's limits file names the numbers it compares; the others are noted.

The control (``control=True``) reads the same numbers for the tokens that
the reference computed in float8 puts first at each position.
"""
from __future__ import annotations

import numpy as np
import torch

from . import stats, traffic, weights
from ..reference.model import Reference, gaps


def sample(window, seed: int, n: int, finished_only: bool) -> list:
    """Up to ``n`` requests that served tokens inside the window (finished
    ones only, if so asked), drawn from the seed, always with the one that
    served the most."""
    pool = [s for s in stats.in_window(window)
            if any(0.0 <= t <= window.seconds for t in s.token_s)
            and (s.done or not finished_only)]
    if not pool:
        return []
    longest = max(pool, key=lambda s: (len(s.tokens), -s.index))
    rest = [s for s in pool if s is not longest]
    rng = traffic.rng_of(seed, 2)
    pick = rng.permutation(len(rest))[: max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _numbers(g: torch.Tensor) -> dict:
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "p90_logit_gap": stats.percentile(g.tolist(), 90)}


def compare(config: dict, prompts: dict, picked: list, seed: int, device,
            control: bool = False) -> dict:
    """``(numbers, detail)``: the compared numbers of ``picked`` (``Served``),
    whose prompts are ``prompts[index]``, with ``control`` the control's
    beside them (``control_*``); ``detail`` holds every token's gap."""
    ref = Reference(config)
    seqs = [(prompts[s.index], s.tokens) for s in picked]
    loads = {}

    def on_route(j, li, top_i):
        # the most prompt tokens any one expert takes in this layer
        p = len(seqs[j][0])
        counts = torch.bincount(top_i[:p].reshape(-1), minlength=ref.E)
        loads[(j, li)] = int(counts.max())

    out = ref.served_logits(seqs, weights.shell(config, seed, device),
                            lambda i: weights.layer(config, seed, i, device),
                            config["num_hidden_layers"], device, control=control,
                            on_route=on_route)
    g = torch.cat([gaps(r, toks) for (r, _), (_, toks) in zip(out, seqs)])
    res = {**_numbers(g), "tokens_compared": int(g.numel()), "requests_compared": len(seqs)}
    detail = {"gaps": g.tolist()}
    if control:
        cg = torch.cat([gaps(r, c.argmax(dim=-1).tolist()) for r, c in out])
        res.update({f"control_{k}": v for k, v in _numbers(cg).items()})
        detail["control_gaps"] = cg.tolist()
        # the reference's own margin between its best two logits
        detail["margins"] = torch.cat([r.topk(2, dim=-1).values.diff(dim=-1).neg()[:, 0]
                                       for r, _ in out]).tolist()
    if loads:
        share = [loads[(j, li)] / len(seqs[j][0]) for j, li in loads]
        res["max_expert_prompt_share"] = float(np.max(share))
    return res, detail


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each compared number beside its limit."""
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    ok = numbers.get("tokens_compared", 0) > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
