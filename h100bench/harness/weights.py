"""The weights of a run, made from ``--seed`` on the device in the type they
are served in.

Each leaf of each layer has its own generator, seeded from ``(seed, leaf,
layer)``, so any one of them can be drawn again alone: the program gets
them at set-up, and the reference draws each layer again once the window
has closed (it takes nothing the program holds).  The names and layouts are
the published ones (Mixtral's ``w1`` gate, ``w3`` up, ``w2`` down), each
matrix oriented for ``x @ W``.

Scales: token embedding N(0, 1) (so that the first layer's input has the
size later layers keep; the norm that follows removes the scale anyway),
projections ``fan_in ** -0.5`` so that activations keep their size through
depth, norm scales ``1 + 0.1 N(0, 1)`` so that a dropped scale shows.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

DTYPE = torch.bfloat16


def dims(c: dict) -> dict:
    """The sizes the weights need, from a configuration file's published keys."""
    d = dict(D=c["hidden_size"], N=c["num_attention_heads"], K=c["num_key_value_heads"],
             H=c["head_dim"], F=c["intermediate_size"], V=c["vocab_size"],
             L=c["num_hidden_layers"], E=c.get("num_local_experts", 0))
    return d


def shell_leaves(c: dict) -> dict:
    """``name -> (shape, std)`` of the leaves outside the layers (std
    ``None``: a norm scale)."""
    d = dims(c)
    return {"embed": ((d["V"], d["D"]), 1.0),
            "final_norm": ((d["D"],), None),
            "lm_head": ((d["D"], d["V"]), d["D"] ** -0.5)}


def layer_leaves(c: dict) -> dict:
    """``name -> (shape, std)`` of one layer's leaves."""
    d = dims(c)
    D, N, K, H, F, E = d["D"], d["N"], d["K"], d["H"], d["F"], d["E"]
    out = {"attn_norm": ((D,), None),
           "wq": ((D, N * H), D ** -0.5),
           "wk": ((D, K * H), D ** -0.5),
           "wv": ((D, K * H), D ** -0.5),
           "wo": ((N * H, D), (N * H) ** -0.5),
           "ffn_norm": ((D,), None)}
    if E:
        out.update({"router": ((D, E), D ** -0.5),
                    "w1": ((E, D, F), D ** -0.5),
                    "w3": ((E, D, F), D ** -0.5),
                    "w2": ((E, F, D), F ** -0.5)})
    else:
        out.update({"w1": ((D, F), D ** -0.5),
                    "w3": ((D, F), D ** -0.5),
                    "w2": ((F, D), F ** -0.5)})
    return out


def leaf_seed(seed: int, name: str, layer: int) -> int:
    """The generator seed of one leaf of one layer (``layer`` -1: the shell)."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), zlib.crc32(name.encode()), layer + 1])
    return int(ss.generate_state(1, np.uint64)[0])


def draw(shape: tuple, std, seed: int, device) -> torch.Tensor:
    """One leaf in bf16 on ``device``: ``N(0, std)``, or ``1 + 0.1 N(0, 1)``
    for a norm scale (``std`` None)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.empty(shape, dtype=DTYPE, device=device)
    if std is None:
        return t.normal_(1.0, 0.1, generator=g)
    return t.normal_(0.0, std, generator=g)


def shell(c: dict, seed: int, device) -> dict:
    return {n: draw(s, std, leaf_seed(seed, n, -1), device) for n, (s, std) in shell_leaves(c).items()}


def layer(c: dict, seed: int, i: int, device) -> dict:
    return {n: draw(s, std, leaf_seed(seed, n, i), device)
            for n, (s, std) in layer_leaves(c).items()}
