"""The system under test: the port's ``ServeSession``, built from a
configuration file and fed the benchmark's own weights.

This is the one harness module that imports the program (``repro_torch``).
It maps the published keys of a configuration file onto the port's
``ModelConfig`` and the benchmark's weights onto the port's parameter tree.
"""
from __future__ import annotations

import dataclasses
import inspect
import sys

import torch

from . import spec, weights

#: where the program lives in a checkout
sys.path.insert(0, str(spec.ROOT / "src"))


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: its registered
    config of the same architecture, with every size the file gives and the
    file's ``port`` settings (the attention kernels, and so on).  Where the
    port cannot run what the file states, the file records the departure
    under ``port.departs``."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    eps = inspect.signature(layers.norm_apply).parameters["eps"].default
    stated = config["port"].get("departs", {}).get("rms_norm_eps", {}).get(
        "port", config["rms_norm_eps"])
    if stated != eps:  # a departure the file does not record
        raise ValueError(f"the port's RMSNorm eps is {eps}; the configuration states "
                         f"{config['rms_norm_eps']} and records no such departure")
    d = weights.dims(config)
    kw = dict(n_layers=d["L"], d_model=d["D"], n_heads=d["N"], n_kv_heads=d["K"],
              head_dim=d["H"], d_ff=d["F"], vocab_size=d["V"], rope_theta=config["rope_theta"],
              tie_embeddings=config["tie_word_embeddings"])
    if d["E"]:
        kw.update(n_experts=d["E"], moe_top_k=config["num_experts_per_tok"])
    kw.update(config["port"]["set"])
    return dataclasses.replace(get_config(config["port"]["config"]), **kw)


def _blocks(cfg, stacked: dict) -> dict:
    """The port's ``blocks`` tree over the layer-stacked published leaves
    (views, no copies)."""
    L, D, N, K, H = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ffn = {"wi": stacked["w1"], "wg": stacked["w3"], "wo": stacked["w2"]}
    if cfg.n_experts:
        ffn["router"] = stacked["router"]
    return {
        "ln1": {"scale": stacked["attn_norm"]},
        "attn": {"wq": stacked["wq"].view(L, D, N, H), "wk": stacked["wk"].view(L, D, K, H),
                 "wv": stacked["wv"].view(L, D, K, H), "wo": stacked["wo"].view(L, N, H, D)},
        "ln2": {"scale": stacked["ffn_norm"]},
        "moe" if cfg.n_experts else "mlp": ffn,
    }


def make_params(cfg, config: dict, seed: int, device, home: str):
    """The weights from ``seed``, drawn layer by layer on ``device`` into
    layer-stacked leaves.

    ``home="device"``: the port's ``ParamTree`` on the card.  ``"host"``: a
    nested dict of host tensors, each layer moved off the card as soon as it
    is drawn (the card never holds the model), which the session homes at
    its ``param_kind``."""
    from repro_torch.models.layers import ParamTree

    where = "cpu" if home == "host" else device
    stacked = {n: torch.empty((cfg.n_layers, *shape), dtype=weights.DTYPE, device=where)
               for n, (shape, _) in weights.layer_leaves(config).items()}
    for i in range(cfg.n_layers):
        for n, t in weights.layer(config, seed, i, device).items():
            stacked[n][i].copy_(t)
    sh = {n: t.to(where) for n, t in weights.shell(config, seed, device).items()}
    tree = {"embed": {"tok": sh["embed"]}, "ln_f": {"scale": sh["final_norm"]},
            "head": {"out": sh["lm_head"]}, "blocks": _blocks(cfg, stacked)}
    return tree if home == "host" else ParamTree(tree)


def open_session(cfg, args: dict, params, device):
    from repro_torch.launch.serve import ServeSession

    return ServeSession(cfg, params=params, device=device, **args)
