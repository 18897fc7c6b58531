"""Parameters from the JAX package's tree, as numpy arrays.

The tests feed both packages the same weights: the JAX package initialises
them, ``jax.tree.map(np.asarray, params)`` turns them into numpy, and
:func:`params_from_numpy` builds the port's parameters from that tree, name
for name (``{"blocks": {"attn": {"wq": ...}}}`` -> ``blocks.attn.wq``), in
each of the JAX tree's layouts: stacked uniform blocks, the hybrid's period
tree (``blocks.periods.pos_0.rec.w_a``, ``blocks.tail_1.mlp.wi``) and
unrolled blocks (``blocks.layer_000...``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import init_model


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the array's values and dtype.  numpy has no bf16:
    an array whose dtype is named ``bfloat16`` (ml_dtypes, as JAX hands it
    out) is reinterpreted through ``uint16``.  The array is copied first:
    ``np.asarray`` of a JAX array is read-only."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_to_torch(tree: Mapping) -> dict:
    return {
        k: _tree_to_torch(v) if isinstance(v, Mapping) else tensor_from_numpy(v)
        for k, v in tree.items()
    }


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device: DeviceLike = None) -> ParamTree:
    """The port's parameters from the JAX package's parameter tree (numpy
    leaves), on ``device`` (the card unless ``"cpu"``; without a card
    ``None`` raises, as every entry point does).  Names and shapes must be
    exactly the port's for ``cfg``; dtypes are kept (bf16 serving params
    stay bf16)."""
    dev = resolve_device(device)
    params = ParamTree(_tree_to_torch(tree))
    want = {n: p.shape for n, p in init_model(cfg, generator(0), "meta").named_parameters()}
    have = {n: p.shape for n, p in params.named_parameters()}
    if want.keys() != have.keys():
        raise ValueError(
            f"parameter names differ: missing {sorted(want.keys() - have.keys())}, "
            f"unexpected {sorted(have.keys() - want.keys())}"
        )
    bad = {n: (have[n], want[n]) for n in want if have[n] != want[n]}
    if bad:
        raise ValueError(f"parameter shapes differ (have, want): {bad}")
    return params.to(dev)
