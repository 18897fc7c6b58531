"""Parameters from the JAX package's tree, as numpy arrays.

The tests feed both packages the same weights: the JAX package initialises
them, ``jax.tree.map(np.asarray, params)`` turns them into numpy, and
:func:`params_from_numpy` builds the port's parameters from that tree, name
for name (``{"blocks": {"attn": {"wq": ...}}}`` -> ``blocks.attn.wq``), in
each of the JAX tree's layouts: stacked uniform blocks, the period trees of
the hybrid and the xLSTM stack (``blocks.periods.pos_0.rec.w_a``,
``blocks.tail_1.mlp.wi``, ``blocks.periods.pos_0.mlstm.w_up``) and unrolled
blocks (``blocks.layer_000...``, ``blocks.layer_002.slstm.r_z``).

The streamed-weight path carries its weights as a plan home
(``{"groups": {key: tree}}``, host numpy leaves):
:func:`home_from_numpy` turns the JAX package's home into the port's, leaf for
leaf.  A ``disk_host`` home needs no conversion: both packages write the same
spill chunks under the same ``wp/<group key>`` keys, so either package's plan
reads the other's (``store.get(plan.spill_key(g))``).

The AdamW state goes the same way: :func:`opt_state_from_numpy` builds the
port's device state (tensors) or host state (numpy, the streamed
optimizer's home) from the JAX package's, leaf for leaf, and
:func:`tree_to_numpy` turns any port tree back into numpy (bf16 as
``uint16`` under :class:`BF16HostArray`), the form the checkpoint tests hold
against the JAX package's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray, host_array
from repro_torch.core.spillstore import is_disk_leaf
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


def _host_leaf(a: np.ndarray) -> np.ndarray:
    """A home leaf as the port holds it: bf16 (ml_dtypes, as the JAX package
    hands it out) as a :class:`BF16HostArray` over a copy of the same bytes;
    every other dtype as a copy."""
    a = np.array(a, copy=True)
    return a.view(np.uint16).view(BF16HostArray) if a.dtype.name == "bfloat16" else a


def home_from_numpy(home: Mapping) -> dict:
    """The port's weight home from the JAX package's
    (``WeightStreamPlan.init_home``: ``{"groups": {key: tree}}`` of numpy
    leaves), with the same group keys, trees and bytes.  The port's
    ``init_home`` of the converted parameters
    (:func:`params_from_numpy`) equals it leaf for leaf."""
    def conv(tree):
        return {k: conv(v) if isinstance(v, Mapping) else _host_leaf(v) for k, v in tree.items()}

    return {"groups": conv(home["groups"])}


def weight_streamed_state_from_numpy(state: Mapping) -> dict:
    """The port's weight-streamed train state from the JAX package's
    (``init_weight_streamed_state``: ``{"params": {"groups"}, "opt":
    {"groups", "step"}}`` of numpy leaves): host numpy copies with the same
    group keys, trees and bytes."""
    return {"params": home_from_numpy(state["params"]),
            "opt": {"groups": home_from_numpy(state["opt"])["groups"],
                    "step": np.array(state["opt"]["step"], np.int32)}}


def opt_state_from_numpy(tree: Mapping, device: DeviceLike = None, *, host: bool = False) -> dict:
    """The port's AdamW state from the JAX package's (``adamw_init`` /
    ``host_opt_state``: ``{"leaves": {... {"master", "m", "v"}}, "step"}``
    with numpy leaves).  ``host=False``: tensors on ``device`` (the card
    unless ``"cpu"``), as the device-resident train step holds them;
    ``host=True``: numpy copies, as the streamed updater's home (spill-store
    views stay views: the chunks are shared)."""
    if host:
        def conv(t):
            if isinstance(t, Mapping):
                return {k: conv(v) for k, v in t.items()}
            return t if is_disk_leaf(t) else _host_leaf(t)

        return {"leaves": conv(tree["leaves"]), "step": np.array(tree["step"], np.int32)}
    dev = resolve_device(device)
    return {"leaves": tr.tree_map(lambda a: tensor_from_numpy(a).to(dev), dict(tree["leaves"])),
            "step": tensor_from_numpy(np.asarray(tree["step"], np.int32)).to(dev)}


def tree_to_numpy(tree):
    """A port tree (tensors on any device, or numpy) as numpy copies: the
    inverse of :func:`opt_state_from_numpy` and :func:`params_from_numpy`."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return host_array(x.detach().cpu().clone())
        return _host_leaf(np.asarray(x)) if not isinstance(x, BF16HostArray) else x.copy()

    return tr.tree_map(conv, tree.as_dict() if isinstance(tree, ParamTree) else tree)
