"""AdamW with f32 master weights and memkind-placeable moments.

The JAX package's ``optim/adamw.py``, op for op.  State layout per
parameter leaf: ``{"master": f32, "m": f32, "v": f32}`` plus a global
``{"step": int32}``.  The *memory kind* of the state (device, pinned host,
disk) is the launcher's placement policy — the paper's one-line placement
change applied to the largest state group of training.

Params are stored and computed in ``cfg.dtype`` (bf16); the update runs in
f32 against the master copy and is cast back.  Every leaf's update is the
same eager sequence of element-wise ops, in the reference's order, so a
group-wise (streamed) update gives the bits of the whole-tree one.
``torch.optim.AdamW`` is not used: its bias correction, clipping and cast
differ from the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as tr
from repro_torch.optim.schedule import cosine_schedule

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    min_lr_ratio: float = 0.1


def adamw_init(params: Pytree) -> dict:
    """Optimizer state matching ``params`` (f32 master + moments), on the
    parameters' devices; ``step`` on the first leaf's."""
    def leaf(p: torch.Tensor) -> dict:
        return {
            "master": p.to(torch.float32, copy=True),
            "m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        }

    flat = tr.leaves(params)
    dev = flat[0].device if flat else None
    return {"leaves": tr.tree_map(leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_bytes(params: Pytree) -> int:
    """Bytes the AdamW state for ``params`` occupies (3 f32 copies per leaf)
    — what a host-RAM budget compares against when deciding how much of the
    state spills to the ``DiskHost`` tier."""
    return sum(3 * 4 * int(np.prod(tuple(p.shape))) for p in tr.leaves(params))


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tr.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_globals(cfg: AdamWConfig, grads: Pytree, step) -> dict:
    """Scalar quantities shared by every leaf at (1-based) ``step``, on the
    gradients' device.  The streamed optimizer computes them once up front
    and applies :func:`adamw_leaf_update` group by group."""
    return adamw_globals_from_norm(cfg, global_norm(grads), step)


def adamw_globals_from_norm(cfg: AdamWConfig, grad_norm, step) -> dict:
    """:func:`adamw_globals` with the global gradient norm already reduced."""
    gnorm = torch.as_tensor(grad_norm).to(torch.float32)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = cosine_schedule(
        step,
        peak_lr=cfg.peak_lr,
        warmup_steps=cfg.warmup_steps,
        total_steps=cfg.total_steps,
        min_ratio=cfg.min_lr_ratio,
    )
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    fstep = step.to(torch.float32)
    return {
        "lr": lr,
        "grad_norm": gnorm,
        "scale": scale,
        "bc1": 1.0 - cfg.b1 ** fstep,
        "bc2": 1.0 - cfg.b2 ** fstep,
    }


def adamw_leaf_update(cfg: AdamWConfig, glob: dict, g: torch.Tensor, s: dict) -> tuple:
    """One parameter leaf's AdamW update given the step globals.

    Returns ``(new_master_f32, new_state_leaf)``."""
    g = g.to(torch.float32) * glob["scale"]
    m = cfg.b1 * s["m"] + (1 - cfg.b1) * g
    v = cfg.b2 * s["v"] + (1 - cfg.b2) * g * g
    upd = (m / glob["bc1"]) / (torch.sqrt(v / glob["bc2"]) + cfg.eps)
    master = s["master"] * (1.0 - glob["lr"] * cfg.weight_decay) - glob["lr"] * upd
    return master, {"master": master, "m": m, "v": v}


def adamw_update(
    cfg: AdamWConfig,
    grads: Pytree,
    opt_state: dict,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[Pytree, dict, dict]:
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    ``new_params`` leaves are cast to ``compute_dtype`` (the master stays
    f32 inside the state)."""
    step = opt_state["step"] + 1
    glob = adamw_globals(cfg, grads, step)
    flat_g, treedef = tr.flatten(grads)
    flat_s = tr.flatten(opt_state["leaves"], is_leaf=is_state_leaf)[0]
    if len(flat_s) != len(flat_g):
        raise ValueError(f"{len(flat_s)} optimizer state leaves for {len(flat_g)} gradients")
    out = [adamw_leaf_update(cfg, glob, g, s) for g, s in zip(flat_g, flat_s)]
    new_params = tr.unflatten(treedef, [p.to(compute_dtype) for p, _ in out])
    new_leaves = tr.unflatten(treedef, [s for _, s in out])
    metrics = {"grad_norm": glob["grad_norm"], "lr": glob["lr"]}
    return new_params, {"leaves": new_leaves, "step": step}, metrics


def is_state_leaf(x: Any) -> bool:
    """True for one parameter's ``{"master", "m", "v"}`` state dict."""
    return isinstance(x, dict) and {"master", "m", "v"} <= set(x)

