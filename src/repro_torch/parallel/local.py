"""The kernel boundary under a mesh: a DTensor's local shard at a layout
the computation can run on alone.

The CUDA wrappers take raw pointers, so they need local, contiguous
tensors, and a few ops of the layer body (the rotary rotation's half
split, the cache writes at per-slot positions) have no DTensor sharding
strategy over every layout the plans give.  Attention therefore runs on
local shards at :func:`attention_placements`: the batch over the mesh's
non-``model`` axes and the heads over ``model`` where both the query and
the KV heads divide it, else replicated over ``model`` (the serve plan
shards a one-KV-head cache's ``head_dim`` or sequence, over which the
attention's contraction is not local).  :func:`to_local_at` redistributes
there, the function runs on the local tensors, and :func:`rewrap` returns
its result as a DTensor of that layout.  A cache at another layout is
written back to its own (:func:`write_back`), so in-place updates land.

The blocks whose ops DTensor has no strategy for (the RG-LRU's causal
convolution and scan, the xLSTM cells, the MoE dispatch's scatter) run
whole on full tensors (:func:`on_full`): every DTensor argument is
replicated (the differentiable ``redistribute``), the block runs on the
local copies, and its outputs come back replicated.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["is_dtensor", "attention_placements", "to_local_at", "rewrap", "write_back",
           "local_range", "full_local", "on_full"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def attention_placements(mesh, batch: int, n_heads: int, n_kv_heads: int,
                         model_axis: str = "model") -> tuple:
    """Placements of ``(B, S, heads, H)`` tensors for a local attention: per
    mesh dim, the batch (dim 0) over a non-``model`` axis that divides it,
    the heads (dim 2) over ``model`` when it divides both head counts, else
    ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    out = []
    b = batch
    for name, size in zip(names, mesh.shape):
        if name == model_axis:
            heads = n_heads % size == 0 and n_kv_heads % size == 0
            out.append(Shard(2) if heads and size > 1 else Replicate())
        elif b % size == 0 and size > 1:
            out.append(Shard(0))
            b //= size
        else:
            out.append(Replicate())
    return tuple(out)


def to_local_at(x, placements: Sequence) -> torch.Tensor:
    """The local shard of DTensor ``x`` at ``placements`` (redistributed
    when its own differ; the same storage when they agree), contiguous."""
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local().contiguous()


def rewrap(local: torch.Tensor, mesh, placements: Sequence, shape) -> "torch.Tensor":
    """``local`` as the rank's shard of a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, placements, shape=torch.Size(shape), stride=stride,
                              run_check=False)


def write_back(orig, local: torch.Tensor, placements: Sequence) -> None:
    """Store ``local`` (the rank's shard at ``placements``) into DTensor
    ``orig`` in place, at ``orig``'s own placements."""
    if tuple(orig.placements) == tuple(placements):
        dst = orig.to_local()
        if dst.data_ptr() != local.data_ptr():
            dst.copy_(local)
        return
    new = rewrap(local, orig.device_mesh, placements, orig.shape)
    orig.to_local().copy_(new.redistribute(orig.device_mesh, orig.placements).to_local())


def local_range(mesh, placements: Sequence, shape, dim: int) -> tuple[int, int]:
    """``(offset, length)`` of the rank's shard along ``dim`` of a tensor of
    global ``shape`` at ``placements``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    lshape, off = compute_local_shape_and_global_offset(tuple(shape), mesh, placements)
    return int(off[dim]), int(lshape[dim])


def full_local(x) -> Optional[torch.Tensor]:
    """A DTensor's full value as a plain tensor (an all-gather), else ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def on_full(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on full tensors: with a DTensor among the
    arguments (nested dicts, tuples and lists included), every DTensor is
    replicated over its mesh and taken local, and every tensor ``fn``
    returns becomes a replicated DTensor on that mesh; the gradients flow
    back through both.  Without one, ``fn`` runs as is."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core import tree as tr

    leaves = tr.leaves((args, kwargs))
    mesh = next((x.device_mesh for x in leaves if is_dtensor(x)), None)
    if mesh is None:
        return fn(*args, **kwargs)
    rep = [Replicate()] * mesh.ndim

    def full(x):
        return x.redistribute(mesh, rep).to_local() if is_dtensor(x) else x

    def wrap(x):
        if isinstance(x, torch.Tensor) and not is_dtensor(x):
            return DTensor.from_local(x, mesh, rep, run_check=False)
        return x

    args, kwargs = tr.tree_map(full, (args, kwargs))
    return tr.tree_map(wrap, fn(*args, **kwargs))
