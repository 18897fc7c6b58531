"""Production mesh construction on ``torch.distributed``.

Functions (not module-level constants), so importing this module never
touches a process group.  A mesh is a ``DeviceMesh`` whose dims carry the
JAX package's axis names; its device type is ``cuda`` unless the caller
asks for ``cpu`` (without a card that request is the only way to get one:
:func:`~repro_torch.device.resolve_device` raises otherwise).

:func:`make_production_mesh` needs a process group of 256 (or 512) ranks
already initialised, real or fake (``init_process_group("fake", ...)``
gives shape-only ranks in one process, the counterpart of the JAX
package's placeholder devices); :func:`make_local_mesh` spans the ranks
that exist, opening a one-rank group over a ``HashStore`` when there is
none.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """16x16 = 256-rank pod (``data x model``) or 2x16x16 = 512-rank
    two-pod mesh (``pod x data x model``; ``pod`` is the slow axis)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = resolve_device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        found = f"world size {world}" if world else "no process group"
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs a process group of "
            f"{math.prod(shape)} ranks (real, or init_process_group('fake', ...)); found {found}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, device: DeviceLike = None):
    """``(world // model, model)`` ``("data", "model")`` mesh over the ranks
    that exist; a one-rank group (NCCL on the card, gloo on the CPU) over a
    ``HashStore`` is opened when none is."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world size {world}")
    return init_device_mesh(device_type, (world // model, model), mesh_dim_names=("data", "model"))
