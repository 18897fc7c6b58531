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
none.  :func:`init_from_env` joins the group ``torchrun`` describes, as the
launchers do.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: how long a rank waits for the others at the rendezvous and at every
#: collective before it fails (a hung peer fails the run, not the machine)
GROUP_TIMEOUT_S = 60


def init_from_env(device: DeviceLike = None, timeout_s: float = GROUP_TIMEOUT_S) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``;
    ``torchrun --standalone`` on localhost): NCCL on the card, each rank on
    its ``LOCAL_RANK`` card, gloo with ``device="cpu"``.  Returns False, and
    opens nothing, when the environment names no group (a plain
    ``python -m`` run); True when a group exists afterwards."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    device_type = torch.device("cuda" if device is None else device).type
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    resolve_device(device)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_rank0() -> bool:
    """True without a group and on rank 0 of one: the rank that writes
    files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


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
