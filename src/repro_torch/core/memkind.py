"""Memory kinds for hierarchical memory placement (paper §3.2).

The paper's ``Host`` / ``Shared`` / ``Microcore`` *kind* objects declare where
in the hierarchy a tensor lives; kernels receive references whatever the
kind, and the kind carries the transfer mechanics.  Adding a level is just a
new ``MemKind`` subclass.  The levels, as the JAX package numbers them:

  level 0  ``Device``       a CUDA tensor in HBM.
  level 2  ``PinnedHost``   a page-locked CPU tensor (``pin_memory()``): the
                            only host memory a ``non_blocking`` H2D copy can
                            overlap compute from.
  level 3  ``UnpinnedHost`` a pageable CPU tensor.
  level 4  ``DiskHost``     memory-mapped chunks of a
                            :class:`~repro_torch.core.spillstore.SpillStore`;
                            no tensor lives there.  Data reaches the card
                            through the transfer engine's disk -> pinned
                            staging -> device pipeline, so placement resolves
                            it to its staging kind.

The kinds keep the JAX package's field names (``jax_kind`` is the kind's
name, ``jax_addressable`` whether a tensor can be placed there), so the
tests compare the same fields.

Placement on the CPU happens only when the caller asks for it
(``device="cpu"``).  There every level is the one CPU memory, as the JAX
package's CPU backend maps its host kinds onto device memory
(:func:`host_offload_supported` is False, :func:`resolve_kind` falls back to
``Device``); CPU-only torch cannot pin memory at all.  On the card a pin
that fails raises.  Under a mesh, :func:`sharding_for` gives a level's
DTensor layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import canonical, host_tensor
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "MemKind",
    "Device",
    "PinnedHost",
    "UnpinnedHost",
    "DiskHost",
    "PlacementPolicy",
    "ALL_DEVICE",
    "HOST_OPT",
    "HOST_PARAMS",
    "HOST_ALL",
    "DISK_OPT",
    "DISK_PARAMS",
    "all_kinds",
    "as_kind",
    "get_policy",
    "host_offload_supported",
    "kind_of",
    "resolve_kind",
    "place",
]


class MemKind:
    """A level of the memory hierarchy.  Subclass to add a level (paper §3.2:
    'To create a kind representing a new level in the memory hierarchy
    requires a new Python class, inheriting from the Kind class')."""

    #: the level's name (the JAX package's memory-kind string)
    jax_kind: str = "device"
    #: ordering in the hierarchy; higher = further from the compute units
    level: int = 0
    #: can the card's compute units load/store this level directly?
    directly_addressable: bool = True
    #: can a tensor be placed at this level at all?  ``False`` means the
    #: level exists only to the runtime (disk): placement uses
    #: ``staging_jax_kind`` and the transfer engine bridges the gap.
    jax_addressable: bool = True
    #: the kind data from this level is staged through on its way to the
    #: device (only meaningful when ``jax_addressable`` is False)
    staging_jax_kind: str = "pinned_host"

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"{type(self).__name__}(jax_kind={self.jax_kind!r}, level={self.level})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MemKind) and self.jax_kind == other.jax_kind

    def __hash__(self) -> int:
        return hash(self.jax_kind)


class Device(MemKind):
    """HBM — the paper's ``Microcore``/``Shared`` analogue (fast, bounded)."""

    jax_kind = "device"
    level = 0
    directly_addressable = True


class PinnedHost(MemKind):
    """Page-locked host DRAM, DMA-reachable but not addressable by the
    card's compute — the paper's ``Host`` kind."""

    jax_kind = "pinned_host"
    level = 2
    directly_addressable = False


class UnpinnedHost(MemKind):
    """Pageable host DRAM (slowest RAM tier; its copies cannot overlap)."""

    jax_kind = "unpinned_host"
    level = 3
    directly_addressable = False


class DiskHost(MemKind):
    """Disk/NVMe spill tier — a level no tensor can be placed at, streamed
    disk -> pinned staging -> device by the transfer engine
    (:mod:`repro_torch.core.spillstore` is its home representation)."""

    jax_kind = "disk_host"
    level = 4
    directly_addressable = False
    jax_addressable = False
    staging_jax_kind = "pinned_host"


DEVICE = Device()
PINNED_HOST = PinnedHost()
UNPINNED_HOST = UnpinnedHost()
DISK_HOST = DiskHost()

_KIND_BY_NAME = {
    "device": DEVICE,
    "pinned_host": PINNED_HOST,
    "unpinned_host": UNPINNED_HOST,
    "disk_host": DISK_HOST,
}


def all_kinds() -> tuple[MemKind, ...]:
    """Every registered hierarchy level, nearest-to-compute first."""
    return tuple(sorted(_KIND_BY_NAME.values(), key=lambda k: k.level))


def as_kind(kind: "MemKind | str | None") -> MemKind:
    if isinstance(kind, MemKind):
        return kind
    if kind is None:  # default placement reads back as no kind
        return DEVICE
    try:
        return _KIND_BY_NAME[kind]
    except KeyError:
        raise ValueError(
            f"unknown memory kind {kind!r}; expected one of {sorted(_KIND_BY_NAME)}"
        ) from None


def host_offload_supported(device: DeviceLike = None) -> bool:
    """True iff host kinds are distinct memories for ``device``: on a CUDA
    device (where page-locked memory is the pinned tier), not on the CPU."""
    return resolve_device(device).type == "cuda"


def resolve_kind(kind: "MemKind | str", *, device: DeviceLike = None,
                 allow_fallback: bool = True) -> MemKind:
    """Map a requested kind to one a tensor can be placed at on ``device``.

    Kinds no tensor lives at (``DiskHost``) first resolve to their staging
    kind; the extra level is the runtime's business (spill store + transfer
    engine).  On the CPU, host kinds then fall back to ``Device`` (one
    memory for every tier), as the JAX package's CPU backend does.
    """
    kind = as_kind(kind)
    if not kind.jax_addressable:
        kind = as_kind(kind.staging_jax_kind)
    if kind.jax_kind == "device":
        return kind
    if not allow_fallback or host_offload_supported(device):
        return kind
    return DEVICE


def kind_of(x: torch.Tensor) -> MemKind:
    """The level a tensor is at: device, pinned host or pageable host."""
    if x.device.type != "cpu":
        return DEVICE
    return PINNED_HOST if x.is_pinned() else UNPINNED_HOST


def _place_leaf(x: Any, kind: MemKind, dev: torch.device) -> torch.Tensor:
    t = host_tensor(x)
    if kind.jax_kind == "device":
        return t.to(dev)
    if kind.jax_kind == "pinned_host":
        if t.device.type == "cpu" and t.is_pinned():
            return t
        # one copy, straight into page-locked memory; raises where memory
        # cannot be pinned
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    # pageable host: a fresh copy if the source is device or pinned memory
    if t.device.type == "cpu" and not t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t)
    return out


def place(tree: Any, kind: Any = DEVICE, device: Any = None, mesh_kind: Any = None) -> Any:
    """Put every leaf of ``tree`` (tensors or numpy arrays) at a hierarchy
    level for ``device``.  A leaf already there is returned as it is.

    ``place(tree, mesh, specs, kind)`` (the JAX package's form: a
    ``DeviceMesh`` second) places under a mesh instead: ``specs`` is a
    matching tree of :class:`~repro_torch.parallel.sharding.P` (or one spec
    for every leaf) and each leaf goes to :func:`sharding_for` ``(mesh,
    spec, kind)`` (:meth:`Sharding.put`)."""
    if _is_mesh(kind):
        from repro_torch.parallel.sharding import P

        mesh, specs = kind, device
        level = mesh_kind if mesh_kind is not None else DEVICE
        if isinstance(specs, P):
            return tr.tree_map(sharding_for(mesh, specs, level).put, tree)
        flat, treedef = tr.flatten(specs, is_leaf=lambda s: isinstance(s, P))
        shardings = tr.unflatten(treedef, [sharding_for(mesh, s, level) for s in flat])
        return tr.tree_map(lambda x, s: s.put(x), tree, shardings)
    dev = resolve_device(device)
    kind = resolve_kind(kind, device=dev)
    return tr.tree_map(lambda x: _place_leaf(x, kind, dev), tree)


# ---------------------------------------------------------------------------
# Placement under a mesh
# ---------------------------------------------------------------------------
#
# A DTensor program runs one process per rank, each addressing its own
# device only, so a placement under a mesh is each rank's shard.  At the
# device kind that is a DTensor.  At a host kind it is the rank's local
# shard at that level with its placement (:class:`HostShard`): never a
# DTensor, because ``DTensor.from_local`` moves a local tensor of another
# device type onto the mesh's device.  Only the card's side (the engine,
# ``Sharding.put`` at the device kind) makes the DTensor.


def _is_mesh(x: Any) -> bool:
    return hasattr(x, "mesh_dim_names") and hasattr(x, "device_type")


@dataclasses.dataclass(frozen=True)
class HostShard:
    """The rank's shard of a ``shape``-shaped leaf held at a host level:
    ``local`` (a CPU tensor, page-locked at ``PinnedHost``) laid out by
    ``sharding``."""

    local: torch.Tensor
    sharding: "Sharding"
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout under a mesh at a hierarchy level: the port's
    ``NamedSharding(mesh, spec, memory_kind=...)``.  ``placements`` are the
    DTensor placements of the spec on ``mesh``."""

    mesh: Any
    placements: tuple
    kind: MemKind = DEVICE

    def local_slices(self, shape) -> tuple:
        """The rank's index range of a ``shape``-shaped leaf (its
        ``addressable_devices_indices_map`` entry)."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        lshape, off = compute_local_shape_and_global_offset(tuple(shape), self.mesh,
                                                            self.placements)
        return tuple(slice(o, o + n) for o, n in zip(off, lshape))

    def local_of(self, x: Any) -> torch.Tensor:
        """The rank's shard of ``x`` (a full host or device value, a
        DTensor, or a :class:`HostShard`) as a plain tensor, at this
        layout."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, HostShard):
            if tuple(x.sharding.placements) == tuple(self.placements):
                return x.local
            x = DTensor.from_local(x.local.to(self.mesh.device_type), x.sharding.mesh,
                                   x.sharding.placements, shape=torch.Size(x.shape),
                                   stride=torch.empty(x.shape, device="meta").stride(),
                                   run_check=False)
        if isinstance(x, DTensor):
            if tuple(x.placements) != tuple(self.placements):
                x = x.redistribute(self.mesh, self.placements)
            return x.to_local()
        t = host_tensor(x)
        return t[self.local_slices(t.shape)]

    def put(self, x: Any) -> Any:
        """``x`` at this sharding: a DTensor at the device kind (the engine's
        ``DTensor.from_local`` of the local shard), else a
        :class:`HostShard` at the host level."""
        from torch.distributed.tensor import DTensor

        shape = tuple(x.shape)
        part = self.local_of(x)
        if self.kind.jax_kind == "device":
            dev = torch.device(self.mesh.device_type, torch.cuda.current_device()) \
                if self.mesh.device_type == "cuda" else torch.device(self.mesh.device_type)
            t = part.to(device=dev, dtype=canonical(part.dtype)).contiguous()
            return DTensor.from_local(t, self.mesh, self.placements, shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride(),
                                      run_check=False)
        # page-locked memory needs a card: a CPU mesh keeps pageable shards
        level = self.kind if self.mesh.device_type == "cuda" else UNPINNED_HOST
        return HostShard(_place_leaf(part, level, torch.device("cpu")).contiguous(), self, shape)


def sharding_for(mesh: Any, spec: Any, kind: "MemKind | str" = DEVICE) -> Sharding:
    """The :class:`Sharding` of ``spec`` on ``mesh`` at level ``kind`` (a
    ``DiskHost`` kind stages at its host kind, as the JAX package's
    ``resolve_kind``)."""
    from repro_torch.parallel.sharding import placements

    kind = as_kind(kind)
    if not kind.jax_addressable:
        kind = as_kind(kind.staging_jax_kind)
    return Sharding(mesh, placements(mesh, spec), kind)


# ---------------------------------------------------------------------------
# Placement policies — the paper's "swap the kind, everything else unchanged"
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Where each state group lives in the hierarchy (the JAX package's
    presets, field for field)."""

    name: str = "all_device"
    params: MemKind = DEVICE
    opt_state: MemKind = DEVICE
    kv_cache: MemKind = DEVICE
    #: prefetch distance (layers ahead) when params are host-resident
    params_prefetch_distance: int = 1
    #: layers fetched per transfer ("elements per pre-fetch" of paper §3.1)
    params_layers_per_fetch: int = 1

    def with_(self, **kw: Any) -> "PlacementPolicy":
        return dataclasses.replace(self, **kw)

    def requires_host(self) -> bool:
        return any(
            k.jax_kind != "device" for k in (self.params, self.opt_state, self.kv_cache)
        )

    def requires_spill(self) -> bool:
        """True if any state group lives at a level no tensor lives at (disk)."""
        return any(
            not k.jax_addressable for k in (self.params, self.opt_state, self.kv_cache)
        )


ALL_DEVICE = PlacementPolicy(name="all_device")
#: Adam moments + f32 master on host
HOST_OPT = PlacementPolicy(name="host_opt", opt_state=PINNED_HOST)
#: weights live on host, streamed per layer with prefetch
HOST_PARAMS = PlacementPolicy(name="host_params", params=PINNED_HOST)
HOST_ALL = PlacementPolicy(
    name="host_all", params=PINNED_HOST, opt_state=PINNED_HOST, kv_cache=PINNED_HOST
)
#: Adam moments + f32 master spill to disk
DISK_OPT = PlacementPolicy(name="disk_opt", opt_state=DISK_HOST)
#: weights live on disk, streamed disk -> host -> device
DISK_PARAMS = PlacementPolicy(name="disk_params", params=DISK_HOST)

POLICIES = {
    p.name: p
    for p in (ALL_DEVICE, HOST_OPT, HOST_PARAMS, HOST_ALL, DISK_OPT, DISK_PARAMS)
}


def get_policy(name: str) -> PlacementPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown placement policy {name!r}; have {sorted(POLICIES)}") from None
