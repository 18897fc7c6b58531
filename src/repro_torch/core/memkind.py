"""Memory kinds for hierarchical memory placement (paper §3.2) on one card.

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
that fails raises.  Meshes and shardings are not ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
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
        return t.cpu().pin_memory()  # raises where memory cannot be pinned
    # pageable host: a fresh copy if the source is device or pinned memory
    if t.device.type == "cpu" and not t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t)
    return out


def place(tree: Any, kind: "MemKind | str" = DEVICE, device: DeviceLike = None) -> Any:
    """Put every leaf of ``tree`` (tensors or numpy arrays) at a hierarchy
    level for ``device``.  A leaf already there is returned as it is."""
    dev = resolve_device(device)
    kind = resolve_kind(kind, device=dev)
    return tr.tree_map(lambda x: _place_leaf(x, kind, dev), tree)


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
