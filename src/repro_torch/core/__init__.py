"""Core abstractions: memory kinds, pass-by-reference offload, prefetch engines.

The paper's contribution (Jamieson & Brown, JPDC 2020) on one CUDA card,
with the JAX package's ``repro.core`` names.  The KV pager, weight
streaming, the residency cache and the schedule verifier are not ported yet
(ROADMAP.md).
"""
from repro_torch.core import memkind
from repro_torch.core.memkind import (
    ALL_DEVICE,
    DEVICE,
    DISK_HOST,
    DISK_OPT,
    DISK_PARAMS,
    HOST_ALL,
    HOST_OPT,
    HOST_PARAMS,
    PINNED_HOST,
    UNPINNED_HOST,
    MemKind,
    PlacementPolicy,
    all_kinds,
    get_policy,
    host_offload_supported,
    place,
)
from repro_torch.core.spillstore import SpillStore, is_disk_leaf
from repro_torch.core.engine import (
    PAPER_EPIPHANY_LINK,
    AdaptiveDistance,
    EngineConfig,
    LinkModel,
    TransferEngine,
    static_auto_distance,
)
from repro_torch.core.offload import offload
from repro_torch.core.prefetch import eager_transfer, fetch_chunk, stream_blocks, streamed_scan
from repro_torch.core.refspec import AUTO, ON_DEMAND, Access, OffloadRef, PrefetchSpec
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.localcopy import LocalCopyCache

__all__ = [
    "memkind",
    "MemKind",
    "PlacementPolicy",
    "get_policy",
    "host_offload_supported",
    "place",
    "DEVICE",
    "PINNED_HOST",
    "UNPINNED_HOST",
    "DISK_HOST",
    "ALL_DEVICE",
    "HOST_OPT",
    "HOST_PARAMS",
    "HOST_ALL",
    "DISK_OPT",
    "DISK_PARAMS",
    "all_kinds",
    "SpillStore",
    "is_disk_leaf",
    "offload",
    "OffloadRef",
    "PrefetchSpec",
    "Access",
    "AUTO",
    "ON_DEMAND",
    "TransferEngine",
    "EngineConfig",
    "AdaptiveDistance",
    "LinkModel",
    "PAPER_EPIPHANY_LINK",
    "static_auto_distance",
    "streamed_scan",
    "stream_blocks",
    "fetch_chunk",
    "eager_transfer",
    "HostStreamExecutor",
    "StreamStats",
    "LocalCopyCache",
]
