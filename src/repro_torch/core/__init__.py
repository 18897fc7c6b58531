"""Core abstractions ported so far: prefetch specs and stream accounting.

The memory kinds, ``OffloadRef``, the transfer engine and the host-stream
executor follow in later slices (see ROADMAP.md).
"""
from repro_torch.core.engine import static_auto_distance
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.refspec import AUTO, ON_DEMAND, Access, PrefetchSpec

__all__ = [
    "AUTO",
    "ON_DEMAND",
    "Access",
    "PrefetchSpec",
    "StreamStats",
    "static_auto_distance",
]
