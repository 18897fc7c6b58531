"""Transfer engine — only the static ``"auto"`` distance resolution so far.

The coalescing ``TransferEngine`` over HBM <- pinned host <- disk follows in
a later slice (ROADMAP.md, queue 1).  The decode kernel's ring needs this
function now: a ring sized at launch cannot re-shape at run time.
"""
from __future__ import annotations


def static_auto_distance(n_chunks: int, cap: int = 4) -> int:
    """Compile-time resolution of ``distance="auto"``: a small fixed head
    start, clamped to the chunk count."""
    return max(1, min(cap, n_chunks - 1))
