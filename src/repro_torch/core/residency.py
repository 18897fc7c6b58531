"""Weight-residency group cache: bytes already on the card never cross the
link again.

The JAX package's ``repro.core.residency`` on the port.  The paper's
pass-by-reference model moves only the data the computation needs; a
serving session that re-fetched the whole model every decode step while
``device_budget_mb`` had slack would break that.  :class:`ResidencyCache` is
an LRU cache, with pins, of **device-resident fetch groups**, scoped to one
transfer engine's consumers and sized to the budget slack above the
streaming window
(:meth:`repro_torch.core.weightstream.WeightStreamPlan.residency_capacity_bytes`).

A cached group is a tree of tensors on the engine's device.  Submitting it
through :meth:`repro_torch.core.engine.TransferEngine.submit_group` costs no
H2D request (leaves already on the device pass through by reference), so a
hit is "hand the engine the cached tree", and every consumer downstream is
unchanged.  An entry that is evicted, invalidated or cleared drops the
cache's reference to its tree, so the caching allocator can reuse the bytes
once no step holds them either.

Three policies keep it correct:

pin / evict
    entries are LRU-ordered; :meth:`put` evicts least-recently-used
    *unpinned* entries until the new entry fits, and refuses (leaving the
    cache unchanged) when it cannot.  :meth:`pin` protects entries across a
    known turnaround (the streamed train step's backward).
budget accounting
    ``capacity_bytes`` is a hard byte ceiling (``None`` = unbounded, the
    no-budget case); ``peak_resident_bytes`` is the observable the
    benchmarks gate against.
writeback invalidation
    :meth:`refresh` replaces an entry with the post-update device tree, or
    guarantees it is gone; :meth:`clear` drops everything.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Iterable, Optional

from repro_torch.core import tree as tr
from repro_torch.core.arrays import nbytes as _nbytes
from repro_torch.core.schedcheck import HazardError, sanitize_enabled, tree_fingerprint

__all__ = ["ResidencyCache"]

Pytree = Any


def _tree_nbytes(tree: Pytree) -> int:
    return sum(_nbytes(x) for x in tr.leaves(tree))


class _Entry:
    __slots__ = ("tree", "nbytes", "pinned")

    def __init__(self, tree: Pytree, nbytes: int, pinned: bool) -> None:
        self.tree = tree
        self.nbytes = nbytes
        self.pinned = pinned


class ResidencyCache:
    """LRU/pinned cache of device-resident weight fetch groups.

    Single-threaded by design: it is only touched from the compute thread
    (the executor's submit and apply path), never from the engine worker.
    """

    def __init__(
        self,
        capacity_bytes: Optional[int] = None,
        *,
        sanitize: Optional[bool] = None,
    ) -> None:
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        #: hazard-sanitizer mode (``REPRO_SANITIZE=1`` when unset): record a
        #: fingerprint of each key's HOME tree at fetch time and raise
        #: :class:`~repro_torch.core.schedcheck.HazardError` when a later hit
        #: would serve a device copy whose home has been swapped out from
        #: under it (restart / reshard without :meth:`clear`) — the
        #: stale-residency RAW the static analyzer checks per schedule
        self.sanitize = sanitize_enabled() if sanitize is None else bool(sanitize)
        self._home_marks: dict = {}  # key -> tree fingerprint at fetch
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.resident_bytes = 0
        #: high-water mark of ``resident_bytes`` — the cache's term of the
        #: device-budget gate (streamed peak + this must stay <= budget)
        self.peak_resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        #: puts refused because the entry could not fit (capacity minus
        #: pinned bytes) — the zero-slack degenerate case counts all here
        self.refusals = 0

    # ------------------------------------------------------------- queries
    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    @property
    def pinned_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values() if e.pinned)

    def lookup(self, key: str) -> Optional[Pytree]:
        """The cached device tree, or None.  Counts a hit/miss and marks
        the entry most-recently-used."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e.tree

    def peek(self, key: str) -> Optional[Pytree]:
        """Like :meth:`lookup` but without touching LRU order or counters —
        for leaf-level borrowing (the tied head's embed-table dedupe)."""
        e = self._entries.get(key)
        return e.tree if e is not None else None

    def sanitize_home(self, key: str, home_tree: Pytree, *, hit: bool) -> None:
        """Sanitizer check at a fetch decision point: on a miss, remember
        what ``key``'s home tree looks like; on a hit, assert the home is
        still the one the cached device copy was fetched from.  A mismatch
        means the home was rebound or mutated without invalidating the
        cache — the hit would silently serve stale weights."""
        if not self.sanitize:
            return
        mark = tree_fingerprint(home_tree)
        prev = self._home_marks.get(key)
        if hit and prev is not None and prev != mark:
            raise HazardError(
                f"sanitizer: stale residency RAW on group {key!r} — the "
                "host home changed since this device copy was cached "
                "(restart or reshard without ResidencyCache.clear()?); "
                "a cache hit would serve pre-change weights"
            )
        self._home_marks[key] = mark

    # ------------------------------------------------------------ mutation
    def _drop(self, key: str) -> None:
        e = self._entries.pop(key)
        self.resident_bytes -= e.nbytes
        self._home_marks.pop(key, None)

    def put(
        self,
        key: str,
        tree: Pytree,
        nbytes: Optional[int] = None,
        *,
        pinned: bool = False,
    ) -> bool:
        """Insert a landed device group.  Evicts LRU unpinned entries until
        it fits; returns False (cache unchanged) when it cannot.  A key
        already present is only touched (and its pin widened) — replacing
        live values is :meth:`refresh`'s job."""
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
            e.pinned = e.pinned or pinned
            return True
        if nbytes is None:
            nbytes = _tree_nbytes(tree)
        if self.capacity_bytes is not None:
            evictable = [
                k for k, v in self._entries.items() if not v.pinned
            ]  # LRU-first
            spare = self.capacity_bytes - self.resident_bytes
            i = 0
            while spare < nbytes and i < len(evictable):
                spare += self._entries[evictable[i]].nbytes
                i += 1
            if spare < nbytes:
                self.refusals += 1
                return False
            for k in evictable[:i]:
                self._drop(k)
                self.evictions += 1
        self._entries[key] = _Entry(tree, nbytes, pinned)
        self.resident_bytes += nbytes
        self.peak_resident_bytes = max(self.peak_resident_bytes, self.resident_bytes)
        self.insertions += 1
        return True

    def refresh(self, key: str, tree: Pytree, nbytes: Optional[int] = None) -> bool:
        """Writeback invalidation: the group's params were just updated, so
        a cached copy is stale.  Replace it in place with the post-update
        device tree (bitwise the values the D2H drain re-homes), or insert
        it if it fits; either way the cache never holds a stale ``key`` on
        return."""
        e = self._entries.get(key)
        if e is not None:
            pinned = e.pinned
            self._drop(key)
            self.invalidations += 1
            return self.put(key, tree, nbytes, pinned=pinned)
        return self.put(key, tree, nbytes)

    def invalidate(self, key: str) -> bool:
        e = self._entries.get(key)
        if e is None:
            return False
        self._drop(key)
        self.invalidations += 1
        return True

    def clear(self) -> None:
        """Drop everything (pins included) — a failed streamed step may
        have refreshed some groups but not committed the home update, and a
        half-updated cache must never feed the retried step."""
        n = len(self._entries)
        self._entries.clear()
        self._home_marks.clear()
        self.resident_bytes = 0
        self.invalidations += n

    # ------------------------------------------------------------- pinning
    def pin(self, key: str) -> bool:
        e = self._entries.get(key)
        if e is None:
            return False
        e.pinned = True
        return True

    def unpin_all(self) -> None:
        for e in self._entries.values():
            e.pinned = False

    # -------------------------------------------------------------- stats
    def counters(self) -> dict:
        return {
            "capacity_bytes": self.capacity_bytes,
            "resident_bytes": self.resident_bytes,
            "peak_resident_bytes": self.peak_resident_bytes,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "refusals": self.refusals,
        }

    def __repr__(self) -> str:  # pragma: no cover - trivial
        cap = (
            "unbounded"
            if self.capacity_bytes is None
            else f"{self.capacity_bytes / 1e6:.1f}MB"
        )
        return (
            f"ResidencyCache({len(self._entries)} groups, "
            f"{self.resident_bytes / 1e6:.1f}MB resident, cap {cap})"
        )
