"""Host-side prefetching data loader — the paper's prefetch at the input level.

Batches are produced on the host and copied to ``device`` with a bounded
look-ahead of ``distance`` batches, so the input copies of later steps are
queued behind the current one.  ``distance=0`` is the paper's on-demand
mode (the step waits on its input).

:class:`DiskShardLoader` extends the same pattern one level down the
hierarchy: batches live as chunk files in a
:class:`~repro_torch.core.spillstore.SpillStore` (the ``DiskHost`` tier)
and are served as memory-mapped views, so a disk-resident dataset streams to
the device without ever materializing in host RAM.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional

from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.device import DeviceLike, resolve_device

Pytree = Any


class PrefetchLoader:
    """``loader(step)`` -> the batch for ``step`` on ``device`` (the card
    unless ``"cpu"``), with copies issued up to ``step + distance``."""

    def __init__(
        self,
        make_batch: Callable[[int], Pytree],
        *,
        device: DeviceLike = None,
        distance: int = 2,
        start_step: int = 0,
    ) -> None:
        self._make = make_batch
        self.device = resolve_device(device)
        self._distance = max(distance, 0)
        self._next = start_step
        self._ring: deque[tuple[int, Pytree]] = deque()

    def _put(self, step: int) -> Pytree:
        return tr.tree_map(lambda x: host_tensor(x).to(self.device, non_blocking=True),
                           self._make(step))

    def __call__(self, step: int) -> Pytree:
        """Batch for ``step``; issues transfers up to ``step + distance``."""
        # drop stale entries (restart / out-of-order resume)
        while self._ring and self._ring[0][0] < step:
            self._ring.popleft()
        if not self._ring or self._ring[0][0] != step:
            self._ring.clear()
            self._next = step
        while self._next <= step + self._distance:
            self._ring.append((self._next, self._put(self._next)))
            self._next += 1
        s, batch = self._ring.popleft()
        assert s == step
        return batch


class DiskShardLoader:
    """``make_batch`` over disk-resident shards (the ``DiskHost`` data tier).

    ``write_shards`` spills batches into the store once; ``__call__(step)``
    then returns the shard for ``step`` as a tree of memory-mapped views —
    no host-RAM cost until a copy reads the bytes.  Wrap in
    :class:`PrefetchLoader` for look-ahead exactly like a RAM loader::

        loader = PrefetchLoader(DiskShardLoader(store, n_shards), distance=2)
    """

    _KEY = "shard_{:06d}"

    def __init__(self, store, n_shards: int, *, template: Optional[Pytree] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self._store = store
        self._n = n_shards
        self._template = template

    @classmethod
    def write_shards(cls, store, make_batch: Callable[[int], Pytree],
                     n_shards: int) -> "DiskShardLoader":
        """Spill ``n_shards`` batches into ``store`` and return a loader
        over them (one chunk file per shard: one disk request each)."""
        for i in range(n_shards):
            store.put(cls._KEY.format(i), make_batch(i))
        return cls(store, n_shards)

    def __call__(self, step: int) -> Pytree:
        return self._store.get(self._KEY.format(step % self._n), template=self._template)
