"""Paper §3.3 memory model: local-copy preference with write-through.

"whenever a micro-core attempts to access a scalar variable or index of an
array, held elsewhere in the memory hierarchy, preference is given to any
local copy held on that micro-core. If there is no local copy, then a data
transfer will be performed. [...] the write occurs both to the local copy
and is also written back to the variable's location on the host."

``LocalCopyCache`` is that model at framework granularity: a bounded pool of
device-resident copies of host-kind arrays.  Reads hit the local copy when
present; writes update the local copy AND write through to the home
buffer; capacity eviction mirrors the paper's "locally held copies of data
may be freed".  Operations are in program order on the one device.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.core.arrays import host_tensor, nbytes
from repro_torch.device import DeviceLike, resolve_device


class LocalCopyCache:
    def __init__(self, *, capacity_bytes: int = 64 * 2**20, device: DeviceLike = None) -> None:
        self.capacity = capacity_bytes
        self.device = resolve_device(device)
        self._local: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._home: dict[str, torch.Tensor] = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0, "writebacks": 0}

    # -- home registration (the variable's location in the hierarchy) -------
    def register(self, name: str, value: Any) -> None:
        self._home[name] = host_tensor(value)

    def home(self, name: str) -> torch.Tensor:
        return self._home[name]

    # -- reads ---------------------------------------------------------------
    def read(self, name: str) -> torch.Tensor:
        """Local copy preferred; fetch (H2D) on miss."""
        if name in self._local:
            self.stats["hits"] += 1
            self._local.move_to_end(name)
            return self._local[name]
        self.stats["misses"] += 1
        buf = self._home[name].to(self.device, copy=True)
        self._insert(name, buf)
        return buf

    # -- writes: local + write-through ----------------------------------------
    def write(self, name: str, value: torch.Tensor) -> None:
        self._insert(name, value)
        self._home[name] = value.detach().to("cpu", copy=True)  # write-through
        self.stats["writebacks"] += 1

    # -- pool management (paper: central storage pool, copies may be freed) ---
    def _insert(self, name: str, buf: torch.Tensor) -> None:
        self._local[name] = buf
        self._local.move_to_end(name)
        while self._bytes() > self.capacity and len(self._local) > 1:
            self._local.popitem(last=False)
            self.stats["evictions"] += 1

    def _bytes(self) -> int:
        return sum(nbytes(b) for b in self._local.values())

    def invalidate(self, name: Optional[str] = None) -> None:
        if name is None:
            self._local.clear()
        else:
            self._local.pop(name, None)
