"""Asynchronous coalesced transfer engine — the paper's host service, on one card.

The paper's runtime (§4) is a host process that serves device channel
requests; its performance result (§5.1, Table 2) is that the on-demand
penalty comes from *request count*, not per-transfer bandwidth, and that
chunked prefetch with overlap recovers nearly all of it.  This module is
the JAX package's ``repro.core.engine`` on PyTorch:

coalescing
    Each group's host leaves (numpy arrays, CPU tensors, spill-store views)
    are packed byte-wise into ONE page-locked ``uint8`` staging buffer at
    64-byte-aligned offsets and the JAX package's canonical dtypes, so a
    group costs one H2D request, and ``payload_bytes`` and request counts
    are the JAX package's exactly.  The copy is one ``non_blocking`` H2D on
    the engine's copy stream; the leaves come back as zero-copy
    ``view(dtype).reshape(shape)`` slices of the flat device buffer.
    Leaves already on the engine's device pass through by reference.

buffer reuse
    Staging buffers are pooled per group layout (``staging_slots``).  A
    buffer goes back to the pool only after its copy has completed (the
    worker synchronises the copy stream's event), so a later group never
    overwrites bytes in flight.  The flat device buffer is allocated on the
    copy stream and marked as used by the consuming stream
    (``record_stream``), so the allocator cannot hand it out again while a
    kernel still reads it.

asynchrony
    Transfers run on a worker thread (the host service).  The compute
    thread submits a group and gets a :class:`TransferFuture`; packing, the
    H2D copy and, for ``rw`` groups, the D2H writeback happen off the
    compute path.  Writebacks drain at the end of the run, in group order.

adaptive prefetch distance
    :class:`AdaptiveDistance` grows and shrinks the in-flight window from
    the observed per-group waits; it backs ``PrefetchSpec(distance="auto")``.

three-level streaming (the ``DiskHost`` tier)
    Groups whose leaves are spill-store memory maps go through a second
    worker first: it CRC-checks the mapped bytes and copies them into pooled
    host buffers (the disk read), under its own adaptive read-ahead window;
    the transfer worker then packs and copies them as host groups.

An optional :class:`LinkModel` emulates a slow interconnect (per-request
service time + serial bandwidth occupancy + overlappable latency) for
schedule studies; with ``link=None`` the card's real PCIe link is measured.
Multi-device layouts (``ShardedGroupLayout``) and the hazard sanitizer are
not ported (ROADMAP.md, queue 1 item 5: multi-device and tooling).
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import canonical, dtype_name, dtype_of, host_tensor, nbytes
from repro_torch.device import DeviceLike, resolve_device

log = logging.getLogger("repro_torch.engine")

__all__ = [
    "LinkModel",
    "PAPER_EPIPHANY_LINK",
    "EngineConfig",
    "GroupLayout",
    "TransferFuture",
    "AdaptiveDistance",
    "TransferEngine",
    "group_signature",
    "static_auto_distance",
]

Pytree = Any

#: staging offsets are padded to this many bytes so dtype views stay aligned
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _sleep_precise(duration_s: float) -> None:
    """Sleep with sub-millisecond accuracy without starving other threads:
    ``time.sleep`` overshoots by ~1 ms, more than the paper's 0.104 ms per
    request, so the tail is waited in ``sleep(0)`` yields."""
    end = time.perf_counter() + duration_s
    while True:
        remaining = end - time.perf_counter()
        if remaining <= 0:
            return
        if remaining > 1.5e-3:
            time.sleep(remaining - 1e-3)
        else:
            time.sleep(0)  # yield the GIL, keep ~10 us accuracy


# ---------------------------------------------------------------------------
# link emulation (paper §5.1 constants)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Emulated interconnect for schedule studies.

    ``request_s``
        serial per-request service time (the paper's host-service
        turnaround: ~0.104 ms/request on Epiphany, Table 2).  This is the
        term the coalescer collapses.
    ``bandwidth_Bps``
        serial occupancy: a transfer holds the link for ``nbytes/bw``.
    ``latency_s``
        completion delay *after* the link is released — overlappable by
        prefetch depth, which is what ``distance`` (and the adaptive
        controller) hides.
    """

    request_s: float = 0.104e-3
    bandwidth_Bps: float = 88e6
    latency_s: float = 0.0

    def occupancy_s(self, n_requests: int, nbytes: int) -> float:
        return n_requests * self.request_s + nbytes / self.bandwidth_Bps

    def transfer_s(self, n_requests: int, nbytes: int) -> float:
        return self.occupancy_s(n_requests, nbytes) + self.latency_s


#: the paper's measured Epiphany link (88 MB/s, 0.104 ms/request) — the
#: paper's model, not a measurement of this port
PAPER_EPIPHANY_LINK = LinkModel()


# ---------------------------------------------------------------------------
# engine configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the transfer engine (the JAX package's, field for field).
    The defaults are the fast path; ``EngineConfig(coalesce=False,
    async_writeback=False)`` is the per-leaf blocking schedule."""

    #: pack each group's host leaves into one staging buffer (1 H2D request)
    coalesce: bool = True
    #: drain ``rw`` writebacks at end of run instead of blocking per group
    async_writeback: bool = True
    #: staging buffers kept per group layout
    staging_slots: int = 2
    #: kept for the JAX package's field set: the unpacked leaves are views of
    #: the flat device buffer, so there is no copy to donate away
    donate_flat: bool = True
    #: emulated interconnect (None = the real link)
    link: Optional[LinkModel] = None
    # -- adaptive distance (PrefetchSpec(distance="auto")) ------------------
    min_distance: int = 1
    max_distance: int = 8
    #: a per-group wait above this counts as a stall -> grow the window
    wait_eps_s: float = 100e-6
    #: consecutive stall-free groups before the window shrinks
    shrink_after: int = 4
    # -- disk tier (DiskHost groups: two-stage disk->host->device) ----------
    #: emulated disk link (None = the real page cache / disk)
    disk_link: Optional[LinkModel] = None
    #: initial disk read-ahead window (fetched-but-unconsumed host buffers)
    disk_slots: int = 2
    disk_max_slots: int = 8
    disk_wait_eps_s: float = 100e-6
    disk_shrink_after: int = 4
    # -- robustness ------------------------------------------------------------
    #: attempts per transfer operation (H2D, D2H, disk stage); 1 = fail fast.
    #: A retried operation re-reads its intact cold home, so a schedule
    #: that retried is bitwise-equal to one that did not.
    max_attempts: int = 1
    #: base of the exponential backoff (attempt ``k`` sleeps ``base * 2**k``)
    retry_backoff_s: float = 1e-3
    #: per-worker join timeout in ``close()`` before the thread counts as leaked
    close_timeout_s: float = 5.0
    #: CRC-verify spill-store chunk bytes in the disk stage before packing
    verify_spill: bool = True
    #: the hazard sanitizer; not ported
    sanitize: bool = False

    def __post_init__(self) -> None:
        if self.sanitize:
            raise NotImplementedError(
                "EngineConfig(sanitize=True): the hazard sanitizer comes with the schedule "
                "verifier (core/schedcheck.py), not ported yet (ROADMAP.md, queue 1 item 5: "
                "multi-device and tooling)"
            )


def static_auto_distance(n_chunks: int, cap: int = 4) -> int:
    """Resolution of ``distance="auto"`` for a ring sized once (the graph
    engine, the kernels): a small fixed head start, clamped to the chunk
    count."""
    return max(1, min(cap, n_chunks - 1))


# ---------------------------------------------------------------------------
# adaptive prefetch distance
# ---------------------------------------------------------------------------


class AdaptiveDistance:
    """Grow-on-stall / shrink-when-idle controller for the in-flight window.

    A wait above ``wait_eps_s`` grows the window by one; ``shrink_after``
    consecutive clean groups shrink it by one.  A stall immediately after a
    shrink raises a sticky floor so the controller converges to the minimal
    sufficient window instead of oscillating.
    """

    def __init__(
        self,
        *,
        initial: int = 1,
        min_distance: int = 1,
        max_distance: int = 8,
        wait_eps_s: float = 100e-6,
        shrink_after: int = 4,
    ) -> None:
        self.min_distance = max(1, min_distance)
        self.max_distance = max(self.min_distance, max_distance)
        self.wait_eps_s = wait_eps_s
        self.shrink_after = max(1, shrink_after)
        self.distance = min(max(initial, self.min_distance), self.max_distance)
        self._floor = self.min_distance
        self._clean = 0
        self._just_shrank = False

    def observe(self, wait_s: float) -> int:
        """Record one group's transfer wait; returns the updated distance."""
        if wait_s > self.wait_eps_s:
            if self._just_shrank:
                # shrinking caused a stall: the previous window was minimal
                self._floor = min(self.distance + 1, self.max_distance)
            self.distance = min(self.distance + 1, self.max_distance)
            self._clean = 0
            self._just_shrank = False
        else:
            self._clean += 1
            self._just_shrank = False
            if self._clean >= self.shrink_after and self.distance > max(
                self.min_distance, self._floor
            ):
                self.distance -= 1
                self._clean = 0
                self._just_shrank = True
        return self.distance

    def boost(self, n: int = 1) -> int:
        """Externally widen the window (straggler feedback)."""
        self.distance = min(self.distance + max(1, n), self.max_distance)
        self._clean = 0
        self._just_shrank = False
        return self.distance


# ---------------------------------------------------------------------------
# group layout: the pack/unpack plan
# ---------------------------------------------------------------------------


def _resident(x: Any, device: Optional[torch.device]) -> bool:
    """A leaf already at the engine's device passes through by reference."""
    return device is not None and isinstance(x, torch.Tensor) and x.device == device


def group_signature(group: Pytree, device: Optional[torch.device] = None) -> tuple:
    """Hashable identity of a group's structure: tree structure + per-leaf
    (shape, dtype, resident on ``device``?)."""
    leaves, treedef = tr.flatten(group)
    return (
        treedef,
        tuple((tuple(x.shape), dtype_name(dtype_of(x)), _resident(x, device)) for x in leaves),
    )


class GroupLayout:
    """Pack/unpack plan for one group structure.

    Host leaves (anything not already a tensor on ``device``) are packed into
    one contiguous byte buffer at 64-byte-aligned offsets, at the JAX
    package's canonical dtypes (f64 -> f32, i64 -> i32); resident leaves
    pass through.  ``device=None`` is the disk stage's host-only layout.
    """

    #: default-placement layouts stage through a single device
    n_devices = 1

    def __init__(self, group: Pytree, *, device: Optional[torch.device] = None) -> None:
        leaves, self.treedef = tr.flatten(group)
        self.device = device
        self.n_leaves = len(leaves)
        self.metas: list[tuple[int, int, tuple, torch.dtype, int]] = []
        self.passthrough_idx: list[int] = []
        off = 0
        for i, x in enumerate(leaves):
            if _resident(x, device):
                self.passthrough_idx.append(i)
                continue
            dtype = canonical(dtype_of(x))
            shape = tuple(x.shape)
            nb = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            self.metas.append((i, off, shape, dtype, nb))
            off = _align(off + nb)
        self.staging_bytes = off
        #: actual H2D payload (unpadded), for byte accounting
        self.payload_bytes = sum(m[4] for m in self.metas)
        #: leaves packed into the buffer
        self.n_packed = len(self.metas)

    @property
    def has_payload(self) -> bool:
        return bool(self.metas)

    @property
    def n_requests(self) -> int:
        """H2D requests this layout costs per group when coalesced."""
        return 1 if self.metas else 0

    def new_staging(self) -> torch.Tensor:
        """A staging buffer: page-locked when it feeds a CUDA device."""
        pin = self.device is not None and self.device.type == "cuda"
        return torch.empty((self.staging_bytes,), dtype=torch.uint8, pin_memory=pin)

    def views(self, buf: torch.Tensor) -> list[torch.Tensor]:
        """The packed leaves as zero-copy views of a flat buffer."""
        return [buf[o:o + nb].view(dt).reshape(shape) for _, o, shape, dt, nb in self.metas]

    def pack_into(self, leaves: list, staging: torch.Tensor) -> torch.Tensor:
        for (i, *_), dst in zip(self.metas, self.views(staging)):
            dst.copy_(host_tensor(leaves[i]))  # casts f64 -> f32 etc. like device_put
        return staging

    def put_staged(self, staging: torch.Tensor, copy_stream, consumer_stream):
        """Issue the (single) H2D copy of the packed buffer on the copy
        stream; returns ``(flat, event)``, the event recorded after the copy
        (``None`` off the card)."""
        if copy_stream is None:
            return staging.to(self.device), None
        with torch.cuda.stream(copy_stream):
            flat = torch.empty((self.staging_bytes,), dtype=torch.uint8, device=self.device)
            flat.copy_(staging, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        flat.record_stream(consumer_stream)  # read there: no reuse before it is done
        return flat, event

    def any_alias(self, flat: torch.Tensor, staging: torch.Tensor) -> bool:
        """True if the "device" buffer is the staging memory itself (the CPU
        by request): the buffer must then not be recycled while in use."""
        return flat.data_ptr() == staging.data_ptr()

    def unpack(self, flat: Optional[torch.Tensor], src_leaves: list) -> Pytree:
        """Rebuild the group from the flat device buffer, merging the
        passed-through resident leaves from the original submission."""
        out: list = [None] * self.n_leaves
        if self.metas:
            for (i, *_), leaf in zip(self.metas, self.views(flat)):
                out[i] = leaf
        for i in self.passthrough_idx:
            out[i] = src_leaves[i]
        return tr.unflatten(self.treedef, out)


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------


def _retryable(e: BaseException) -> bool:
    """Faults the bounded-retry loops may absorb.  Corruption is excluded:
    its recovery path already ran inside
    :func:`repro_torch.core.spillstore.verify_disk_leaf`, and retrying would
    re-consume the same bad bytes."""
    from repro_torch.core.spillstore import SpillCorruptionError

    return not isinstance(e, (KeyboardInterrupt, SystemExit, SpillCorruptionError))


def _is_disk_leaf(x: Any) -> bool:
    from repro_torch.core.spillstore import is_disk_leaf

    return is_disk_leaf(x)


class TransferFuture:
    """Handle to one in-flight H2D group transfer."""

    __slots__ = (
        "index",
        "layout",
        "src_leaves",
        "n_requests",
        "nbytes",
        "n_devices",
        "disk_requests",
        "disk_nbytes",
        "disk_wait_s",
        "retries",
        "_event",
        "_flat",
        "_copy_event",
        "_device_tree",
        "_error",
        "ready_at",
        "_group",
    )

    def __init__(self, index: int, layout: Optional[GroupLayout], src_leaves, n_requests: int,
                 nbytes: int):
        self.index = index
        self.layout = layout
        self.src_leaves = src_leaves
        self.n_requests = n_requests
        self.nbytes = nbytes
        self.n_devices = 1
        #: disk-tier accounting (zero for pure host/device groups)
        self.disk_requests = 0
        self.disk_nbytes = 0
        #: time the *transfer worker* blocked on the disk stage
        self.disk_wait_s = 0.0
        #: transient faults absorbed while staging this group (both stages)
        self.retries = 0
        self._event = threading.Event()
        self._flat = None
        self._copy_event = None
        self._device_tree = None
        self._error: Optional[BaseException] = None
        self.ready_at = 0.0
        self._group = None

    # -- worker side --------------------------------------------------------
    def _complete(self, *, flat=None, copy_event=None, device_tree=None, ready_at=0.0, error=None):
        self._flat = flat
        self._copy_event = copy_event
        self._device_tree = device_tree
        self.ready_at = ready_at
        self._error = error
        self._event.set()

    # -- compute side -------------------------------------------------------
    @property
    def is_resident(self) -> bool:
        """True iff this submit moved nothing across any link."""
        return self.n_requests == 0 and self.disk_requests == 0

    def wait(self) -> float:
        """Block until the transfer has landed (the worker has synchronised
        its copy); returns the time the compute thread spent blocked."""
        t0 = time.perf_counter()
        self._event.wait()
        if self._error is not None:
            raise self._error
        residual = self.ready_at - time.perf_counter()
        if residual > 0:  # emulated link latency tail
            _sleep_precise(residual)
        return time.perf_counter() - t0

    def group(self) -> Pytree:
        """The staged device-side group (unpacks the flat buffer once).  The
        calling thread's stream is ordered after the copy."""
        if self._group is None:
            if self._copy_event is not None:
                torch.cuda.current_stream(self.layout.device).wait_event(self._copy_event)
            if self._device_tree is not None:
                self._group = self._device_tree
            else:
                self._group = self.layout.unpack(self._flat, self.src_leaves)
            self._flat = None
            self.src_leaves = None
        return self._group


class _DiskFetchTicket:
    """Handle to one in-flight disk -> host-staging fetch (pipeline stage 1):
    the disk worker copies each mapped leaf into a pooled host buffer (the
    copy *is* the disk read) and publishes views of it."""

    __slots__ = ("sig", "idx", "n_requests", "nbytes", "retries", "_event",
                 "_error", "views", "buf", "ready_at")

    def __init__(self, sig: tuple, idx: list, n_requests: int, nbytes: int):
        self.sig = sig
        #: positions of the disk leaves in the group's flattened leaf list
        self.idx = idx
        self.n_requests = n_requests
        self.nbytes = nbytes
        self.retries = 0
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self.views: Optional[list] = None
        self.buf: Optional[torch.Tensor] = None
        self.ready_at = 0.0


class _WritebackTicket:
    __slots__ = ("index", "n_requests", "nbytes", "retries", "_event", "_host",
                 "_error", "ready_at")

    def __init__(self, index: int, n_requests: int, nbytes: int):
        self.index = index
        self.n_requests = n_requests
        self.nbytes = nbytes
        self.retries = 0
        self._event = threading.Event()
        self._host = None
        self._error: Optional[BaseException] = None
        self.ready_at = 0.0

    def result(self) -> Pytree:
        self._event.wait()
        if self._error is not None:
            raise self._error
        residual = self.ready_at - time.perf_counter()
        if residual > 0:
            _sleep_precise(residual)
        return self._host


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class TransferEngine:
    """Background host service moving groups between host and ``device``.

    One worker thread owns all transfer work (pack, H2D, D2H, link
    emulation) and issues its copies on a dedicated copy stream; the
    compute thread only submits work and waits on futures.  FIFO processing
    preserves submission order, so writebacks drain in group order.
    """

    def __init__(self, config: Optional[EngineConfig] = None, *, device: DeviceLike = None) -> None:
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker: Optional[threading.Thread] = None
        self._layouts: dict[tuple, GroupLayout] = {}
        #: per-layout free list of reusable staging buffers (worker-owned)
        self._staging_free: dict[tuple, list[torch.Tensor]] = {}
        #: total staging buffers ever allocated (reuse-efficiency metric)
        self.staging_allocs: int = 0
        self._pending_wb: list[_WritebackTicket] = []
        #: the emulated link is one serial resource
        self._link_lock = threading.Lock()
        # -- disk stage (DiskHost groups) -----------------------------------
        self._disk_tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self._disk_worker: Optional[threading.Thread] = None
        self._disk_layouts: dict[tuple, GroupLayout] = {}
        self._disk_free: dict[tuple, list[torch.Tensor]] = {}
        #: fetched-but-unconsumed disk buffers, bounded by the read-ahead window
        self._disk_in_use = 0
        self._disk_cond = threading.Condition()
        self._disk_controller: Optional[AdaptiveDistance] = None
        self._disk_window = max(1, self.config.disk_slots)
        self.disk_staging_allocs: int = 0
        self._disk_link_lock = threading.Lock()
        #: True when the last close() abandoned a live worker thread
        self.leaked_threads: bool = False
        self._controllers: list[AdaptiveDistance] = []

    # -- external window control --------------------------------------------
    def register_controller(self, ctrl: AdaptiveDistance) -> None:
        """Attach an executor's prefetch controller; :meth:`widen` reaches it."""
        if ctrl not in self._controllers:
            self._controllers.append(ctrl)

    def widen(self, n: int = 1) -> list[int]:
        """Widen every registered prefetch window (and the disk read-ahead
        window) by ``n``; returns the new window sizes."""
        out = [c.boost(n) for c in self._controllers]
        with self._disk_cond:
            if self._disk_controller is not None:
                self._disk_window = self._disk_controller.boost(n)
            else:
                self._disk_window = min(self._disk_window + max(1, n), self.config.disk_max_slots)
            out.append(self._disk_window)
            self._disk_cond.notify_all()
        return out

    # -- lifecycle -----------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="transfer-engine", daemon=True
            )
            self._worker.start()

    def _ensure_disk_worker(self) -> None:
        if self._disk_worker is None or not self._disk_worker.is_alive():
            self._disk_worker = threading.Thread(
                target=self._disk_worker_loop, name="transfer-engine-disk", daemon=True
            )
            self._disk_worker.start()

    def close(self) -> None:
        """Stop the worker threads after their pending tasks.  Not final: a
        later submit restarts them.  A worker that fails to join within
        ``close_timeout_s`` is reported on ``leaked_threads`` and kept, so a
        later submit cannot start a second consumer on the same queue."""
        timeout = self.config.close_timeout_s
        if self._disk_worker is not None and self._disk_worker.is_alive():
            self._disk_tasks.put(None)
        if self._worker is not None and self._worker.is_alive():
            self._tasks.put(None)
            self._worker.join(timeout=timeout)
        if self._disk_worker is not None and self._disk_worker.is_alive():
            self._disk_worker.join(timeout=timeout)
        leaked = [t.name for t in (self._worker, self._disk_worker)
                  if t is not None and t.is_alive()]
        self.leaked_threads = bool(leaked)
        if leaked:
            log.error("TransferEngine.close(): worker thread(s) %s still alive after a "
                      "%.1fs join — leaked", leaked, timeout)
        if self._worker is not None and not self._worker.is_alive():
            self._worker = None
        if self._disk_worker is not None and not self._disk_worker.is_alive():
            self._disk_worker = None

    def __enter__(self) -> "TransferEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass

    # -- layout / staging ----------------------------------------------------
    def _layout_for_sig(self, sig: tuple, group: Pytree) -> GroupLayout:
        """One layout + staging pool per signature."""
        lo = self._layouts.get(sig)
        if lo is None:
            lo = GroupLayout(group, device=self.device)
            self._layouts[sig] = lo
            self._staging_free[sig] = []
        return lo

    def _acquire_staging(self, sig: tuple, layout: GroupLayout) -> torch.Tensor:
        """A staging buffer from the layout's pool (worker thread), else a new
        one: the pool sizes itself to the worker's actual concurrency."""
        free = self._staging_free[sig]
        if free:
            return free.pop()
        self.staging_allocs += 1
        return layout.new_staging()

    def _release_staging(self, sig: tuple, staging: torch.Tensor) -> None:
        free = self._staging_free[sig]
        if len(free) < max(1, self.config.staging_slots):
            free.append(staging)

    # -- disk stage pool (read-ahead window) --------------------------------
    def _disk_layout_for(self, dsig: tuple, disk_leaves: list) -> GroupLayout:
        lo = self._disk_layouts.get(dsig)
        if lo is None:
            lo = GroupLayout(tuple(disk_leaves), device=None)
            self._disk_layouts[dsig] = lo
            self._disk_free[dsig] = []
        return lo

    def _acquire_disk_staging(self, dsig: tuple, layout: GroupLayout) -> torch.Tensor:
        """A host buffer from the disk pool (disk worker).  Blocks while
        ``window`` buffers are fetched but not yet consumed: the disk
        read-ahead throttle."""
        with self._disk_cond:
            while self._disk_in_use >= max(1, self._disk_window):
                self._disk_cond.wait(timeout=0.5)
            self._disk_in_use += 1
        try:
            free = self._disk_free[dsig]
            if free:
                return free.pop()
            self.disk_staging_allocs += 1
            return layout.new_staging()
        except BaseException:
            # give the window slot back or the pipeline wedges
            with self._disk_cond:
                self._disk_in_use -= 1
                self._disk_cond.notify_all()
            raise

    def _release_disk_staging(self, dsig: tuple, buf: torch.Tensor) -> None:
        free = self._disk_free.get(dsig)
        if free is not None and len(free) < self.config.disk_max_slots:
            free.append(buf)
        with self._disk_cond:
            self._disk_in_use -= 1
            self._disk_cond.notify_all()

    def _observe_disk_wait(self, wait_s: float) -> None:
        """Feed the disk-stage controller one H2D-on-disk stall sample."""
        if self._disk_controller is None:
            cfg = self.config
            self._disk_controller = AdaptiveDistance(
                initial=cfg.disk_slots,
                min_distance=1,
                max_distance=cfg.disk_max_slots,
                wait_eps_s=cfg.disk_wait_eps_s,
                shrink_after=cfg.disk_shrink_after,
            )
        new = self._disk_controller.observe(wait_s)
        if new != self._disk_window:
            with self._disk_cond:
                self._disk_window = new
                self._disk_cond.notify_all()

    # -- submission (compute thread) ----------------------------------------
    def _consumer_stream(self):
        return torch.cuda.current_stream(self.device) if self._copy_stream is not None else None

    def _submit_disk_stage(self, sig: tuple, leaves: list, fut: TransferFuture):
        """Enqueue the stage-1 disk fetch for a group's disk-tier leaves;
        returns the ticket, or None when nothing is disk-resident."""
        disk_idx = [i for i, x in enumerate(leaves) if _is_disk_leaf(x)]
        if not disk_idx:
            return None
        disk_leaves = [leaves[i] for i in disk_idx]
        # one chunk file = one disk request (the store's coalescing)
        n_files = len({getattr(x, "filename", None) or id(x) for x in disk_leaves})
        dsig = ("disk", sig, tuple(disk_idx))
        dlayout = self._disk_layout_for(dsig, disk_leaves)
        ticket = _DiskFetchTicket(dsig, disk_idx, n_files, dlayout.payload_bytes)
        fut.disk_requests = n_files
        fut.disk_nbytes = dlayout.payload_bytes
        self._ensure_disk_worker()
        self._disk_tasks.put((ticket, disk_leaves))
        return ticket

    def submit_group(self, index: int, group: Pytree) -> TransferFuture:
        """Queue the H2D transfer of one group; returns immediately.  Groups
        holding spill-store views also enqueue a stage-1 fetch on the disk
        worker."""
        leaves = tr.leaves(group)
        consumer = self._consumer_stream()
        if self.config.coalesce:
            sig = group_signature(group, self.device)
            layout = self._layout_for_sig(sig, group)
            fut = TransferFuture(index, layout, leaves, layout.n_requests, layout.payload_bytes)
            ticket = self._submit_disk_stage(sig, leaves, fut)
            self._ensure_worker()
            self._tasks.put(("h2d", fut, group, True, sig, ticket, consumer))
            return fut

        # per-leaf schedule: one request per host leaf; disk-tier memmaps are
        # read inline (no stage-1 pipeline) but their traffic is accounted
        n_host = 0
        total = 0
        disk_files: set = set()
        disk_bytes = 0
        for x in leaves:
            if _resident(x, self.device):
                continue
            n_host += 1
            total += nbytes(x)
            if _is_disk_leaf(x):
                disk_files.add(getattr(x, "filename", None) or id(x))
                disk_bytes += nbytes(x)
        fut = TransferFuture(index, None, leaves, n_host, total)
        fut.disk_requests = len(disk_files)
        fut.disk_nbytes = disk_bytes
        self._ensure_worker()
        self._tasks.put(("h2d", fut, group, False, None, None, consumer))
        return fut

    def submit_writeback(self, index: int, group_out: Pytree) -> _WritebackTicket:
        """Queue the D2H copy of an ``rw`` group's output; returns
        immediately.  The copy waits, on the copy stream, for the work the
        calling stream has queued so far (the group's producer)."""
        leaves = tr.leaves(group_out)
        ticket = _WritebackTicket(index, len(leaves), sum(nbytes(x) for x in leaves))
        self._pending_wb.append(ticket)
        ready = None
        if self._copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._ensure_worker()
        self._tasks.put(("d2h", ticket, group_out, ready))
        return ticket

    def drain_writebacks(self) -> list:
        """Wait for every pending writeback; returns host groups in group order."""
        tickets = sorted(self._pending_wb, key=lambda t: t.index)
        self._pending_wb = []
        return [t.result() for t in tickets]

    def discard_writebacks(self) -> int:
        """Drop pending writeback tickets (a failed run may have left some);
        returns the number discarded."""
        n = len(self._pending_wb)
        self._pending_wb = []
        return n

    # -- worker thread -------------------------------------------------------
    def _retry_loop(self, op, counter, what: str):
        """Run ``op()`` with bounded retry + exponential backoff; a transient
        fault re-runs ``op`` from its intact inputs and counts a retry."""
        attempts = max(1, self.config.max_attempts)
        for attempt in range(attempts):
            try:
                return op()
            except BaseException as e:  # noqa: BLE001 — bounded, re-raised
                if attempt + 1 >= attempts or not _retryable(e):
                    raise
                counter.retries += 1
                log.warning("transient %s fault (attempt %d/%d), backing off: %s",
                            what, attempt + 1, attempts, e)
                _sleep_precise(self.config.retry_backoff_s * (2.0 ** attempt))
        raise AssertionError("unreachable")  # pragma: no cover

    def _worker_loop(self) -> None:
        link = self.config.link
        while True:
            task = self._tasks.get()
            if task is None:
                return
            try:
                if task[0] == "h2d":
                    _, fut, group, coalesce, sig, ticket, consumer = task
                    if coalesce:
                        self._h2d_coalesced(fut, sig, ticket, consumer, link)
                    else:
                        tree = self._retry_loop(
                            lambda: self._put_per_leaf(group, consumer),
                            fut, f"H2D per-leaf (group {fut.index})",
                        )
                        ready_at = self._emulate(link, fut.n_requests, fut.nbytes)
                        fut._complete(device_tree=tree, ready_at=ready_at)
                else:
                    _, ticket, group_out, ready = task
                    host = self._retry_loop(
                        lambda: self._get(group_out, ready), ticket, f"D2H (group {ticket.index})"
                    )
                    ticket.ready_at = self._emulate(link, ticket.n_requests, ticket.nbytes)
                    ticket._host = host
                    ticket._event.set()
            except BaseException as e:  # noqa: BLE001 — surface on the waiter
                obj = task[1]
                obj._error = e
                obj._event.set()

    def _h2d_coalesced(self, fut: TransferFuture, sig, ticket, consumer, link) -> None:
        src_leaves = fut.src_leaves
        disk_buf = None
        if ticket is not None:
            # stage-2-on-stage-1 wait: zero once the read-ahead covers the disk
            t0 = time.perf_counter()
            ticket._event.wait()
            if ticket._error is not None:
                raise ticket._error
            residual = ticket.ready_at - time.perf_counter()
            if residual > 0:
                _sleep_precise(residual)
            fut.disk_wait_s = time.perf_counter() - t0
            self._observe_disk_wait(fut.disk_wait_s)
            fut.retries += ticket.retries
            src_leaves = list(src_leaves)
            for i, view in zip(ticket.idx, ticket.views):
                src_leaves[i] = view
            disk_buf = ticket.buf
        try:
            layout = fut.layout
            flat, event = None, None
            if layout.has_payload:
                # the disk buffer is held across attempts, so a retried pack
                # re-reads intact staged bytes
                flat, event = self._retry_loop(
                    lambda: self._put_coalesced(sig, layout, src_leaves, consumer),
                    fut, f"H2D (group {fut.index})",
                )
        finally:
            if disk_buf is not None:
                self._release_disk_staging(ticket.sig, disk_buf)
        ready_at = self._emulate(link, fut.n_requests, fut.nbytes)
        fut._complete(flat=flat, copy_event=event, ready_at=ready_at)

    def _put_coalesced(self, sig: tuple, layout: GroupLayout, src_leaves, consumer):
        """One attempt of the coalesced H2D: stage, copy, wait for the copy,
        then recycle the staging buffer.  On a fault the buffer is dropped,
        not recycled: a half-issued copy may still read it."""
        staging = self._acquire_staging(sig, layout)
        layout.pack_into(src_leaves, staging)
        flat, event = layout.put_staged(staging, self._copy_stream, consumer)
        if event is not None:
            event.synchronize()  # the copy has landed: staging bytes are free
        if not layout.any_alias(flat, staging):
            self._release_staging(sig, staging)
        return flat, event

    def _put_per_leaf(self, group: Pytree, consumer):
        """One attempt of the per-leaf H2D: one copy per host leaf, at the
        canonical dtype (as ``jax.device_put``)."""
        def put(x):
            if _resident(x, self.device):
                return x
            t = host_tensor(x)
            return t.to(device=self.device, dtype=canonical(t.dtype), non_blocking=True, copy=True)

        if self._copy_stream is None:
            return tr.tree_map(put, group)
        with torch.cuda.stream(self._copy_stream):
            tree = tr.tree_map(put, group)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        event.synchronize()
        for x, t in zip(tr.leaves(group), tr.leaves(tree)):
            if t is not x:
                t.record_stream(consumer)
        return tree

    def _get(self, group_out: Pytree, ready) -> Pytree:
        """One attempt of a D2H writeback: CPU copies of the group's leaves
        (page-locked on the card, copied on the copy stream after ``ready``)."""
        if self._copy_stream is None:
            return tr.tree_map(lambda t: t.detach().clone(), group_out)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            host = tr.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True),
                group_out,
            )
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        event.synchronize()
        return host

    # -- disk worker thread (pipeline stage 1) ------------------------------
    def _disk_worker_loop(self) -> None:
        from repro_torch.core.spillstore import verify_disk_leaf

        link = self.config.disk_link
        while True:
            task = self._disk_tasks.get()
            if task is None:
                return
            ticket, disk_leaves = task
            attempts = max(1, self.config.max_attempts)
            for attempt in range(attempts):
                buf = None
                try:
                    layout = self._disk_layouts[ticket.sig]
                    if self.config.verify_spill:
                        # CRC-check the mapped bytes before consuming them
                        disk_leaves = [verify_disk_leaf(x) for x in disk_leaves]
                    buf = self._acquire_disk_staging(ticket.sig, layout)
                    # the copy out of the memory-mapped view IS the disk read
                    layout.pack_into(disk_leaves, buf)
                    views = layout.views(buf)
                    ticket.ready_at = self._emulate(link, ticket.n_requests, ticket.nbytes,
                                                    lock=self._disk_link_lock)
                    ticket.views = views
                    ticket.buf = buf
                    ticket._event.set()
                    break
                except BaseException as e:  # noqa: BLE001 — retry or surface
                    if buf is not None:
                        self._release_disk_staging(ticket.sig, buf)
                    if attempt + 1 >= attempts or not _retryable(e):
                        ticket._error = e
                        ticket._event.set()
                        break
                    ticket.retries += 1
                    log.warning("transient disk-stage fault (attempt %d/%d), backing off: %s",
                                attempt + 1, attempts, e)
                    _sleep_precise(self.config.retry_backoff_s * (2.0 ** attempt))

    def _emulate(self, link: Optional[LinkModel], n_requests: int, nbytes: int, *,
                 lock: Optional[threading.Lock] = None) -> float:
        """Hold the emulated link for the transfer's occupancy and return the
        completion time including the overlappable latency tail."""
        if link is None or n_requests == 0:
            return 0.0
        occ = link.occupancy_s(n_requests, nbytes)
        if occ > 0:
            with (lock if lock is not None else self._link_lock):
                _sleep_precise(occ)
        return time.perf_counter() + link.latency_s

    def emulate_blocking_transfer(self, n_requests: int, nbytes: int) -> None:
        """Pay the emulated link for a transfer issued on the caller's thread
        (the blocking writeback schedule).  No-op without a link model."""
        ready_at = self._emulate(self.config.link, n_requests, nbytes)
        residual = ready_at - time.perf_counter()
        if residual > 0:
            _sleep_precise(residual)
