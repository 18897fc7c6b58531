"""Host-driver streaming engine: the paper's host process + channels.

The paper's architecture (§4, Fig 2) keeps bulk data on the host; a
host-side service decodes references and feeds per-core channels while
device code computes.  :class:`HostStreamExecutor` is that at framework
level: state stays outside the device as host arrays or tensors; a
background :class:`~repro_torch.core.engine.TransferEngine` (the host
service) coalesces, stages and copies group ``i + distance`` while the
``apply`` of group ``i`` runs.

Three transfer schedules, mirroring the paper's evaluation axes:

``eager``      copy *all* groups, then compute (paper's original offload).
``on_demand``  copy group i synchronously right before computing it
               (pass-by-reference without prefetch).
``prefetch``   keep ``distance`` groups in flight ahead of compute.
               ``PrefetchSpec(distance="auto")`` lets
               :class:`~repro_torch.core.engine.AdaptiveDistance` size the
               window from observed stalls.

``compute_s`` is host-clock time: kernel launches are asynchronous, so it
is the time to dispatch each group's ``apply`` plus the final synchronise
of the device, as in the JAX package (its ``block_until_ready``).
``transfer_wait_s`` is the time the compute thread blocked on transfers
that had not landed.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import nbytes
from repro_torch.core.engine import AdaptiveDistance, EngineConfig, TransferEngine
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["StreamStats", "HostStreamExecutor"]

Pytree = Any

#: histogram bucket upper bounds (seconds) for per-group transfer waits
_WAIT_BINS = (10e-6, 100e-6, 1e-3, 10e-3, 100e-3)

#: cap on retained per-group samples (waits, distance trace)
_MAX_SAMPLES = 4096


@dataclasses.dataclass
class StreamStats:
    """Per-run accounting (the paper's Table 2 instrumentation).

    ``n_transfers`` counts *logical* group transfers (one per group per
    direction — the seed's unit, kept for continuity); ``h2d_requests`` /
    ``d2h_requests`` count the *actual* requests issued on the link, which
    is what the paper's on-demand penalty scales with.  With coalescing a
    group is one request regardless of its leaf count.
    """

    mode: str = "prefetch"
    n_transfers: int = 0
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    #: addressable devices groups staged onto (max over groups; 1 for
    #: default placement).  With sharding-aware coalescing a group costs
    #: one request per device, so ``requests_per_group == n_devices``
    n_devices: int = 1
    #: sum over groups of that group's device count — the denominator of
    #: the per-(device, group) request invariant, exact even when one run
    #: mixes sharded and default-placement groups
    n_device_groups: int = 0
    # -- residency accounting (the link-traffic truth) ----------------------
    #: submits that actually crossed a link (>= 1 H2D or disk request).
    #: ``requests_per_group`` is a per-PASS invariant and resets its
    #: denominator with every run, so a step whose forward AND backward each
    #: re-fetch every group still reads a clean 1.0/group — this counter is
    #: what benches gate real per-step traffic on instead
    unique_group_fetches: int = 0
    #: submits whose group was already device-resident end to end (weight
    #: residency-cache hits, and device-kind pass-through): zero link bytes
    cache_hits: int = 0
    #: submits that had to move bytes (always == unique_group_fetches; kept
    #: as its own counter so hit-rate reads don't conflate the two views)
    cache_misses: int = 0
    #: pops satisfied by a same-step fetch of the same *content* key — the
    #: copy-on-write prefix-sharing win: N requests whose prompts share a
    #: page-aligned prefix cost ONE fetch (one ``n_groups`` entry) plus
    #: N-1 shared hits, so ``h2d_requests == n_groups`` stays exact
    shared_hits: int = 0
    #: sum of per-group device counts over *fetched* groups only — the
    #: denominator that keeps the one-request-per-(device, group) coalescing
    #: invariant checkable when resident groups pass through at zero requests
    fetched_device_groups: int = 0
    transfer_wait_s: float = 0.0  # time the *compute* path blocked on data
    compute_s: float = 0.0
    total_s: float = 0.0
    # -- engine-era accounting ----------------------------------------------
    h2d_requests: int = 0
    d2h_requests: int = 0
    n_groups: int = 0
    n_runs: int = 0
    writeback_drain_s: float = 0.0
    #: max H2D payload bytes of groups simultaneously in flight (submitted
    #: but not yet consumed by their apply) — the schedule's device-residency
    #: model for streamed state; what ``--device-budget-mb`` gates against
    peak_inflight_bytes: int = 0
    # -- disk tier (DiskHost groups: stage-1 of the three-level pipeline) ---
    disk_requests: int = 0
    bytes_disk: int = 0
    #: time the *transfer worker* (stage 2) blocked on disk fetches; zero
    #: once the disk read-ahead window hides the disk latency
    disk_wait_s: float = 0.0
    # -- robustness (EngineConfig.max_attempts retry) -----------------------
    #: transient transfer faults absorbed by retry (H2D, D2H, disk stage);
    #: equals the injected fault count in the fault-injection benches
    retries: int = 0
    #: transfers that exhausted ``max_attempts`` (the error surfaced)
    give_ups: int = 0
    #: per-group compute-thread stall (the wait histogram's raw samples);
    #: bounded so a stats object shared across a long training run does not
    #: grow with step count — old samples age out, aggregates stay exact
    wait_per_group: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=_MAX_SAMPLES)
    )
    #: prefetch window size used for each group (adaptive-distance trace)
    distance_trace: "deque[int]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=_MAX_SAMPLES)
    )
    #: per-group stage-2-on-stage-1 (H2D-on-disk) stall samples
    disk_wait_per_group: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=_MAX_SAMPLES)
    )

    @property
    def requests_per_group(self) -> float:
        return self.h2d_requests / self.n_groups if self.n_groups else 0.0

    @property
    def disk_requests_per_group(self) -> float:
        return self.disk_requests / self.n_groups if self.n_groups else 0.0

    def per_tier(self) -> dict[str, dict[str, float]]:
        """Request/byte/wait counters per hierarchy tier (paper Table 2,
        extended down the hierarchy).  The wait of each tier is the stall
        of the consumer one level up: compute stalls on host->device,
        host->device stalls on disk."""
        per_dev_groups = self.n_device_groups or self.n_groups
        return {
            "h2d": {
                "requests": self.h2d_requests,
                "bytes": self.bytes_h2d,
                "wait_s": self.transfer_wait_s,
                "requests_per_group": self.requests_per_group,
                "requests_per_device_group": (
                    self.h2d_requests / per_dev_groups if per_dev_groups else 0.0
                ),
                "requests_per_fetched_device_group": (
                    self.h2d_requests / self.fetched_device_groups
                    if self.fetched_device_groups
                    else 0.0
                ),
                "unique_group_fetches": self.unique_group_fetches,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "shared_hits": self.shared_hits,
            },
            "d2h": {
                "requests": self.d2h_requests,
                "bytes": self.bytes_d2h,
                "wait_s": self.writeback_drain_s,
            },
            "disk": {
                "requests": self.disk_requests,
                "bytes": self.bytes_disk,
                "wait_s": self.disk_wait_s,
                "requests_per_group": self.disk_requests_per_group,
            },
        }

    def wait_hist(self, bins: Sequence[float] = _WAIT_BINS) -> dict[str, int]:
        """Per-group wait histogram: bucket label -> count."""
        counts = [0] * (len(bins) + 1)
        for w in self.wait_per_group:
            for j, ub in enumerate(bins):
                if w <= ub:
                    counts[j] += 1
                    break
            else:
                counts[-1] += 1
        labels = [f"<={ub:.0e}s" for ub in bins] + [f">{bins[-1]:.0e}s"]
        return dict(zip(labels, counts))

    def reset(self) -> None:
        """Zero all counters (keeps ``mode``) — one benchmark repeat."""
        fresh = StreamStats(mode=self.mode)
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))

    def as_row(self) -> dict[str, Any]:
        row = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("wait_per_group", "distance_trace", "disk_wait_per_group")
        }
        row["requests_per_group"] = self.requests_per_group
        row["disk_requests_per_group"] = self.disk_requests_per_group
        row["wait_hist"] = self.wait_hist()
        row["per_tier"] = self.per_tier()
        row["final_distance"] = self.distance_trace[-1] if self.distance_trace else None
        return row


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the JAX package's block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostStreamExecutor:
    """Drives ``carry = apply(carry, group)`` over host-resident groups.

    ``apply`` is a plain callable on tensors: ``(carry, group) -> carry``, or
    ``(carry, group) -> (carry, group_out)`` with ``writeback=True`` (the
    paper's ``rw`` access: ``group_out`` is copied back to the host).  With
    ``indexed=True`` it is called as ``apply(i, carry, group)``, ``i`` the
    group's position in the run: a heterogeneous sequence whose stages
    differ (the weight stream: embed, layer groups, head).  The engine is
    private (``EngineConfig()`` or ``engine_config``) unless one is passed;
    it stages onto ``device`` (the card unless ``"cpu"``).

    ``device_shardings`` (a tree of
    :class:`~repro_torch.core.memkind.Sharding`, broadcast over every
    group) stages each group at explicit layouts under a mesh: still one
    H2D request a (rank, group), the leaves DTensors.  Per-run
    heterogeneous layouts pass ``group_shardings`` to :meth:`run` instead.
    """

    _UNSET = object()

    def __init__(
        self,
        apply: Callable[..., Any],
        *,
        writeback: bool = False,
        engine: Optional[TransferEngine] = None,
        engine_config: Optional[EngineConfig] = None,
        device: DeviceLike = None,
        indexed: bool = False,
        device_shardings: Optional[Pytree] = None,
    ) -> None:
        if engine is not None and device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"device {device} differs from the engine's {engine.device}")
        self._apply = apply
        self._shardings = device_shardings
        self._writeback = writeback
        self._indexed = indexed
        self._engine = engine or TransferEngine(engine_config, device=device)
        self._owns_engine = engine is None
        #: adaptive-distance state, persistent across run() calls
        self._controller: Optional[AdaptiveDistance] = None

    @property
    def engine(self) -> TransferEngine:
        return self._engine

    @property
    def device(self) -> torch.device:
        return self._engine.device

    def close(self) -> None:
        if self._owns_engine:
            self._engine.close()

    def __enter__(self) -> "HostStreamExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _submit(self, index: int, group: Pytree, shardings: Any = _UNSET, key=None):
        if shardings is self._UNSET:
            shardings = self._shardings
        return self._engine.submit_group(index, group, device_shardings=shardings, key=key)

    def run(
        self,
        carry: Pytree,
        groups: Sequence[Pytree],
        *,
        prefetch: Optional[PrefetchSpec] = None,
        mode: str = "prefetch",
        stats: Optional[StreamStats] = None,
        group_shardings: Optional[Sequence[Pytree]] = None,
        group_keys: Optional[Sequence[Optional[str]]] = None,
    ) -> tuple[Pytree, Optional[list]]:
        """Execute all groups under the given schedule.  Returns the final
        carry (+ the written-back host groups when ``writeback``).

        ``group_shardings``: optional per-group shardings (one tree per
        group, ``None`` for default placement), overriding the executor's
        ``device_shardings`` run by run.

        ``group_keys``: optional logical names (one per group) passed to the
        engine's fetches and writebacks, so the hazard sanitizer chains the
        transfers of one group across runs; unnamed groups are unchecked.

        A ``groups`` entry may be a zero-argument callable, resolved when its
        transfer is submitted: the weight stream's residency substitution
        must see the cache as it is when the fetch is issued."""
        if mode not in ("eager", "on_demand", "prefetch"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "prefetch" and prefetch is None:
            prefetch = PrefetchSpec()
        n = len(groups)
        if group_shardings is not None and len(group_shardings) != n:
            raise ValueError(
                f"group_shardings has {len(group_shardings)} entries for {n} groups")
        if group_keys is not None and len(group_keys) != n:
            raise ValueError(f"group_keys has {len(group_keys)} entries for {n} groups")
        st = stats if stats is not None else StreamStats()
        st.mode = mode
        st.n_runs += 1
        st.n_groups += n
        cfg = self._engine.config
        if self._writeback and cfg.async_writeback:
            # a failed previous run may have left tickets behind
            self._engine.discard_writebacks()
        controller: Optional[AdaptiveDistance] = None
        if mode != "prefetch":
            distance = 0
        elif prefetch.is_auto:
            # the controller persists across run() calls (one run per step)
            if self._controller is None:
                self._controller = AdaptiveDistance(
                    initial=cfg.min_distance,
                    min_distance=cfg.min_distance,
                    max_distance=cfg.max_distance,
                    wait_eps_s=cfg.wait_eps_s,
                    shrink_after=cfg.shrink_after,
                )
                self._engine.register_controller(self._controller)
            controller = self._controller
            distance = controller.distance
        else:
            distance = max(prefetch.distance, 1)
        t_start = time.perf_counter()
        outs: Optional[list] = [] if self._writeback else None

        #: H2D payload bytes of submitted-but-not-yet-consumed groups
        live_bytes = 0

        def key_of(i: int):
            return group_keys[i] if group_keys is not None else None

        def submit(i: int):
            nonlocal live_bytes
            group = groups[i]() if callable(groups[i]) else groups[i]
            if group_shardings is None:
                fut = self._submit(i, group, key=key_of(i))
            else:  # the per-group override is authoritative (None = default)
                fut = self._submit(i, group, group_shardings[i], key=key_of(i))
            st.n_transfers += 1
            st.h2d_requests += fut.n_requests
            st.bytes_h2d += fut.nbytes
            st.disk_requests += fut.disk_requests
            st.bytes_disk += fut.disk_nbytes
            st.n_devices = max(st.n_devices, fut.n_devices)
            st.n_device_groups += fut.n_devices
            if fut.is_resident:
                st.cache_hits += 1
            else:
                st.cache_misses += 1
                st.unique_group_fetches += 1
                st.fetched_device_groups += fut.n_devices
            live_bytes += fut.nbytes
            st.peak_inflight_bytes = max(st.peak_inflight_bytes, live_bytes)
            return fut

        wb_tickets: list = []

        def waited(fut) -> float:
            try:
                w = fut.wait()
            except BaseException:
                st.retries += fut.retries
                st.give_ups += 1
                raise
            st.retries += fut.retries
            return w

        if mode == "eager":
            # bulk transfer first — the paper's original kernel invocation
            futs = [submit(i) for i in range(n)]
            for fut in futs:
                w = waited(fut)
                st.transfer_wait_s += w
                st.wait_per_group.append(w)
                st.disk_wait_s += fut.disk_wait_s
                st.disk_wait_per_group.append(fut.disk_wait_s)
            t0 = time.perf_counter()
            for i, fut in enumerate(futs):
                carry = self._step(i, carry, fut.group(), outs, st, wb_tickets, key_of(i))
                live_bytes -= fut.nbytes
            _sync(self.device)
            st.compute_s += time.perf_counter() - t0
        else:
            inflight: "OrderedDict[int, Any]" = OrderedDict()
            issued = 0
            for i in range(n):
                # top up the pipeline to `distance` groups ahead
                while issued <= min(i + distance, n - 1):
                    inflight[issued] = submit(issued)
                    issued += 1
                fut = inflight.pop(i)
                # the paper's blocking fetch: stall until the data has landed
                w = waited(fut)
                st.transfer_wait_s += w
                st.wait_per_group.append(w)
                st.distance_trace.append(distance)
                st.disk_wait_s += fut.disk_wait_s
                st.disk_wait_per_group.append(fut.disk_wait_s)
                if controller is not None:
                    distance = controller.observe(w)
                t0 = time.perf_counter()
                carry = self._step(i, carry, fut.group(), outs, st, wb_tickets, key_of(i))
                live_bytes -= fut.nbytes
                st.compute_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            _sync(self.device)
            st.compute_s += time.perf_counter() - t0

        if self._writeback and cfg.async_writeback:
            t0 = time.perf_counter()
            try:
                outs = self._engine.drain_writebacks()
            except BaseException:
                st.retries += sum(t.retries for t in wb_tickets)
                st.give_ups += 1
                raise
            st.retries += sum(t.retries for t in wb_tickets)
            st.writeback_drain_s += time.perf_counter() - t0

        st.total_s = time.perf_counter() - t_start
        return (carry, outs) if self._writeback else (carry, None)

    def _step(self, index: int, carry: Pytree, buf: Pytree, outs: Optional[list],
              st: StreamStats, wb_tickets: list, wb_key=None) -> Pytree:
        apply = (lambda c, b: self._apply(index, c, b)) if self._indexed else self._apply
        if not self._writeback:
            return apply(carry, buf)
        carry, group_out = apply(carry, buf)
        out_bytes = sum(nbytes(x) for x in tr.leaves(group_out))
        st.bytes_d2h += out_bytes
        st.n_transfers += 1
        if self._engine.config.async_writeback:
            # pipelined writeback: D2H runs on the engine worker while the
            # next group computes; drained in order after the loop
            ticket = self._engine.submit_writeback(len(outs), group_out, key=wb_key)
            st.d2h_requests += ticket.n_requests
            wb_tickets.append(ticket)
            outs.append(None)  # placeholder — replaced by the drain
        else:
            host_out = tr.tree_map(lambda t: t.detach().to("cpu", copy=True), group_out)
            n_leaves = len(tr.leaves(group_out))
            # the blocking copy occupies the same (possibly emulated) link
            self._engine.emulate_blocking_transfer(n_leaves, out_bytes)
            st.d2h_requests += n_leaves
            outs.append(host_out)
        return carry
