"""Stream accounting — ``StreamStats`` with the JAX package's field names.

``serve()`` returns one.  The host-stream executor that fills its transfer
counters, and the reports over them (``per_tier``, ``wait_hist``,
``as_row``), follow in the paper slice (ROADMAP.md, queue 1 item 2); on the
device-resident serving path every counter stays zero.
"""
from __future__ import annotations

import dataclasses
from collections import deque

__all__ = ["StreamStats"]

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
