"""Static schedule verification and the runtime hazard sanitizer.

The JAX package's ``repro.core.schedcheck`` on the port.  The streamed-memory
runtime derives every transfer from a
:class:`~repro_torch.core.weightstream.WeightStreamPlan` group program, so
the whole schedule (fetch order, residency, writebacks, KV paging) is known
before the engine runs.  This module executes those programs symbolically
and checks, at every program point:

1. **Exact device occupancy** within the device budget.  The plan's
   ``peak_device_bytes`` is a sliding-window fast path (``distance + 2``
   consecutive stream units); the analyzer replays the executor loop (top
   up to ``i + distance``, consume, retire one stage later) and takes the
   maximum over in-flight window bytes + residency cache bytes + the KV hot
   reservation, including the tied-embed head borrow.
2. **Staging lifetime**: no pool slot reacquired while a ticket is in
   flight (the runtime sanitizer; the pool is engine-internal).
3. **RAW hazards** between D2H writeback drains and H2D re-fetches of the
   same group or page.
4. **Pin balance** and **spill-key uniqueness** across the program.

Static entry points: :func:`analyze_train_schedule`,
:func:`analyze_serve_schedule`, :func:`verify_schedule` (raises
:class:`ScheduleError` carrying the :class:`ScheduleReport`).  Runtime side:
:class:`HazardSanitizer` (in :class:`~repro_torch.core.engine.TransferEngine`
and :class:`~repro_torch.core.residency.ResidencyCache` under
``EngineConfig(sanitize=True)`` or ``REPRO_SANITIZE=1``) raises
:class:`HazardError` at the faulting call.

The analyzers duck-type the plan (only its byte model and group and unit
tuples are read), and the reports are the JAX package's, string for string.
``python -m repro_torch.core.schedcheck`` sweeps every supported smoke
config × layout × ``expert_stream`` (with and without a budget) through
both analyzers and exits 1 on a violation, as the JAX package's CI sweep.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from collections import OrderedDict
from typing import Any, Iterable, Optional, Sequence

__all__ = [
    "HazardError",
    "HazardSanitizer",
    "PhasePeak",
    "ScheduleError",
    "ScheduleReport",
    "ScheduleViolation",
    "analyze_serve_schedule",
    "analyze_train_schedule",
    "sanitize_enabled",
    "tree_fingerprint",
    "verify_schedule",
]


def sanitize_enabled(default: bool = False) -> bool:
    """Whether ``REPRO_SANITIZE`` asks for the runtime hazard sanitizer."""
    v = os.environ.get("REPRO_SANITIZE")
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "no")


class HazardError(RuntimeError):
    """A runtime transfer-hazard the sanitizer refuses to let proceed.

    Deliberately NOT a transient fault: the engine's retry loop must never
    swallow one (a hazard retried is a hazard hidden)."""


@dataclasses.dataclass(frozen=True)
class ScheduleViolation:
    rule: str  # "budget" | "raw-writeback" | "pin-overcommit" | ...
    phase: str
    index: int
    key: str
    message: str
    occupancy_bytes: int = 0
    budget_bytes: int = 0

    def __str__(self) -> str:
        loc = f"{self.phase}[{self.index}] {self.key}".rstrip()
        return f"{self.rule} @ {loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class PhasePeak:
    phase: str
    n_points: int  # program points measured (submits + consumes)
    peak_bytes: int
    at_index: int
    at_key: str


@dataclasses.dataclass
class ScheduleReport:
    kind: str  # "train" | "serve"
    name: str
    layout: str
    distance: int
    budget_bytes: Optional[int]
    cache_capacity_bytes: Optional[int]
    cached: bool
    phases: list = dataclasses.field(default_factory=list)
    violations: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)
    n_spill_keys: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def peak_bytes(self) -> int:
        return max((p.peak_bytes for p in self.phases), default=0)

    def __str__(self) -> str:
        mb = lambda b: "unbounded" if b is None else f"{b / 1e6:.2f}MB"  # noqa: E731
        lines = [
            f"schedule[{self.kind}] {self.name}: layout={self.layout} "
            f"distance={self.distance} budget={mb(self.budget_bytes)} "
            f"cache={mb(self.cache_capacity_bytes) if self.cached else 'off'}"
        ]
        for p in self.phases:
            lines.append(
                f"  {p.phase:<9s} {p.n_points:4d} points  "
                f"peak {p.peak_bytes / 1e6:8.2f}MB  at {p.at_key}"
            )
        for n in self.notes:
            lines.append(f"  note: {n}")
        if self.n_spill_keys:
            lines.append(f"  spill keys: {self.n_spill_keys} unique")
        if self.violations:
            lines.append(f"  VIOLATIONS ({len(self.violations)}):")
            for v in self.violations:
                lines.append(f"    - {v}")
        else:
            lines.append("  OK: occupancy, hazards, pins verified")
        return "\n".join(lines)


class ScheduleError(RuntimeError):
    """Static verification failed; ``.report`` holds the full analysis."""

    def __init__(self, report: ScheduleReport) -> None:
        super().__init__(str(report))
        self.report = report


# --------------------------------------------------------------------------
# residency-cache simulator — mirrors core.residency.ResidencyCache exactly:
# OrderedDict LRU, put on an existing key touches + widens the pin without
# re-inserting bytes, eviction walks LRU order skipping pinned entries and
# refuses the put when only pinned entries remain.
class _CacheSim:
    def __init__(self, capacity_bytes: Optional[int]) -> None:
        self.capacity_bytes = capacity_bytes
        self._entries: "OrderedDict[str, list]" = OrderedDict()  # key -> [nbytes, pinned]
        self.resident_bytes = 0

    def lookup(self, key: str) -> bool:
        e = self._entries.get(key)
        if e is None:
            return False
        self._entries.move_to_end(key)
        return True

    def peek(self, key: str) -> bool:
        return key in self._entries

    def put(self, key: str, nbytes: int, *, pinned: bool = False) -> bool:
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
            e[1] = e[1] or pinned
            return True
        cap = self.capacity_bytes
        if cap is not None:
            # refusal must leave the cache untouched (ResidencyCache sizes
            # the eviction set before dropping anything)
            evictable = [k for k, v in self._entries.items() if not v[1]]
            spare = cap - self.resident_bytes
            i = 0
            while spare < nbytes and i < len(evictable):
                spare += self._entries[evictable[i]][0]
                i += 1
            if spare < nbytes:
                return False
            for k in evictable[:i]:
                self.resident_bytes -= self._entries.pop(k)[0]
        self._entries[key] = [nbytes, pinned]
        self.resident_bytes += nbytes
        return True

    def keys(self) -> list:
        return list(self._entries)

    def unpin_all(self) -> None:
        for e in self._entries.values():
            e[1] = False


# --------------------------------------------------------------------------
# phase simulator: replays HostStreamExecutor.run over one fetch order.


class _PhaseSim:
    """Symbolic executor for one streamed phase.

    Occupancy components tracked per program point (after every submit and
    every consume, exactly where the engine's live-byte gauge moves):

    - ``alive``: fetched-but-not-retired group bytes.  A group retires one
      stage after its unit's compute consumed it (the previous stage's
      buffers are still referenced while the next stage lands) — the same
      ``distance + 2`` shape the fast-path window model bounds.
    - residency-cache bytes (``_CacheSim``), minus the overlap with alive
      fetches: a consumed group cached in place reduces its alive residual
      to fetch − home bytes (the tied-embed borrow is the residual on the
      head group).
    - a constant baseline (KV hot-page reservation for serve).
    """

    def __init__(
        self,
        report: ScheduleReport,
        phase: str,
        *,
        cache: Optional[_CacheSim],
        budget_bytes: Optional[int],
        baseline_bytes: int = 0,
    ) -> None:
        self.report = report
        self.phase = phase
        self.cache = cache
        self.budget = budget_bytes
        self.baseline = baseline_bytes
        self.alive: "OrderedDict[int, int]" = OrderedDict()  # gindex -> bytes
        self.pending_wb: dict = {}  # key -> count
        self.n_points = 0
        self.peak = 0
        self.peak_at = (-1, "")
        self.transient = 0  # stage-local extra bytes (expert fan-in)

    def occupancy(self) -> int:
        cache_bytes = self.cache.resident_bytes if self.cache else 0
        return (
            self.baseline
            + self.transient
            + cache_bytes
            + sum(self.alive.values())
        )

    def measure(self, index: int, key: str) -> None:
        occ = self.occupancy()
        self.n_points += 1
        if occ > self.peak:
            self.peak, self.peak_at = occ, (index, key)
        if self.budget is not None and occ > self.budget:
            self.report.violations.append(
                ScheduleViolation(
                    "budget",
                    self.phase,
                    index,
                    key,
                    f"device occupancy {occ / 1e6:.2f}MB exceeds budget "
                    f"{self.budget / 1e6:.2f}MB "
                    f"(window {sum(self.alive.values()) / 1e6:.2f}MB + cache "
                    f"{(self.cache.resident_bytes if self.cache else 0) / 1e6:.2f}MB"
                    + (
                        f" + reserved {self.baseline / 1e6:.2f}MB"
                        if self.baseline
                        else ""
                    )
                    + ")",
                    occupancy_bytes=occ,
                    budget_bytes=self.budget,
                )
            )

    # -- engine events -----------------------------------------------------
    def submit(self, g, fetch_bytes: int, key: str) -> None:
        if key in self.pending_wb:
            self.report.violations.append(
                ScheduleViolation(
                    "raw-writeback",
                    self.phase,
                    g.index,
                    key,
                    "H2D fetch submitted while a D2H writeback of the same "
                    "group is still in flight (drain before re-fetching)",
                )
            )
        self.alive[g.index] = fetch_bytes
        self.measure(g.index, key)

    def writeback(self, key: str) -> None:
        self.pending_wb[key] = self.pending_wb.get(key, 0) + 1

    def drain(self) -> None:
        self.pending_wb.clear()

    def retire(self, gindex: int) -> None:
        self.alive.pop(gindex, None)

    def finish(self) -> None:
        self.drain()
        self.alive.clear()
        self.transient = 0
        idx, key = self.peak_at
        self.report.phases.append(
            PhasePeak(self.phase, self.n_points, self.peak, idx, key)
        )


def _unit_of(plan) -> tuple:
    """Map group index -> unit id, plus unit id -> member count."""
    out = {0: 0}  # embed is its own stage
    size = {0: 1}
    uid = 1
    for u in plan.units:
        for gi in u.gidx:
            out[gi] = uid
        size[uid] = len(u.gidx)
        uid += 1
    out[plan.groups[-1].index] = uid  # head
    size[uid] = 1
    return out, size


def _run_phase(
    plan,
    order: Sequence,
    sim: _PhaseSim,
    *,
    distance: int,
    pin_keys: Iterable[str] = (),
    cache_puts: bool = True,
    writeback: bool = False,
    moe_fan: Optional[int] = None,
    units: bool = True,
) -> None:
    """Replay the executor loop over ``order`` (a sequence of groups).

    Top-up submits to ``i + distance``; consume applies stage ``i``; the
    groups of the *previous completed unit* retire when the next unit's
    compute is issued (a ``moe`` unit's stage fires once all its members
    are consumed, whichever direction the order walks them).
    ``units=False`` treats every group as its own stage (the decode
    program fetches one leading group per unit).  ``moe_fan`` (decode)
    adds the routed expert fan-in as a stage transient on each
    unit-leading layers group.
    """
    pin_keys = set(pin_keys)
    unit_of, unit_size = _unit_of(plan)
    n = len(order)
    submitted = 0
    fetch_hit: dict = {}  # gindex -> cache hit at submit time
    consumed: dict = {}  # unit id -> members consumed so far
    prev_unit_groups: list = []
    cur_unit_groups: list = []

    def _submit(j: int) -> None:
        g = order[j]
        hit = sim.cache.lookup(g.key) if sim.cache else False
        fetch_hit[g.index] = hit
        if hit:
            nbytes = 0
        elif (
            g.kind == "head"
            and sim.cache
            and getattr(plan, "head_reads_embed", False)
            and sim.cache.peek(plan.groups[0].key)
        ):
            # tied head with the embed group resident: the table re-read
            # is served from the cached embed tree, only home bytes move
            nbytes = plan.head_home_bytes
        else:
            nbytes = plan.group_bytes(g, fetch=True)
        sim.submit(g, nbytes, g.key)

    for i in range(n):
        while submitted <= min(i + distance, n - 1):
            _submit(submitted)
            submitted += 1
        g = order[i]
        uid = unit_of[g.index]
        cur_unit_groups.append(g.index)
        consumed[uid] = consumed.get(uid, 0) + 1
        if sim.cache and cache_puts:
            home = plan.group_bytes(g, fetch=False)
            if sim.cache.put(g.key, home, pinned=g.key in pin_keys):
                if not fetch_hit.get(g.index, False):
                    # the cached tree IS the landed tree: only the
                    # non-cacheable residual (head's table borrow) stays
                    # attributed to the stream window
                    sim.alive[g.index] = max(
                        0, sim.alive.get(g.index, 0) - home
                    )
        if writeback:
            sim.writeback(g.key)
        if not units or consumed[uid] >= unit_size[uid]:
            # unit compute issued: the previous unit's buffers retire
            if moe_fan is not None and g.kind == "layers":
                sim.transient = moe_fan * plan.per_expert_bytes
            for gi in prev_unit_groups:
                sim.retire(gi)
            prev_unit_groups, cur_unit_groups = cur_unit_groups, []
            sim.measure(g.index, g.key)
            sim.transient = 0
    sim.finish()


def _default_pin_keys(plan, bwd_order, capacity: Optional[int]) -> list:
    """The pin prefix ``make_weight_streamed_train_step`` constructs: the
    first backward groups whose home bytes fit the cache capacity (an
    unbounded cache pins them all)."""
    keys, total = [], 0
    for g in bwd_order:
        nb = plan.group_bytes(g, fetch=False)
        if capacity is not None and total + nb > capacity:
            break
        keys.append(g.key)
        total += nb
    return keys


def _check_spill_keys(plan, report: ScheduleReport) -> None:
    keys = [plan.spill_key(g) for g in plan.groups]
    keys += [f"wopt/{g.key}" for g in plan.groups]
    seen: set = set()
    for k in keys:
        if k in seen:
            report.violations.append(
                ScheduleViolation(
                    "spill-key-collision",
                    "spill",
                    -1,
                    k,
                    "two groups map to the same spill-store key",
                )
            )
        seen.add(k)
    report.n_spill_keys = len(seen)


def _check_pins(plan, pin_keys, capacity, report: ScheduleReport) -> None:
    by_key = {g.key: g for g in plan.groups}
    total = 0
    for k in pin_keys:
        g = by_key.get(k)
        if g is None:
            report.violations.append(
                ScheduleViolation(
                    "pin-unknown-key", "pins", -1, k,
                    "pin key names no group in the plan",
                )
            )
            continue
        total += plan.group_bytes(g, fetch=False)
    if capacity is not None and total > capacity:
        report.violations.append(
            ScheduleViolation(
                "pin-overcommit",
                "pins",
                -1,
                ",".join(pin_keys),
                f"pinned home bytes {total / 1e6:.2f}MB exceed cache "
                f"capacity {capacity / 1e6:.2f}MB — the backward turnaround "
                "cannot keep its groups resident",
            )
        )


def analyze_train_schedule(
    plan,
    *,
    distance: int,
    cached: bool = True,
    cache_capacity: Optional[int] = None,
    budget_bytes: Optional[int] = None,
    spill: bool = False,
    pin_keys: Optional[Sequence[str]] = None,
) -> ScheduleReport:
    """Symbolically execute the streamed train step's three phases.

    Forward walks ``plan.groups`` in fetch order; backward walks the
    middle groups reversed then the embed group; the optimizer phase walks
    head + backward order with a D2H writeback per group (hazard-checked,
    not budget-checked — optimizer residency is accounted by its own
    stats, matching the runtime's budget convention)."""
    if budget_bytes is None:
        budget_bytes = getattr(plan, "device_budget_bytes", None)
    report = ScheduleReport(
        kind="train",
        name=getattr(getattr(plan, "cfg", None), "name", "?"),
        layout=plan.layout,
        distance=distance,
        budget_bytes=budget_bytes,
        cache_capacity_bytes=cache_capacity if cached else None,
        cached=cached,
    )
    groups = list(plan.groups)
    bwd_order = list(reversed(groups[1:-1])) + [groups[0]]
    o_order = [groups[-1]] + bwd_order
    cache = _CacheSim(cache_capacity) if cached else None
    if pin_keys is None:
        pin_keys = _default_pin_keys(plan, bwd_order, cache_capacity) if cached else []
    _check_pins(plan, pin_keys, cache_capacity if cached else None, report)

    sim = _PhaseSim(report, "forward", cache=cache, budget_bytes=budget_bytes)
    _run_phase(plan, groups, sim, distance=distance, pin_keys=pin_keys)
    sim = _PhaseSim(report, "backward", cache=cache, budget_bytes=budget_bytes)
    _run_phase(plan, bwd_order, sim, distance=distance, pin_keys=pin_keys)
    # optimizer: hazard + refresh coverage only (budget convention: the
    # F+B stream peak is what --device-budget-mb bounds; optimizer state
    # is reported separately by opt_stats)
    sim = _PhaseSim(report, "optimizer", cache=cache, budget_bytes=None)
    _run_phase(plan, o_order, sim, distance=distance, writeback=True)
    if cache is not None:
        refreshed = {g.key for g in o_order}
        for k in cache.keys():
            if k not in refreshed:
                report.violations.append(
                    ScheduleViolation(
                        "stale-residency",
                        "optimizer",
                        -1,
                        k,
                        "cached device copy not refreshed by the optimizer "
                        "writeback — later hits would read pre-update weights",
                    )
                )
        cache.unpin_all()
    if spill:
        _check_spill_keys(plan, report)
    return report


def analyze_serve_schedule(
    plan,
    *,
    distance: int,
    cached: bool = True,
    cache_capacity: Optional[int] = None,
    budget_bytes: Optional[int] = None,
    route_experts: bool = True,
    fan_in: Optional[int] = None,
    kv: Optional[dict] = None,
    flush_demotions: bool = True,
) -> ScheduleReport:
    """Symbolically execute prefill + steady-state decode (+ KV paging).

    ``kv`` describes the paged cache: ``dict(slots=, page_len=,
    hot_pages=, page_nbytes=, max_len=)``.  The hot-page reservation
    (``slots × (hot_pages + 2) × page_nbytes`` — the split ``ServeSession``
    carves off the budget) is a constant occupancy baseline for both
    phases; the page schedule itself is replayed per decode step to check
    per-slot hot residency and demotion/readmit RAW ordering
    (``flush_demotions=False`` models a pager that readmits without
    draining — the seeded-hazard configuration)."""
    if budget_bytes is None:
        budget_bytes = getattr(plan, "device_budget_bytes", None)
    report = ScheduleReport(
        kind="serve",
        name=getattr(getattr(plan, "cfg", None), "name", "?"),
        layout=plan.layout,
        distance=distance,
        budget_bytes=budget_bytes,
        cache_capacity_bytes=cache_capacity if cached else None,
        cached=cached,
    )
    hot_reserved = 0
    if kv:
        hot_reserved = int(
            kv["slots"] * (kv["hot_pages"] + 2) * kv["page_nbytes"]
        )
        if budget_bytes is not None and hot_reserved >= budget_bytes:
            report.violations.append(
                ScheduleViolation(
                    "kv-budget",
                    "kv",
                    -1,
                    f"slots={kv['slots']} hot_pages={kv['hot_pages']}",
                    f"hot-page reservation {hot_reserved / 1e6:.2f}MB "
                    f"consumes the whole budget "
                    f"{budget_bytes / 1e6:.2f}MB — nothing left for the "
                    "weight stream (lower --hot-pages / --param-cache-mb "
                    "or raise --device-budget-mb)",
                    occupancy_bytes=hot_reserved,
                    budget_bytes=budget_bytes,
                )
            )
    cache = _CacheSim(cache_capacity) if cached else None

    sim = _PhaseSim(
        report, "prefill", cache=cache, budget_bytes=budget_bytes,
        baseline_bytes=hot_reserved,
    )
    _run_phase(plan, list(plan.groups), sim, distance=distance)

    # steady-state decode program: embed, one leading group per unit
    # (router-first for moe), head.  Routed decode fetches only the top-k
    # experts per slot — the fan-in is a stage transient on the unit.
    groups = plan.groups
    prog = [groups[0]] + [groups[u.gidx[0]] for u in plan.units] + [groups[-1]]
    fan = None
    if plan.expert_stream:
        E = plan.cfg.n_experts
        if not route_experts:
            fan = E
        elif fan_in is not None:
            fan = min(E, fan_in)
        else:
            slots = kv["slots"] if kv else 1
            fan = min(E, max(1, getattr(plan.cfg, "moe_top_k", 2)) * slots)
        report.notes.append(
            f"expert fan-in per moe stage: {fan}/{E} experts "
            f"({fan * plan.per_expert_bytes / 1e6:.2f}MB transient)"
        )
    sim = _PhaseSim(
        report, "decode", cache=cache, budget_bytes=budget_bytes,
        baseline_bytes=hot_reserved,
    )
    _run_phase(plan, prog, sim, distance=distance, moe_fan=fan, units=False)

    if kv:
        _run_kv_pages(kv, report, flush_demotions=flush_demotions)
    return report


def _run_kv_pages(kv: dict, report: ScheduleReport, *, flush_demotions: bool) -> None:
    """Replay the pager's per-step page schedule: pages older than the hot
    window demote D2H; a page H2D-fetched (readmit) while its demotion
    writeback still pends is a RAW hazard; per-slot device pages must stay
    within ``hot_pages + 2`` (hot window + landing + draining)."""
    page_len = max(1, int(kv["page_len"]))
    hot = int(kv["hot_pages"])
    slots = int(kv["slots"])
    max_len = int(kv.get("max_len", page_len * (hot + 3)))
    wb_pending: set = set()
    device: dict = {s: set() for s in range(slots)}
    n_steps = 0
    for t in range(max_len):
        cur = t // page_len
        for s in range(slots):
            if cur not in device[s]:
                key = f"kv/s{s}/p{cur}"
                if key in wb_pending:
                    report.violations.append(
                        ScheduleViolation(
                            "kv-raw",
                            "kv",
                            t,
                            key,
                            "page readmitted H2D while its demotion "
                            "writeback is still in flight (drain the "
                            "demotion queue before readmission)",
                        )
                    )
                device[s].add(cur)
            floor = cur - hot
            for p in [p for p in device[s] if p < floor]:
                device[s].discard(p)
                wb_pending.add(f"kv/s{s}/p{p}")
            if len(device[s]) > hot + 2:
                report.violations.append(
                    ScheduleViolation(
                        "kv-residency",
                        "kv",
                        t,
                        f"slot {s}",
                        f"{len(device[s])} device pages exceed the "
                        f"hot_pages + 2 = {hot + 2} reservation",
                    )
                )
        n_steps += 1
        if flush_demotions:
            wb_pending.clear()
    # a readmit cycle after generation: every resident page demotes, then
    # the slot re-reads them (the evict → readmit path).  With unflushed
    # demotions this is the RAW the sanitizer also catches at runtime.
    for s in range(slots):
        for p in list(device[s]):
            device[s].discard(p)
            wb_pending.add(f"kv/s{s}/p{p}")
        if flush_demotions:
            wb_pending.clear()
        for p in range(max(0, max_len - 1) // page_len - hot, max_len // page_len):
            key = f"kv/s{s}/p{p}"
            if key in wb_pending:
                report.violations.append(
                    ScheduleViolation(
                        "kv-raw", "kv", max_len, key,
                        "readmit of an evicted slot re-fetches a page whose "
                        "demotion writeback was never drained",
                    )
                )
                wb_pending.discard(key)
    report.notes.append(
        f"kv pages: {n_steps} steps, {slots} slots, "
        f"hot window {hot}+2 pages/slot verified"
    )


def verify_schedule(report: ScheduleReport) -> ScheduleReport:
    """Raise :class:`ScheduleError` if the analysis found violations."""
    if not report.ok:
        raise ScheduleError(report)
    return report


# --------------------------------------------------------------------------
# runtime hazard sanitizer


def _leaf_mark(x: Any) -> tuple:
    """``(shape, dtype name, crc32 of the first 64 elements' bytes)`` of a
    numpy, :class:`~repro_torch.core.arrays.BF16HostArray`, spill-store view
    or torch leaf: equal bytes of one dtype give one mark whatever holds
    them."""
    import numpy as np
    import torch

    from repro_torch.core.arrays import dtype_name, dtype_of

    shape = tuple(getattr(x, "shape", ()))
    try:
        dtype = dtype_name(dtype_of(x))
    except TypeError:
        dtype = str(getattr(x, "dtype", type(x).__name__))
    try:
        if isinstance(x, torch.Tensor):
            t = x.detach().reshape(-1)[:64].cpu().contiguous()
            raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        else:
            raw = np.ascontiguousarray(np.asarray(x).reshape(-1)[:64]).tobytes()
        crc = zlib.crc32(raw)
    except Exception:
        crc = 0
    return shape, dtype, crc


def tree_fingerprint(tree: Any) -> tuple:
    """A cheap identity and content mark for a host-homed group tree: per
    leaf ``(id, shape, dtype, crc32 of the first 64 elements)``.  Identity
    catches rebinding (a restart without cache invalidation); the CRC
    catches mutation of the same buffer."""
    from repro_torch.core import tree as tr

    return tuple((id(x), *_leaf_mark(x)) for x in tr.leaves(tree))


class HazardSanitizer:
    """Dynamic counterpart of the static analyzer: records a happens-before
    edge per ticket and asserts, at each engine call, the invariants the
    analyzer proves over the whole program.

    Thread-safe (transfer callbacks land off the compute thread).  Keys are
    caller-provided logical names (group keys, spill chunks, KV pages);
    ``key=None`` transfers are unchecked, exactly the transfers the static
    analyzer cannot name either."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending_wb: dict = {}  # key -> in-flight writeback count
        self._staging_marked: set = set()  # buffer ids currently acquired
        self.checks = 0
        self.hazards = 0

    # -- transfer ordering -------------------------------------------------
    def on_fetch(self, key: Optional[str]) -> None:
        if key is None:
            return
        with self._lock:
            self.checks += 1
            if self._pending_wb.get(key, 0) > 0:
                self.hazards += 1
                raise HazardError(
                    f"sanitizer: H2D fetch of {key!r} while {self._pending_wb[key]} "
                    "D2H writeback(s) of the same group are in flight — "
                    "drain_writebacks() must complete before re-fetching"
                )

    def on_writeback(self, key: Optional[str]) -> None:
        if key is None:
            return
        with self._lock:
            self._pending_wb[key] = self._pending_wb.get(key, 0) + 1

    def on_drained(self, keys: Iterable[Optional[str]]) -> None:
        with self._lock:
            for key in keys:
                if key is None:
                    continue
                n = self._pending_wb.get(key, 0) - 1
                if n > 0:
                    self._pending_wb[key] = n
                else:
                    self._pending_wb.pop(key, None)

    # -- staging pool lifetime --------------------------------------------
    def on_staging_acquire(self, buf_id: int, *, from_pool: bool) -> None:
        with self._lock:
            self.checks += 1
            if from_pool and buf_id in self._staging_marked:
                self.hazards += 1
                raise HazardError(
                    f"sanitizer: staging buffer {buf_id:#x} reacquired from "
                    "the free list while its previous ticket is still in "
                    "flight (released before its copy completed?)"
                )
            self._staging_marked.add(buf_id)

    def on_staging_release(self, buf_id: int) -> None:
        with self._lock:
            if buf_id not in self._staging_marked:
                self.hazards += 1
                raise HazardError(
                    f"sanitizer: staging buffer {buf_id:#x} released twice "
                    "(or released without a matching acquire)"
                )
            self._staging_marked.discard(buf_id)


# --------------------------------------------------------------------------
# CI sweep: every supported config × layout × expert_stream


def _sweep() -> int:
    """Analyze every supported smoke config's train and serve schedules,
    with ``expert_stream`` too for the uniform MoE configs, unbudgeted and at
    a budget of the distance-2 peak.  Returns the count of failures."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.core.weightstream import WeightStreamPlan, weight_stream_support
    from repro_torch.train.steps import abstract_params

    failures = 0
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        support = weight_stream_support(cfg)
        if not support.supported:
            print(f"schedcheck: {arch}: skipped ({support.reason})")
            continue
        variants = [False]
        if support.layout == "uniform" and getattr(cfg, "n_experts", 0):
            variants.append(True)
        params = abstract_params(cfg)
        for expert_stream in variants:
            base = WeightStreamPlan(cfg, params, expert_stream=expert_stream)
            budget_mb = base.peak_device_bytes(2) / 1e6
            for dbm in (None, budget_mb):
                plan = WeightStreamPlan(cfg, params, device_budget_mb=dbm,
                                        expert_stream=expert_stream)
                d = plan.max_distance_for_budget()
                cache_cap = plan.residency_capacity_bytes()
                rep = analyze_train_schedule(plan, distance=d, cache_capacity=cache_cap,
                                             spill=True)
                tag = (f"{arch} expert_stream={int(expert_stream)} "
                       f"budget={'none' if dbm is None else f'{dbm:.2f}MB'}")
                if not rep.ok:
                    failures += 1
                    print(f"schedcheck: FAIL train {tag}\n{rep}")
                else:
                    print(f"schedcheck: ok train {tag} layout={plan.layout} "
                          f"d={d} peak={rep.peak_bytes / 1e6:.2f}MB")
                if support.serve_supported:
                    srep = analyze_serve_schedule(plan, distance=d, cache_capacity=cache_cap)
                    if not srep.ok:
                        failures += 1
                        print(f"schedcheck: FAIL serve {tag}\n{srep}")
                    else:
                        print(f"schedcheck: ok serve {tag} peak={srep.peak_bytes / 1e6:.2f}MB")
    return failures


if __name__ == "__main__":
    raise SystemExit(1 if _sweep() else 0)
