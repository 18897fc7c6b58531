"""Greedy-decode serving on one card: paged KV caches over memory kinds.

The counterpart of the JAX package's ``repro/launch/serve.py``.

``kv_page_len > 0`` (the default, 32) serves through :class:`ServeSession`:
each request's KV cache is split into page groups
(:mod:`repro_torch.core.kvpager`) and only the hot attention window stays on
the card.  Cold pages live at the kind named by ``kv_kind`` (``device`` |
``pinned_host`` | ``disk_host``) and are fetched ahead of the decode step by
the :class:`~repro_torch.core.engine.TransferEngine` — coalesced (one H2D
request per page group), prefetched under a per-request adaptive window,
written back through the pipelined D2H drain when they fall out of the hot
window.  The decode step runs on the assembled page view, the same step as
the unpaged path, so where the cache lives never changes what is decoded.
The session batches continuously: requests are admitted into free slots and
evicted or retired between decode steps, each with its own prompt length
(prefill is per request, at a power-of-two bucket width) and page table.

``kv_page_len=0`` is the unpaged path (:func:`serve_loop`, the JAX
package's ``_serve_unpaged``) with its two schedules.  Pageable (full-attention) caches: one prefill per request, the
caches stacked on the batch axis, and per-slot positions.  Ring and
recurrent caches (recurrentgemma's): one batched prefill and one scalar
position per step (lock-step).  With ``kv_kind="pinned_host"`` the whole
cache round-trips through host memory synchronously every step, the A/B
baseline of the pager.

``param_kind`` (``pinned_host`` | ``disk_host``) homes the *weights* off the
card on both paths: a :class:`~repro_torch.core.weightstream.WeightStreamPlan`
cuts them into groups, and every prefill and decode step streams them group
by group through the transfer engine under ``device_budget_mb`` (shared with
the pager's hot window), keeping what fits in a
:class:`~repro_torch.core.residency.ResidencyCache`.  The schedule is
verified before anything is allocated
(:func:`~repro_torch.core.schedcheck.analyze_serve_schedule`).

Under ``attn_impl="pallas"`` prefill runs the CUDA ``flash_attention``
kernel and decode the CUDA ``decode_attention`` kernel.  Expert streaming
and model parallelism are later slices (ROADMAP.md).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --kv-kind pinned_host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --loadgen --lg-prompt-lens 128,256,512 \\
      --lg-gen-lens 8,16,32 --shared-prefix-len 64 --kv-kind pinned_host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 3072 --gen 32 --kv-page-len 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --kv-page-len 0 --param-kind pinned_host \\
      --device-budget-mb 160
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import memkind as mk
from repro_torch.core import tree as tr
from repro_torch.core.arrays import nbytes
from repro_torch.core import schedcheck as sc
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.kvpager import KVPager, KVPagerConfig, page_template, shared_prefix_keys
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.spillstore import SpillStore
from repro_torch.core.weightstream import PARAM_KINDS, WeightStreamPlan, weight_stream_support
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.train import steps as st

KV_KINDS = ("device", "pinned_host", "disk_host")

_EXPERTS = "expert streaming (ROADMAP.md, queue 1 item 7: the other model families)"


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_weights_on_device(expert_stream: bool) -> None:
    """Refuse routed-expert streaming, which needs the MoE layers."""
    if expert_stream:
        raise NotImplementedError(f"expert_stream=True needs {_EXPERTS}")


def _schedule_note(plan, *, distance, cache_capacity, budget_mb, kv) -> str:
    """The analyzer's occupancy report, appended to a budget error so that a
    refused combination names the program points that overrun."""
    try:
        report = sc.analyze_serve_schedule(
            plan, distance=distance, cache_capacity=cache_capacity,
            budget_bytes=int(budget_mb * 1e6) if budget_mb is not None else None, kv=kv)
        return "\n" + str(report)
    except Exception:
        return ""


def _streamable(cfg, param_kind: str) -> None:
    """Refuse a ``param_kind`` this config cannot stream for serving, with
    the JAX package's messages."""
    if param_kind not in PARAM_KINDS:
        raise ValueError(f"unknown param_kind {param_kind!r}; expected one of {PARAM_KINDS}")
    support = weight_stream_support(cfg)
    if not support.serve_supported:
        raise ValueError(f"--param-kind {param_kind}: {support.serve_reason or support.reason}")


def _page_nbytes(template, page_len: int) -> int:
    """Device bytes of one (slot, page): the hot window's reservation unit."""
    return sum(nbytes(x) for x in tr.leaves(page_template(template, page_len)))


def _param_prefetch(plan: WeightStreamPlan, param_distance) -> PrefetchSpec:
    return PrefetchSpec(buffer_size=plan.n_groups + 2,
                        distance=param_distance if param_distance == AUTO else int(param_distance))


def _weight_home(plan: WeightStreamPlan, params, param_kind: str, spill_dir: Optional[str]):
    """``(home, store)``: the plan's home of ``params`` (a
    :class:`ParamTree`, or already a plan home ``{"groups": ...}``) on the
    host, and for ``disk_host`` spilled into a store under ``spill_dir`` or a
    temporary directory (deleted on close).  The caller closes the store."""
    home = params if isinstance(params, dict) and "groups" in params else plan.init_home(params)
    if param_kind != "disk_host":
        return home, None
    pd = spill_dir if spill_dir is not None else tempfile.mkdtemp(prefix="repro-torch-serve-wp-")
    store = SpillStore(pd, ephemeral=True)
    try:
        return plan.spill_home(home, store), store
    except BaseException:
        # no-leak contract: a failed spill (a full disk) leaves no directory
        store.close()
        raise


@functools.lru_cache(maxsize=None)
def lock_step(cfg) -> bool:
    """True iff ``cfg`` serves in lock-step: its caches hold a ring
    (``slot_pos`` shared across the batch) or recurrent states, so requests
    cannot be prefilled one at a time or decoded at per-slot positions."""
    return not st.paged_cache_supported(st.abstract_caches(cfg, 1, 1))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[..., -1, :].argmax(dim=-1).to(torch.int32)


def prefill_all(cfg, params: ParamTree, prompts: torch.Tensor, max_len: int,
                make_prefill=None) -> tuple[torch.Tensor, dict]:
    """Prefill every row of ``prompts`` ((B, S) token ids on the device) into
    caches of ``max_len`` positions.  Returns each request's first greedy
    token ((B,) int32) and the caches.  Pageable caches prefill one request
    at a time and stack on the batch axis; in :func:`lock_step` all rows
    prefill in one batch.  ``make_prefill(batch_size)`` builds the prefill
    step (default :func:`~repro_torch.train.steps.make_prefill_step`; the
    streamed-weight step takes the plan's home as ``params``)."""
    make_prefill = make_prefill or (lambda b: st.make_prefill_step(cfg, b, max_len))
    if lock_step(cfg):
        logits, caches = make_prefill(prompts.shape[0])(params, {"tokens": prompts})
        return _greedy(logits), caches
    prefill_fn = make_prefill(1)
    first, slot_caches = [], []
    for b in range(prompts.shape[0]):
        logits, cache = prefill_fn(params, {"tokens": prompts[b:b + 1]})
        first.append(_greedy(logits))
        slot_caches.append(cache)
    # (L, B, T, K, H): requests stack on the batch axis
    return torch.cat(first), {k: torch.cat([c[k] for c in slot_caches], dim=1) for k in slot_caches[0]}


def step_pos(cfg, batch: int, pos: int, device) -> torch.Tensor:
    """The decode step's position ``pos``: one per slot ((B,) int32), or one
    scalar in :func:`lock_step`."""
    return torch.full(() if lock_step(cfg) else (batch,), pos, dtype=torch.int32, device=device)


def _step_batch(tokens, device) -> dict:
    """Per-slot next tokens ((B,) ints, on the host or the device) as a
    one-token decode batch."""
    return {"tokens": torch.as_tensor(tokens, device=device).to(torch.long).reshape(-1, 1)}


# ---------------------------------------------------------------------------
# the paged session
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request: prompt in, ``gen`` greedy tokens out."""

    rid: int
    prompt: np.ndarray  # (s,) int32
    gen: int
    #: last sampled token, the next decode step's input
    next_token: Optional[np.ndarray] = None
    emitted: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.gen


class ServeSession:
    """Continuous-batching decode loop over a paged hierarchical KV cache.

    ``slots`` batch lanes decode in lock-step (one step, per-slot positions);
    requests flow through them: ``submit`` queues work, admissions fill free
    slots between steps (per-request prefill — no cross-request prompt
    padding), finished requests retire and their slot is reused at once.
    ``evict``/``readmit`` park a request's pages at the host mid-decode and
    resume it later, bitwise-identically, because pages are rebuilt exactly.

    ``params`` serves the given parameters (the tests pass the JAX
    package's, converted); without it they are initialised from ``seed``.
    Runs on the card unless ``device="cpu"``.

    ``param_kind="pinned_host"`` or ``"disk_host"`` homes the weights off
    the card (the plan's home of ``params``; a plan home may be passed as
    ``params`` too) and streams them group by group for every prefill and
    decode step.  ``device_budget_mb`` is shared: the pager's hot window
    takes its cut first, the weight window and the residency cache
    (``param_cache_mb``, default the slack above the window) share the
    rest.  Everything is planned and the schedule verified
    (``schedule_report``) before any engine thread or spill directory
    exists, so a refused combination leaks nothing.  ``expert_stream``
    raises ``NotImplementedError`` (ROADMAP.md, queue 1 item 7).
    """

    def __init__(
        self,
        cfg,
        *,
        slots: int,
        max_len: int,
        kv_kind: str = "device",
        page_len: int = 32,
        hot_pages: int = 1,
        distance=AUTO,
        seed: int = 0,
        engine: Optional[TransferEngine] = None,
        spill_dir: Optional[str] = None,
        param_kind: str = "device",
        device_budget_mb: Optional[float] = None,
        param_layers_per_group: Optional[int] = None,
        param_distance=AUTO,
        param_cache_mb: Optional[float] = None,
        expert_stream: bool = False,
        prefix_sharing: bool = True,
        params: Optional[ParamTree] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.slots = slots
        self.stats = StreamStats(mode="paged")
        #: transfer accounting of the *weight* stream (apart from the KV
        #: page stream, so each tier's request model stays checkable)
        self.param_stats = StreamStats()
        self._kind = mk.as_kind(kv_kind)
        # validate — and do every fallible init — before the engine thread
        # and the spill dirs exist: a failed constructor must not leak them
        _check_weights_on_device(expert_stream)
        pager_cfg = KVPagerConfig(page_len=page_len, hot_pages=hot_pages, kind=self._kind,
                                  distance=distance)
        self.max_len = _round_up(max_len, page_len)
        template = st.abstract_caches(cfg, 1, self.max_len)
        if not st.paged_cache_supported(template):
            raise ValueError(
                f"{cfg.name}: cache tree is not pageable (ring/recurrent "
                "state) — use the unpaged serve path (kv_page_len=0)"
            )
        self.device = resolve_device(device)
        if engine is not None and engine.device != self.device:
            raise ValueError(f"the engine moves data to {engine.device}, the session runs on "
                             f"{self.device}")
        #: the weight plan (None for device-resident weights)
        self._wplan: Optional[WeightStreamPlan] = None
        engine_cfg = None
        #: routed-expert accounting: no expert streaming without the MoE layers
        self.expert_stats: Optional[StreamStats] = None
        #: weight-residency cache: fetched weight groups stay on the card
        #: across steps (serve weights never change: only LRU eviction)
        self.param_residency: Optional[ResidencyCache] = None
        #: the analyzer's report of the weight + KV page schedule
        self.schedule_report: Optional[sc.ScheduleReport] = None
        if param_kind != "device":
            _streamable(cfg, param_kind)
            budget = device_budget_mb
            page_nbytes = _page_nbytes(template, page_len)
            kv_desc = dict(slots=slots, page_len=page_len, hot_pages=hot_pages,
                           page_nbytes=page_nbytes, max_len=self.max_len)
            if budget is not None:
                # the budget is shared: the hot window (the current page,
                # hot_pages full pages and the zero page, per slot) takes its
                # cut first, the weights stream under the rest
                hot_mb = slots * (hot_pages + 2) * page_nbytes / 1e6
                budget = budget - hot_mb
                if budget <= 0:
                    probe = WeightStreamPlan(cfg, st.abstract_params(cfg),
                                             layers_per_group=param_layers_per_group)
                    raise ValueError(
                        f"device_budget_mb={device_budget_mb} is consumed by "
                        f"the KV hot window ({hot_mb:.1f} MB); raise the budget "
                        "or shrink hot_pages/page_len"
                        + _schedule_note(probe, distance=1, cache_capacity=0,
                                         budget_mb=device_budget_mb, kv=kv_desc))
            self._wplan = WeightStreamPlan(cfg, st.abstract_params(cfg),
                                           layers_per_group=param_layers_per_group,
                                           device_budget_mb=budget)
            # the cache's capacity: by default the budget slack above the
            # widest prefetch window (unbounded without a budget); an
            # explicit param_cache_mb reserves that many bytes instead,
            # narrowing the window, which must still fit at distance 1
            if param_cache_mb is None:
                cache_cap = self._wplan.residency_capacity_bytes()
            else:
                cache_cap = int(param_cache_mb * 1e6)
                floor = self._wplan.peak_device_bytes(1, cached_bytes=cache_cap)
                if budget is not None and floor > budget * 1e6:
                    hot_mb = (device_budget_mb or 0) - budget
                    raise ValueError(
                        f"device_budget_mb={device_budget_mb} cannot hold the "
                        f"KV hot window ({hot_mb:.1f} MB) + the distance-1 "
                        f"weight stream floor "
                        f"({self._wplan.peak_device_bytes(1) / 1e6:.1f} MB) + "
                        f"param_cache_mb={param_cache_mb}; raise the budget, "
                        "shrink hot_pages/page_len/param_layers_per_group, or "
                        "lower param_cache_mb"
                        + _schedule_note(self._wplan, distance=1, cache_capacity=cache_cap,
                                         budget_mb=device_budget_mb, kv=kv_desc))
            cache_reserved = (cache_cap or 0) if budget is not None else 0
            window_cap = self._wplan.max_distance_for_budget(cached_bytes=cache_reserved)
            self.param_residency = ResidencyCache(cache_cap)
            engine_cfg = EngineConfig(max_distance=window_cap)
            if engine is not None and budget is not None and engine.config.max_distance > window_cap:
                # an external engine must keep the budget's window cap, or the
                # adaptive controller could stream past the budget
                raise ValueError(
                    f"external engine's max_distance={engine.config.max_distance} exceeds "
                    f"the device budget's cap {window_cap} (window + residency cache share "
                    "the budget); pass an engine configured from the plan (or no engine)")
            # the static check: replay the fetch program the session is about
            # to run (prefill walk, decode, KV page demote/readmit) and refuse
            # an occupancy overrun or a transfer hazard
            self.schedule_report = sc.analyze_serve_schedule(
                self._wplan,
                distance=engine.config.max_distance if engine is not None else window_cap,
                cache_capacity=cache_cap,
                budget_bytes=int(device_budget_mb * 1e6) if device_budget_mb is not None else None,
                kv=kv_desc)
            sc.verify_schedule(self.schedule_report)
        self._param_store = None
        if self._wplan is not None:
            # the home is built (group by group: the whole model is never on
            # the card) and spilled before the engine thread exists
            if params is None:
                params = st.init_weight_streamed_params(cfg, self._wplan, seed, self.device)
            self.params, self._param_store = _weight_home(
                self._wplan, params, param_kind,
                str(Path(spill_dir) / "params")
                if spill_dir is not None and self._kind == mk.DISK_HOST else None)
            del params
        else:
            self.params = params if params is not None else st.init_params(cfg, seed, self.device)

        self._engine = engine or TransferEngine(engine_cfg, device=self.device)
        self._owns_engine = engine is None
        self._store = None
        try:
            if self._kind == mk.DISK_HOST:
                ephemeral = spill_dir is None
                if ephemeral:
                    spill_dir = tempfile.mkdtemp(prefix="repro-torch-serve-kv-")
                self._store = SpillStore(spill_dir, ephemeral=ephemeral)
            self.pager = KVPager(template, pager_cfg, slots=slots, engine=self._engine,
                                 store=self._store)
            if self._wplan is not None:
                # the decode step consumes the landed groups by reference:
                # where the weights live never changes the tokens
                param_pf = _param_prefetch(self._wplan, param_distance)
                kw = dict(engine=self._engine, stats=self.param_stats, prefetch=param_pf,
                          residency=self.param_residency)
                self._prefill = st.make_weight_streamed_prefill_step(
                    cfg, self._wplan, 1, self.max_len, **kw)
                self._step = st.make_weight_streamed_decode_step(cfg, self._wplan, paged=True,
                                                                 **kw)
            else:
                self._prefill = st.make_prefill_step(cfg, 1, self.max_len)
                self._step = st.make_paged_decode_step(cfg)
        except BaseException:
            # the no-leak contract: anything that fails after the engine
            # thread / spill dir exist tears them down
            self.close()
            raise

        self.requests: dict[int, Request] = {}
        self.queue: "deque[int]" = deque()
        self._slot_of: dict[int, int] = {}  # rid -> slot
        self._next_rid = 0
        self.n_steps = 0
        #: COW prefix sharing (no-op for device-resident caches — nothing is
        #: ever cold)
        self._prefix_sharing = prefix_sharing and self._kind != mk.DEVICE
        #: requests rejected at submit (prompt + gen > max_len)
        self.rejected = 0
        #: readmits that found the batch full, drained (ahead of new
        #: admissions) by the next admission cycle
        self._readmit_queue: "deque[int]" = deque()
        #: per-step compute-blocked transfer wait (steady-state metric)
        self.step_waits: list = []
        #: distinct prompt widths prefilled (each is one executable in the
        #: JAX package; the port compiles nothing)
        self._prefill_widths: set = set()
        #: weight groups fetched over the link a step (not resident
        #: pass-throughs): 0 at steady state with cache slack, n_groups with
        #: no cache
        self.param_step_fetches: list = []

    # -- request lifecycle ---------------------------------------------------
    def submit(self, prompt, gen: int) -> Optional[int]:
        """Queue a request; returns its id.  A request that cannot fit
        (``prompt + gen > max_len``) is rejected gracefully: ``None`` is
        returned and ``self.rejected`` counts it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + gen > self.max_len:
            self.rejected += 1
            return None
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid=rid, prompt=prompt, gen=gen)
        self.queue.append(rid)
        return rid

    def _bucket_len(self, s: int) -> int:
        """Power-of-two prompt-length bucket (min 8, capped at ``max_len``).
        Bucketing is bitwise-invisible: the pad tail's K/V lands beyond the
        write position (masked by every decode step until overwritten, or
        dropped with the zero pages) and the head reads the last *real*
        position via ``last_pos``."""
        b = 8
        while b < s:
            b *= 2
        return min(b, self.max_len)

    def _prefix_keys(self, req: Request) -> Optional[list]:
        if not self._prefix_sharing:
            return None
        return shared_prefix_keys(req.prompt, self.pager.config.page_len)

    def _free_slots(self) -> list:
        return [s for s in range(self.slots) if s not in self.pager._by_slot]

    def admit_pending(self) -> dict:
        """Prefill queued requests into free slots.  Returns ``{rid:
        first_token}`` (emitted at admission, before any decode step)."""
        emitted = {}
        for slot in self._free_slots():
            # queued readmits resume first: they were promised a slot
            if self._readmit_queue:
                rid = self._readmit_queue.popleft()
                self.pager.readmit(rid, slot)
                self._slot_of[rid] = slot
                continue
            if not self.queue:
                break
            rid = self.queue.popleft()
            req = self.requests[rid]
            s = len(req.prompt)
            width = self._bucket_len(s)
            padded = np.zeros((width,), np.int32)
            padded[:s] = req.prompt
            self._prefill_widths.add(width)
            tokens = torch.as_tensor(padded[None, :], device=self.device).to(torch.long)
            logits, cache = self._prefill(self.params, {"tokens": tokens}, s - 1)
            tok = _greedy(logits).cpu().numpy()[0]
            req.next_token = tok
            req.emitted.append(int(tok))
            emitted[rid] = req.emitted[-1]
            self._slot_of[rid] = slot
            self.pager.admit(rid, slot, cache, s, prefix_keys=self._prefix_keys(req))
            del cache  # the pager cloned its pages; the prefill buffer is free
            if req.done:  # gen == 1: nothing left to decode
                self._retire(rid)
        self.pager.flush_demotions(self.stats)
        self.pager.prefetch()
        return emitted

    def _retire(self, rid: int) -> None:
        self._slot_of.pop(rid, None)
        self.pager.retire(rid, self.stats)

    def evict(self, rid: int) -> None:
        """Park a mid-decode request at the host and free its slot."""
        self.pager.evict(rid, self.stats)
        self._slot_of.pop(rid, None)

    def readmit(self, rid: int) -> bool:
        """Resume an evicted request in a free slot (pages stream back in
        cold).  When the batch is full the readmit is QUEUED for the next
        admission cycle, ahead of new submissions; returns True when a slot
        was taken now, False when queued."""
        table = self.pager.tables.get(rid)
        if table is None:
            raise KeyError(f"unknown request {rid}")
        if table.slot is not None:
            raise ValueError(f"request {rid} is not evicted")
        if rid in self._readmit_queue:
            return False
        free = self._free_slots()
        if not free:
            self._readmit_queue.append(rid)
            return False
        slot = free[0]
        self.pager.readmit(rid, slot)
        self._slot_of[rid] = slot
        return True

    @property
    def active(self) -> dict:
        """rid -> slot of requests currently decoding."""
        return dict(self._slot_of)

    def pending_work(self) -> bool:
        return bool(self.queue or self._slot_of or self._readmit_queue)

    def prefill_compiles(self) -> Optional[int]:
        """Distinct bucket widths prefilled: the number of prefill
        executables the JAX package compiles for the same requests; ``None``
        for the streamed-weight prefill, as there (a composite, not one
        executable)."""
        return None if self._wplan is not None else len(self._prefill_widths)

    # -- the decode loop -----------------------------------------------------
    def warmup(self) -> None:
        """Run one decode step on a throwaway all-zero view (no table or
        stream state is touched), so that the first timed step does not pay
        first-call costs such as the kernels' build and load."""
        view = tuple((self.pager._zero_page,) * self.pager.n_pages for _ in range(self.slots))
        tokens = np.zeros((self.slots,), np.int32)
        pos = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        logits, nc = self._step(self.params, view, _step_batch(tokens, self.device), pos)
        _greedy(logits)
        self.pager._page_of(nc, 0, 0)
        _sync(self.device)

    def step(self) -> dict:
        """One decode step over every active slot.  Returns ``{rid: token}``
        for tokens emitted this step (including first tokens of requests
        admitted at the end of the step)."""
        if not self._slot_of and (self.queue or self._readmit_queue):
            return self.admit_pending()
        wait0 = self.stats.transfer_wait_s
        fetch0 = self.param_stats.unique_group_fetches

        tokens = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        by_slot = {}
        for rid, slot in self._slot_of.items():
            req = self.requests[rid]
            tokens[slot] = req.next_token
            pos[slot] = self.pager.tables[rid].pos
            by_slot[slot] = req

        # pop this step's cold pages (waits only where the window fell
        # short), then speculatively prefetch the same cold set for the next
        # step — those transfers overlap the decode compute below
        view = self.pager.view(self.stats)
        self.pager.prefetch()
        logits, new_cache = self._step(self.params, view, _step_batch(tokens, self.device),
                                       torch.as_tensor(pos, device=self.device))
        nxt = _greedy(logits).cpu().numpy()  # the step's one host sync
        self.pager.update_current(new_cache)
        del view, new_cache

        emitted = {}
        for slot, req in by_slot.items():
            req.next_token = nxt[slot]
            req.emitted.append(int(nxt[slot]))
            emitted[req.rid] = req.emitted[-1]
            table = self.pager.tables[req.rid]
            table.pos += 1
            self.pager.advance(table)
        self.pager.flush_demotions(self.stats)
        for req in list(by_slot.values()):
            if req.done:
                self._retire(req.rid)
        self.n_steps += 1
        self.step_waits.append(self.stats.transfer_wait_s - wait0)
        self.param_step_fetches.append(self.param_stats.unique_group_fetches - fetch0)
        emitted.update(self.admit_pending())
        return emitted

    def run(self) -> dict:
        """Drive steps until every submitted request has finished.  Returns
        ``{rid: np.ndarray of emitted tokens}``."""
        self.admit_pending()
        while self.pending_work():
            self.step()
        return {rid: np.asarray(req.emitted, np.int32) for rid, req in self.requests.items()}

    def close(self) -> None:
        if self._owns_engine:
            self._engine.close()
        if self._store is not None:
            self._store.close()
        if self._param_store is not None:
            self._param_store.close()
        if self.param_residency is not None:
            self.param_residency.clear()  # drop the resident device copies

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the unpaged path (per-step whole-cache placement)
# ---------------------------------------------------------------------------


def serve_loop(
    cfg,
    params: Optional[ParamTree],
    prompts: np.ndarray,
    gen: int,
    *,
    device: torch.device,
    seed: int = 0,
    warmup: bool = True,
    kv_kind: str = "device",
    engine: Optional[TransferEngine] = None,
    param_kind: str = "device",
    device_budget_mb: Optional[float] = None,
    param_layers_per_group: Optional[int] = None,
    param_distance=AUTO,
    param_cache_mb: Optional[float] = None,
    expert_stream: bool = False,
    spill_dir: Optional[str] = None,
) -> dict:
    """Serve one greedy request per row of ``prompts`` ((B, S) int32) for
    ``gen`` tokens with ``params`` on ``device``, on the unpaged path.

    The first token of each request comes from its prefill
    (:func:`prefill_all`); ``gen - 1`` decode steps follow.  With
    ``kv_kind="pinned_host"`` the whole cache round-trips through host
    memory synchronously before every step (the JAX package's pre-pager
    schedule; the caller's ``engine`` only adds its emulated link's time).
    Tokens stay on the device until the loop ends.  ``params=None`` draws
    random weights from ``seed``.

    ``param_kind="pinned_host"`` or ``"disk_host"`` (the JAX package's
    streamed branch of ``_serve_unpaged``) homes ``params`` (a
    :class:`ParamTree`, or a plan home) off the card, spilled for
    ``disk_host`` under ``spill_dir/params`` or a temporary directory, and
    streams the weights group by group through ``engine`` (default: one
    capped at the budget's window) for every prefill and decode step.  The
    schedule is verified first.  ``param_stats`` holds the weight stream's
    counters and ``param_residency`` its cache's.
    """
    kind = mk.as_kind(kv_kind)
    if kind == mk.DISK_HOST:
        raise ValueError("the unpaged path has no disk home; use --kv-page-len > 0")
    _check_weights_on_device(expert_stream)
    device_resident = kind == mk.DEVICE
    stats = StreamStats()
    param_stats = StreamStats()
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen
    # decided before the clock starts: the first call builds a cache tree on
    # the meta device, a one-time cost of the process that is not prefill
    lock_step(cfg)
    #: KV round-trip emulation stays on the caller's engine: an engine made
    #: here for the weights must not add emulated stalls to the cache path
    kv_engine = engine
    wplan = residency = param_store = own_engine = None
    if param_kind != "device":
        _streamable(cfg, param_kind)
        wplan = WeightStreamPlan(cfg, st.abstract_params(cfg),
                                 layers_per_group=param_layers_per_group,
                                 device_budget_mb=device_budget_mb)
        cache_cap = (wplan.residency_capacity_bytes() if param_cache_mb is None
                     else int(param_cache_mb * 1e6))
        if engine is None:  # its threads start at the first transfer
            engine = own_engine = TransferEngine(
                EngineConfig(max_distance=wplan.max_distance_for_budget()), device=device)
        sc.verify_schedule(sc.analyze_serve_schedule(
            wplan, distance=engine.config.max_distance, cache_capacity=cache_cap))
        if params is None:  # group by group: the whole model is never on the card
            params = st.init_weight_streamed_params(cfg, wplan, seed, device)
        params, param_store = _weight_home(
            wplan, params, param_kind,
            str(Path(spill_dir) / "params") if spill_dir is not None else None)
        residency = ResidencyCache(cache_cap)
        param_pf = _param_prefetch(wplan, param_distance)
        kw = dict(engine=engine, stats=param_stats, prefetch=param_pf, residency=residency)
        decode_fn = st.make_weight_streamed_decode_step(cfg, wplan, paged=False, **kw)

        def make_prefill(b):
            return st.make_weight_streamed_prefill_step(cfg, wplan, b, max_len, **kw)
    else:
        if params is None:
            params = st.init_params(cfg, seed, device)
        decode_fn = st.make_decode_step(cfg)
        make_prefill = None
    prompts_t = torch.tensor(np.asarray(prompts), dtype=torch.long, device=device)
    try:
        return _decode_loop(cfg, params, prompts_t, gen, device=device, warmup=warmup,
                            device_resident=device_resident, kind=kind, kv_engine=kv_engine,
                            stats=stats, decode_fn=decode_fn, make_prefill=make_prefill,
                            param_stats=param_stats, wplan=wplan, residency=residency)
    finally:
        if own_engine is not None:
            own_engine.close()
        if param_store is not None:
            param_store.close()
        if residency is not None:
            residency.clear()


def _decode_loop(cfg, params, prompts_t: torch.Tensor, gen: int, *, device, warmup: bool,
                 device_resident: bool, kind, kv_engine, stats: StreamStats, decode_fn,
                 make_prefill, param_stats: StreamStats, wplan, residency) -> dict:
    """:func:`serve_loop`'s prefill and decode steps, timed."""
    batch, prompt_len = prompts_t.shape
    t0 = time.perf_counter()
    tokens, caches = prefill_all(cfg, params, prompts_t, prompt_len + gen, make_prefill)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    cache_leaves = tr.leaves(caches)
    n_leaves, cache_bytes = len(cache_leaves), sum(nbytes(x) for x in cache_leaves)

    def round_trip(c):
        t0 = time.perf_counter()
        c = mk.place(c, kind, device)
        _sync(device)
        if kv_engine is not None:
            kv_engine.emulate_blocking_transfer(n_leaves, cache_bytes)
        c = mk.place(c, mk.DEVICE, device)
        _sync(device)
        if kv_engine is not None:
            kv_engine.emulate_blocking_transfer(n_leaves, cache_bytes)
        w = time.perf_counter() - t0
        stats.n_transfers += 2
        stats.n_groups += 1
        stats.h2d_requests += n_leaves
        stats.d2h_requests += n_leaves
        stats.bytes_h2d += cache_bytes
        stats.bytes_d2h += cache_bytes
        stats.transfer_wait_s += w
        stats.wait_per_group.append(w)
        return c

    if warmup:
        # one step on a throwaway copy (the step updates caches in place), so
        # the timed loop does not include first-call costs such as the kernels'
        # build and load
        caches_w = st.clone_caches(caches)
        decode_fn(params, caches_w, _step_batch(tokens, device), step_pos(cfg, batch, prompt_len, device))
        del caches_w
        _sync(device)

    out_tokens = [tokens]
    step_waits = []
    step_fetches = []  # weight groups fetched over the link a decode step
    t0 = time.perf_counter()
    for i in range(gen - 1):
        w0 = stats.transfer_wait_s
        fetch0 = param_stats.unique_group_fetches
        if not device_resident:
            # the paper's Host kind, pre-pager: the ENTIRE cache round-trips
            # through host memory synchronously every step
            caches = round_trip(caches)
        pos = step_pos(cfg, batch, prompt_len + i, device)
        logits, caches = decode_fn(params, caches, _step_batch(tokens, device), pos)
        tokens = _greedy(logits)
        out_tokens.append(tokens)
        step_waits.append(stats.transfer_wait_s - w0)
        step_fetches.append(param_stats.unique_group_fetches - fetch0)
    _sync(device)
    t_decode = time.perf_counter() - t0

    generated = torch.stack(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        # gen-1 decode steps: the first token per slot comes from prefill
        "tokens_per_s": batch * (gen - 1) / t_decode if t_decode else float("inf"),
        "generated": generated,
        "step_waits": step_waits,
        "stats": stats,
        "paged": False,
        "n_steps": gen - 1,
        "param_stats": param_stats,
        "expert_stats": None,
        "param_plan": wplan,
        "param_step_fetches": step_fetches,
        "param_residency": residency.counters() if residency is not None else None,
        "expert_decode_bytes": 0,
        "expert_decode_fetches": 0,
    }


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def serve(
    cfg,
    *,
    batch: int,
    prompt_len: int,
    gen: int,
    kv_kind: str = "device",
    kv_page_len: int = 32,
    hot_pages: int = 1,
    distance=AUTO,
    seed: int = 0,
    n_requests: Optional[int] = None,
    engine: Optional[TransferEngine] = None,
    spill_dir: Optional[str] = None,
    warmup: bool = True,
    param_kind: str = "device",
    device_budget_mb: Optional[float] = None,
    param_layers_per_group: Optional[int] = None,
    param_distance=AUTO,
    param_cache_mb: Optional[float] = None,
    expert_stream: bool = False,
    prefix_sharing: bool = True,
    shared_prefix_len: int = 0,
    params: Optional[ParamTree] = None,
    device: DeviceLike = None,
) -> dict:
    """Serve ``n_requests`` greedy requests (default: one per batch slot) of
    ``prompt_len`` random prompt tokens and ``gen`` generated tokens, with
    ``params`` or random weights from ``seed``.

    ``kv_page_len > 0`` decodes through the paged :class:`ServeSession`;
    ``kv_page_len=0`` runs the unpaged schedule (:func:`serve_loop`).
    ``shared_prefix_len`` makes the first that many prompt tokens identical
    across requests; ``prefix_sharing`` lets the pager alias those pages
    copy-on-write.  ``param_kind`` homes the weights off the card and
    streams them group by group on either path (see :class:`ServeSession`
    and :func:`serve_loop`).  The defaults are the JAX package's, and so are
    the returned keys (``param_stats`` and the others of the weight
    stream; ``expert_stats`` is ``None``).  Prompts come from
    ``np.random.default_rng(seed + 1)`` on both paths, so a paged and an
    unpaged run serve the same prompts.  Runs on the card unless
    ``device="cpu"`` is passed.
    """
    device = resolve_device(device)
    _check_weights_on_device(expert_stream)
    weights = dict(param_kind=param_kind, device_budget_mb=device_budget_mb,
                   param_layers_per_group=param_layers_per_group, param_distance=param_distance,
                   param_cache_mb=param_cache_mb)
    n_requests = n_requests or batch
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(1, cfg.vocab_size, (n_requests, prompt_len), dtype=np.int32)
    if kv_page_len <= 0:
        if n_requests != batch:
            raise ValueError("the unpaged path serves exactly one request per slot")
        return serve_loop(cfg, params, prompts, gen, device=device, seed=seed, warmup=warmup,
                          kv_kind=kv_kind, engine=engine, spill_dir=spill_dir, **weights)

    if shared_prefix_len:
        shared = min(shared_prefix_len, prompt_len)
        prompts[:, :shared] = prompts[0, :shared]
    with ServeSession(
        cfg,
        slots=batch,
        max_len=prompt_len + gen,
        kv_kind=kv_kind,
        page_len=kv_page_len,
        hot_pages=hot_pages,
        distance=distance,
        seed=seed,
        engine=engine,
        spill_dir=spill_dir,
        prefix_sharing=prefix_sharing,
        params=params,
        device=device,
        **weights,
    ) as session:
        rids = [session.submit(prompts[i], gen) for i in range(n_requests)]
        if warmup:
            session.warmup()
        t0 = time.perf_counter()
        admitted_first = session.admit_pending()
        _sync(device)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        while session.pending_work():
            session.step()
        _sync(device)
        t_decode = time.perf_counter() - t0
        stats = session.stats
        generated = np.stack([np.asarray(session.requests[r].emitted, np.int32) for r in rids])
        total_tokens = int(sum(len(session.requests[r].emitted) for r in rids))
        # first tokens of the initial admissions were emitted during the
        # prefill window, not the decode window
        decode_tokens = total_tokens - len(admitted_first)
        return {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": decode_tokens / t_decode if t_decode else float("inf"),
            "generated": generated,
            "step_waits": list(session.step_waits),
            "stats": stats,
            "paged": True,
            "n_steps": session.n_steps,
            "stale_drops": session.pager.stream.stale_drops,
            "rejected": session.rejected,
            "prefill_compiles": session.prefill_compiles(),
            "shared_hits": stats.shared_hits,
            "shared_skipped_writebacks": session.pager.shared_skipped_writebacks,
            "demoted_groups": session.pager.demoted_groups,
            "peak_resident_bytes": session.pager.peak_resident_bytes,
            "total_cache_bytes": session.pager.total_cache_bytes(),
            "param_stats": session.param_stats,
            "expert_stats": session.expert_stats,
            "param_plan": session._wplan,
            "param_step_fetches": list(session.param_step_fetches),
            "param_residency": (session.param_residency.counters()
                                if session.param_residency is not None else None),
        }


#: flags of the JAX entry point that this port does not serve yet, and where
#: their port is queued; any value but the default exits
_NOT_PORTED = {
    "expert_stream": _EXPERTS,
    "model_parallel": "model parallelism (ROADMAP.md, queue 1 item 5: multi-device and tooling)",
}


def _verify_schedule(args, cfg) -> None:
    """``--verify-schedule``: analyze the streamed-weight (+ KV page)
    schedule the flags describe, print the report, and raise
    :class:`~repro_torch.core.schedcheck.ScheduleError` on a violation."""
    budget = args.device_budget_mb
    kv_desc = None
    if args.kv_page_len > 0:
        max_len = _round_up(args.prompt_len + args.gen, args.kv_page_len)
        template = st.abstract_caches(cfg, 1, max_len)
        if st.paged_cache_supported(template):
            page_nbytes = _page_nbytes(template, args.kv_page_len)
            kv_desc = dict(slots=args.batch, page_len=args.kv_page_len,
                           hot_pages=args.hot_pages, page_nbytes=page_nbytes, max_len=max_len)
            if budget is not None:
                budget -= args.batch * (args.hot_pages + 2) * page_nbytes / 1e6
    wplan = WeightStreamPlan(cfg, st.abstract_params(cfg), device_budget_mb=budget)
    if args.param_cache_mb is not None:
        cache_cap = int(args.param_cache_mb * 1e6)
    else:
        cache_cap = wplan.residency_capacity_bytes()
    cache_reserved = (cache_cap or 0) if budget is not None else 0
    report = sc.analyze_serve_schedule(
        wplan, distance=wplan.max_distance_for_budget(cached_bytes=cache_reserved),
        cache_capacity=cache_cap,
        budget_bytes=int(args.device_budget_mb * 1e6) if args.device_budget_mb is not None else None,
        kv=kv_desc)
    print(report)
    sc.verify_schedule(report)


def _loadgen(args, cfg, distance) -> int:
    """``--loadgen``: an open-loop Poisson trace through the SLO scheduler."""
    from repro_torch.serve import SLO, LoadGenConfig, Phase, SLOScheduler, generate

    phases = tuple(Phase(duration_s=float(d), rate_rps=float(r))
                   for d, r in (p.split(":") for p in args.lg_phases.split(",")))
    prompt_lens = tuple(int(x) for x in args.lg_prompt_lens.split(","))
    gen_lens = tuple(int(x) for x in args.lg_gen_lens.split(","))
    lg_cfg = LoadGenConfig(
        seed=args.lg_seed,
        phases=phases,
        prompt_lens=prompt_lens,
        prompt_mix=(1.0,) * len(prompt_lens),
        gen_lens=gen_lens,
        gen_mix=(1.0,) * len(gen_lens),
        shared_prefix_len=args.shared_prefix_len,
        shared_frac=args.lg_shared_frac,
        vocab_size=cfg.vocab_size,
    )
    offered = generate(lg_cfg)
    with ServeSession(
        cfg,
        slots=args.batch,
        max_len=args.prompt_len + args.gen,
        kv_kind=args.kv_kind,
        page_len=args.kv_page_len,
        hot_pages=args.hot_pages,
        distance=distance,
        seed=args.seed,
        spill_dir=args.spill_dir,
        param_kind=args.param_kind,
        device_budget_mb=args.device_budget_mb,
        param_cache_mb=args.param_cache_mb,
        prefix_sharing=not args.no_prefix_sharing,
        device=args.device,
    ) as session:
        sched = SLOScheduler(
            session,
            offered,
            slo=SLO(ttft_s=args.slo_ttft_ms / 1e3, tpot_s=args.slo_tpot_ms / 1e3),
            max_queue=args.max_queue,
            virtual_step_s=args.virtual_step_ms / 1e3 if args.virtual_step_ms > 0 else None,
        )
        rep = sched.run()
    print(
        f"loadgen {args.arch}: offered {rep['offered']}, completed "
        f"{rep['completed']} ({rep['rejected_oversize']} oversize, "
        f"{rep['rejected_overload']} overload) over "
        f"{rep['makespan_s']:.2f} s"
    )
    print(
        f"SLO: attainment {rep['slo_attainment']*100:.1f}%, goodput "
        f"{rep['goodput_rps']:.2f} req/s / "
        f"{rep['goodput_tokens_per_s']:.1f} tok/s under SLO, TTFT p50 "
        f"{rep['ttft_s']['p50']*1e3:.1f} ms p99 "
        f"{rep['ttft_s']['p99']*1e3:.1f} ms, TPOT p50 "
        f"{rep['tpot_s']['p50']*1e3:.1f} ms"
    )
    print(
        f"sharing: {rep['shared_hits']} shared-page fetch hits, "
        f"{rep['shared_skipped_writebacks']} skipped writebacks, "
        f"{rep['unique_group_fetches']} unique fetches, "
        f"{rep['disk_requests']} disk req, prefill compiles "
        f"{rep['prefill_compiles']}"
    )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to serve (default: one per slot)")
    ap.add_argument("--kv-kind", default="device", choices=KV_KINDS)
    ap.add_argument("--kv-page-len", type=int, default=32,
                    help="tokens per KV page (0 = the unpaged path)")
    ap.add_argument("--hot-pages", type=int, default=1,
                    help="full pages kept device-resident behind the write head")
    ap.add_argument("--distance", default="auto", help="page prefetch window: an int or 'auto'")
    ap.add_argument("--spill-dir", default=None,
                    help="disk_host page store directory (default: ephemeral)")
    ap.add_argument("--param-kind", default="device", choices=PARAM_KINDS,
                    help="home tier of the weights (host/disk kinds stream them group by group "
                    "per prefill/decode step)")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="device budget shared by the KV hot window and the streamed weights")
    ap.add_argument("--param-cache-mb", type=float, default=None,
                    help="weight-residency cache capacity (default: the budget slack above the "
                    "prefetch window; unbounded without a budget; 0 disables)")
    ap.add_argument("--expert-stream", action="store_true")
    ap.add_argument("--verify-schedule", action="store_true",
                    help="analyze the streamed-weight + KV page schedule, print the report and "
                    "fail on any violation before serving (needs a streamed --param-kind)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-write sharing of page-aligned prompt prefixes")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="make the first N prompt tokens identical across requests")
    # -- open-loop load generator + SLO scheduler ---------------------------
    ap.add_argument("--loadgen", action="store_true",
                    help="serve an open-loop Poisson trace through the SLO scheduler")
    ap.add_argument("--lg-seed", type=int, default=0)
    ap.add_argument("--lg-phases", default="4:2,1:8,4:2",
                    help="arrival phases as 'duration_s:rate_rps,...'")
    ap.add_argument("--lg-prompt-lens", default="8,24,48",
                    help="prompt-length mixture support (comma ints)")
    ap.add_argument("--lg-gen-lens", default="4,8,16",
                    help="output-length mixture support (comma ints)")
    ap.add_argument("--lg-shared-frac", type=float, default=1.0,
                    help="fraction of offered requests starting with the shared system prompt")
    ap.add_argument("--slo-ttft-ms", type=float, default=500.0)
    ap.add_argument("--slo-tpot-ms", type=float, default=100.0)
    ap.add_argument("--max-queue", type=int, default=32,
                    help="admission queue bound; arrivals beyond it are shed")
    ap.add_argument("--virtual-step-ms", type=float, default=10.0,
                    help="virtual clock advance per decode step (0 = wall clock)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args()

    for dest, where in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            ap.exit(2, f"--{dest.replace('_', '-')} is not ported yet: it needs {where}\n")

    if args.verify_schedule and args.param_kind == "device":
        ap.error("--verify-schedule requires --param-kind pinned_host "
                 "or disk_host (device-resident weights have no schedule)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")  # the CUDA attention kernels
    distance = args.distance if args.distance == AUTO else int(args.distance)
    if args.verify_schedule:
        _verify_schedule(args, cfg)
    if args.loadgen:
        if args.kv_page_len <= 0:
            ap.error("--loadgen drives the paged ServeSession; use --kv-page-len > 0")
        return _loadgen(args, cfg, distance)
    res = serve(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        n_requests=args.requests, kv_kind=args.kv_kind, kv_page_len=args.kv_page_len,
        hot_pages=args.hot_pages, distance=distance, seed=args.seed, spill_dir=args.spill_dir,
        param_kind=args.param_kind, device_budget_mb=args.device_budget_mb,
        param_cache_mb=args.param_cache_mb,
        prefix_sharing=not args.no_prefix_sharing, shared_prefix_len=args.shared_prefix_len,
        device=args.device,
    )
    stats = res["stats"]
    print(
        f"served {args.arch}: prefill {res['prefill_s']*1e3:.1f} ms, "
        f"decode {res['decode_s']*1e3:.1f} ms total, "
        f"{res['tokens_per_s']:.1f} tok/s "
        f"(kv_kind={args.kv_kind}, page_len={args.kv_page_len}, "
        f"paged={res['paged']}, device={args.device})"
    )
    print(
        f"transfers: h2d {stats.h2d_requests} req / {stats.bytes_h2d} B, "
        f"d2h {stats.d2h_requests} req / {stats.bytes_d2h} B, "
        f"disk {stats.disk_requests} req, "
        f"compute wait {stats.transfer_wait_s*1e3:.2f} ms"
    )
    if res["paged"]:
        print(
            f"residency: peak {res['peak_resident_bytes']} B device-resident "
            f"of {res['total_cache_bytes']} B total cache "
            f"({res['demoted_groups']} demotions, "
            f"{res['stale_drops']} stale prefetches)"
        )
    if res.get("param_plan") is not None:
        ps, plan = res["param_stats"], res["param_plan"]
        h2d = ps.per_tier()["h2d"]
        print(
            f"weights: {plan.n_groups} groups x {plan.layers_per_group} "
            f"layers, {ps.h2d_requests} H2D req "
            f"({h2d['requests_per_fetched_device_group']:.2f}/"
            f"(device,group) fetched), {ps.disk_requests} disk req, peak streamed "
            f"{ps.peak_inflight_bytes} B of {plan.total_param_bytes} B "
            f"total params"
        )
        if res.get("param_residency") is not None:
            rc = res["param_residency"]
            print(
                f"weight residency: {rc['hits']} hits / {rc['misses']} "
                f"misses, {rc['resident_bytes']} B resident "
                f"(peak {rc['peak_resident_bytes']} B, "
                f"{rc['evictions']} evictions)"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
