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

Under ``attn_impl="pallas"`` prefill runs the CUDA ``flash_attention``
kernel and decode the CUDA ``decode_attention`` kernel.  Streamed weights
and model parallelism are later slices (ROADMAP.md).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --kv-kind pinned_host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --loadgen --lg-prompt-lens 128,256,512 \\
      --lg-gen-lens 8,16,32 --shared-prefix-len 64 --kv-kind pinned_host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 3072 --gen 32 --kv-page-len 0
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import tempfile
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import memkind as mk
from repro_torch.core import tree as tr
from repro_torch.core.arrays import nbytes
from repro_torch.core.engine import TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.kvpager import KVPager, KVPagerConfig, shared_prefix_keys
from repro_torch.core.refspec import AUTO
from repro_torch.core.spillstore import SpillStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.train import steps as st

KV_KINDS = ("device", "pinned_host", "disk_host")
PARAM_KINDS = ("device", "pinned_host", "disk_host")

_STREAMED = "streamed weights (ROADMAP.md, queue 1 item 4)"

#: the JAX package's result keys of the weight stream, None here
_WEIGHT_KEYS = ("param_stats", "expert_stats", "param_plan")


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_weights_on_device(param_kind: str, device_budget_mb, param_cache_mb,
                             expert_stream: bool) -> None:
    """Refuse the streamed-weight arguments, which are not ported yet."""
    given = {
        "param_kind": param_kind if param_kind != "device" else None,
        "device_budget_mb": device_budget_mb,
        "param_cache_mb": param_cache_mb,
        "expert_stream": expert_stream or None,
    }
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(f"{name}={value!r} needs {_STREAMED}")


@functools.lru_cache(maxsize=None)
def lock_step(cfg) -> bool:
    """True iff ``cfg`` serves in lock-step: its caches hold a ring
    (``slot_pos`` shared across the batch) or recurrent states, so requests
    cannot be prefilled one at a time or decoded at per-slot positions."""
    return not st.paged_cache_supported(st.abstract_caches(cfg, 1, 1))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[..., -1, :].argmax(dim=-1).to(torch.int32)


def prefill_all(cfg, params: ParamTree, prompts: torch.Tensor, max_len: int) -> tuple[torch.Tensor, dict]:
    """Prefill every row of ``prompts`` ((B, S) token ids on the device) into
    caches of ``max_len`` positions.  Returns each request's first greedy
    token ((B,) int32) and the caches.  Pageable caches prefill one request
    at a time and stack on the batch axis; in :func:`lock_step` all rows
    prefill in one batch."""
    if lock_step(cfg):
        logits, caches = st.make_prefill_step(cfg, prompts.shape[0], max_len)(params, {"tokens": prompts})
        return _greedy(logits), caches
    prefill_fn = st.make_prefill_step(cfg, 1, max_len)
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
    Runs on the card unless ``device="cpu"``.  The streamed-weight arguments
    raise ``NotImplementedError`` before any engine thread or spill
    directory exists.
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
        param_cache_mb: Optional[float] = None,
        expert_stream: bool = False,
        prefix_sharing: bool = True,
        params: Optional[ParamTree] = None,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg
        self.slots = slots
        self.stats = StreamStats(mode="paged")
        self._kind = mk.as_kind(kv_kind)
        # validate — and do every fallible init — before the engine thread
        # and the spill dir exist: a failed constructor must not leak them
        _check_weights_on_device(param_kind, device_budget_mb, param_cache_mb, expert_stream)
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
        self.params = params if params is not None else st.init_params(cfg, seed, self.device)

        self._engine = engine or TransferEngine(device=self.device)
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

    def prefill_compiles(self) -> int:
        """Distinct bucket widths prefilled: the number of prefill
        executables the JAX package compiles for the same requests."""
        return len(self._prefill_widths)

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

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the unpaged path (per-step whole-cache placement)
# ---------------------------------------------------------------------------


def serve_loop(
    cfg,
    params: ParamTree,
    prompts: np.ndarray,
    gen: int,
    *,
    device: torch.device,
    warmup: bool = True,
    kv_kind: str = "device",
    engine: Optional[TransferEngine] = None,
) -> dict:
    """Serve one greedy request per row of ``prompts`` ((B, S) int32) for
    ``gen`` tokens with ``params`` on ``device``, on the unpaged path.

    The first token of each request comes from its prefill
    (:func:`prefill_all`); ``gen - 1`` decode steps follow.  With
    ``kv_kind="pinned_host"`` the whole cache round-trips through host
    memory synchronously before every step (the JAX package's pre-pager
    schedule; ``engine`` only adds its emulated link's time).  Tokens stay on
    the device until the loop ends.
    """
    kind = mk.as_kind(kv_kind)
    if kind == mk.DISK_HOST:
        raise ValueError("the unpaged path has no disk home; use --kv-page-len > 0")
    device_resident = kind == mk.DEVICE
    stats = StreamStats()
    batch, prompt_len = prompts.shape
    # decided before the clock starts: the first call builds a cache tree on
    # the meta device, a one-time cost of the process that is not prefill
    lock_step(cfg)
    decode_fn = st.make_decode_step(cfg)
    prompts_t = torch.tensor(np.asarray(prompts), dtype=torch.long, device=device)

    t0 = time.perf_counter()
    tokens, caches = prefill_all(cfg, params, prompts_t, prompt_len + gen)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    cache_leaves = tr.leaves(caches)
    n_leaves, cache_bytes = len(cache_leaves), sum(nbytes(x) for x in cache_leaves)

    def round_trip(c):
        t0 = time.perf_counter()
        c = mk.place(c, kind, device)
        _sync(device)
        if engine is not None:
            engine.emulate_blocking_transfer(n_leaves, cache_bytes)
        c = mk.place(c, mk.DEVICE, device)
        _sync(device)
        if engine is not None:
            engine.emulate_blocking_transfer(n_leaves, cache_bytes)
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
    t0 = time.perf_counter()
    for i in range(gen - 1):
        w0 = stats.transfer_wait_s
        if not device_resident:
            # the paper's Host kind, pre-pager: the ENTIRE cache round-trips
            # through host memory synchronously every step
            caches = round_trip(caches)
        pos = step_pos(cfg, batch, prompt_len + i, device)
        logits, caches = decode_fn(params, caches, _step_batch(tokens, device), pos)
        tokens = _greedy(logits)
        out_tokens.append(tokens)
        step_waits.append(stats.transfer_wait_s - w0)
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
        **dict.fromkeys(_WEIGHT_KEYS + ("expert_decode_bytes", "expert_decode_fetches")),
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
    copy-on-write.  The defaults are the JAX package's, and so are the
    returned keys (its weight-stream keys are ``None`` here).  Prompts come
    from ``np.random.default_rng(seed + 1)`` on both paths, so a paged and
    an unpaged run serve the same prompts.  Runs on the card unless
    ``device="cpu"`` is passed.
    """
    device = resolve_device(device)
    _check_weights_on_device(param_kind, device_budget_mb, param_cache_mb, expert_stream)
    n_requests = n_requests or batch
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(1, cfg.vocab_size, (n_requests, prompt_len), dtype=np.int32)
    if kv_page_len <= 0:
        if n_requests != batch:
            raise ValueError("the unpaged path serves exactly one request per slot")
        if params is None:
            params = st.init_params(cfg, seed, device)
        return serve_loop(cfg, params, prompts, gen, device=device, warmup=warmup,
                          kv_kind=kv_kind, engine=engine)

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
            **dict.fromkeys(_WEIGHT_KEYS + ("param_step_fetches", "param_residency")),
        }


#: flags of the JAX entry point that this port does not serve yet, and where
#: their port is queued; any value but the default exits
_NOT_PORTED = {
    "param_kind": _STREAMED,
    "device_budget_mb": _STREAMED,
    "param_cache_mb": _STREAMED,
    "expert_stream": _STREAMED,
    "verify_schedule": _STREAMED,
    "model_parallel": "model parallelism (ROADMAP.md, queue 1 item 5: multi-device and tooling)",
}


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
    ap.add_argument("--param-kind", default="device", choices=PARAM_KINDS)
    ap.add_argument("--device-budget-mb", type=float, default=None)
    ap.add_argument("--param-cache-mb", type=float, default=None)
    ap.add_argument("--expert-stream", action="store_true")
    ap.add_argument("--verify-schedule", action="store_true")
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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")  # the CUDA attention kernels
    distance = args.distance if args.distance == AUTO else int(args.distance)
    if args.loadgen:
        if args.kv_page_len <= 0:
            ap.error("--loadgen drives the paged ServeSession; use --kv-page-len > 0")
        return _loadgen(args, cfg, distance)
    res = serve(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        n_requests=args.requests, kv_kind=args.kv_kind, kv_page_len=args.kv_page_len,
        hot_pages=args.hot_pages, distance=distance, seed=args.seed, spill_dir=args.spill_dir,
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
