"""Paged hierarchical KV cache — the serving path's memory-kind consumer.

The JAX package's ``repro.core.kvpager`` on PyTorch.  The paper's claim
("compute with data sets of arbitrarily large size" §3.1) applied to decode:
each request's KV cache is split along the context axis into fixed-size
**pages** (``page_len`` tokens, all layers — one transfer group each).  Only
a *hot window* — the page currently being written plus the last
``hot_pages`` full pages — is device-resident between steps; cold pages live
at their home kind:

  ``Device``      pages stay device tensors (nothing ever moves),
  ``PinnedHost``  host numpy trees, as in the JAX package (bf16 as
                  :class:`~repro_torch.core.arrays.BF16HostArray`),
  ``DiskHost``    :class:`repro_torch.core.spillstore.SpillStore` memmap
                  chunks (one page group = one chunk file = one disk request).

Per decode step the :class:`PageStream` fetches every cold page of every
active request through the :class:`~repro_torch.core.engine.TransferEngine`
— coalesced (one H2D request per page group), pipelined ahead of consumption
under a **per-request** :class:`~repro_torch.core.engine.AdaptiveDistance`
window (``distance="auto"``), and speculatively prefetched for step ``t+1``
while step ``t``'s decode computes.  Pages crossing out of the hot window are
written back through the engine's pipelined D2H drain and re-homed.

The dense cache view the decode step consumes is rebuilt per step by
:func:`assemble_view` (a pure copy into a fresh tensor), so paged decode runs
the same decode step as unpaged decode on the same values, and the two are
bitwise equal.  The device only *retains* the hot window
(``device_resident_bytes``).

**Copy-on-write prefix sharing.**  A KV page strictly behind the write
position is immutable, and its content is a pure causal function of the
prompt prefix that produced it — so requests whose prompts share a
page-aligned prefix can alias one cold copy.  ``admit(...,
prefix_keys=...)`` attaches refcounted :class:`SharedPage` records keyed by
*content digest*: the first demotion writes the one host/spill chunk, later
demotions of aliasing records just drop their device reference, and the
per-step fetch is deduplicated by content key in :class:`PageStream`
(``stats.shared_hits``).  ``retire`` drops the chunk only at the last
reference.  Sharing never changes what the decode step reads.

PyTorch slicing returns views where ``lax.slice_in_dim`` copies, so every
page cut out of a larger tensor (at admission, by :meth:`KVPager.update_current`)
is cloned: a retained page must not pin the buffer it came from.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter, OrderedDict
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import memkind as mk
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_array, nbytes
from repro_torch.core.engine import AdaptiveDistance, TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.refspec import AUTO

__all__ = [
    "KVPagerConfig",
    "PageRecord",
    "PageTable",
    "PageStream",
    "SharedPage",
    "KVPager",
    "assemble_view",
    "page_template",
    "paged_cache_supported",
    "shared_prefix_keys",
]

Pytree = Any


# ---------------------------------------------------------------------------
# page math helpers
# ---------------------------------------------------------------------------


def _time_axis(leaf) -> int:
    """Context axis of a k/v cache leaf: (B, T, K, H) or stacked
    (L, B, T, K, H) — always third from the right."""
    return leaf.dim() - 3


def _batch_axis(leaf) -> int:
    return leaf.dim() - 4


def paged_cache_supported(cache_template: Mapping) -> bool:
    """True iff every cache leaf is a full-attention ``k``/``v`` tensor of
    rank >= 4, one that can be paged along its context axis and decoded with
    per-slot positions.  Ring buffers (``slot_pos`` shared across the batch)
    and recurrent states (no context axis) cannot: such caches serve in
    lock-step on the unpaged path."""
    def leaves(tree, name=None):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                yield from leaves(v, k)
        else:
            yield name, tree

    flat = list(leaves(cache_template))
    return bool(flat) and all(name in ("k", "v") and t.dim() >= 4 for name, t in flat)


def page_template(cache_template: Pytree, page_len: int) -> Pytree:
    """Tree of ONE page on the meta device: the cache template with its
    context axis cut to ``page_len``."""
    def cut(leaf):
        shape = list(leaf.shape)
        shape[_time_axis(leaf)] = page_len
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return tr.tree_map(cut, cache_template)


def assemble_view(view) -> Pytree:
    """Concatenate a per-slot page view into the dense cache tree.

    ``view``: tuple (over batch slots) of tuples (over pages) of page trees.
    Pages concatenate along the context axis, slots along the batch axis.
    Every slot holds the same number of pages, so each leaf is one
    ``torch.cat`` of all pages (slot-major) along the batch axis, reshaped
    so that the pages of a slot follow each other on the context axis.  The
    result is always a fresh tensor: the decode step writes its new K/V row
    into it in place, never into a page the pager retains."""
    n_slots, n_pages = len(view), len(view[0])
    flat = [page for pages in view for page in pages]

    def join(*ps):
        b, t = _batch_axis(ps[0]), _time_axis(ps[0])
        shape = list(ps[0].shape)
        out = torch.cat(ps, dim=b)
        return out.reshape(shape[:b] + [n_slots, n_pages * shape[t]] + shape[t + 1:])

    return tr.tree_map(join, *flat)


def shared_prefix_keys(prompt, page_len: int, shared_len: Optional[int] = None) -> list[str]:
    """Content-digest fetch/spill keys for the COW-shareable pages of a
    prompt: one key per page *fully covered* by the (shared prefix of the)
    prompt.

    KV content at position ``t`` is a pure causal function of tokens
    ``[0, t]``, so page ``p`` is determined by ``prompt[:(p+1)L]`` — that
    prefix's ``int32`` bytes are what gets hashed, so the keys (and the
    spill-chunk names) are the JAX package's byte for byte.
    ``shared_len`` optionally caps keying to a known shared-prefix length.
    """
    toks = np.asarray(prompt, np.int32).reshape(-1)
    n = len(toks) if shared_len is None else min(len(toks), int(shared_len))
    keys = []
    for p in range(n // page_len):
        digest = hashlib.sha1(toks[: (p + 1) * page_len].tobytes()).hexdigest()[:20]
        keys.append(f"kvshared/L{page_len}/{digest}")
    return keys


def _host_home(tree: Pytree) -> Pytree:
    """A drained writeback as its host home: numpy arrays over the drained
    (page-locked, on the card) memory, as the JAX package keeps them; on the
    CPU a tensor would be device-resident and pass through the engine
    without a request."""
    return tr.tree_map(host_array, tree)


# ---------------------------------------------------------------------------
# configuration / page table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVPagerConfig:
    """Paging knobs for one serving session."""

    #: tokens per page (all layers of one page = one transfer group)
    page_len: int = 32
    #: full pages kept device-resident behind the write position (the hot
    #: attention window; the partially-written current page is always hot)
    hot_pages: int = 1
    #: home kind of cold pages (device | pinned_host | disk_host)
    kind: Union[mk.MemKind, str] = mk.DEVICE
    #: per-request in-flight fetch window: an int, or ``"auto"`` for a
    #: per-request AdaptiveDistance controller
    distance: Union[int, str] = AUTO

    def __post_init__(self) -> None:
        if self.page_len < 1:
            raise ValueError("page_len must be >= 1")
        if self.hot_pages < 0:
            raise ValueError("hot_pages must be >= 0")


#: page residency states
_DEVICE, _COLD, _WB, _ZERO = "device", "cold", "wb", "zero"


@dataclasses.dataclass
class SharedPage:
    """One content-addressed cold page, aliased copy-on-write by every
    request whose prompt contains the same page-aligned prefix.  The cold
    home copy lives here, keyed by content digest; the last ``retire``
    drops the chunk."""

    key: str
    refs: int = 0
    host: Optional[Pytree] = None
    #: a writeback for this content is already in the engine's D2H queue:
    #: later demotions of aliasing records drop their device copy instead
    #: of queueing a duplicate writeback
    wb_pending: bool = False


@dataclasses.dataclass
class PageRecord:
    """One page's residency: device-resident tree, cold home tree (numpy /
    spill-store memmaps), in-flight writeback, or still-zero.  ``shared``
    aliases the cold home to a refcounted :class:`SharedPage`; the cold copy
    then lives on the shared record and ``host`` stays ``None``."""

    state: str = _ZERO
    dev: Optional[Pytree] = None
    host: Optional[Pytree] = None
    shared: Optional[SharedPage] = None


@dataclasses.dataclass
class PageTable:
    """Per-request page table: residency of every page of one request's
    cache, plus the next context position to write."""

    rid: int
    slot: Optional[int]  # batch slot; None while evicted
    pos: int  # next absolute position the decode step writes
    records: list[PageRecord]


# ---------------------------------------------------------------------------
# the fetch pipeline
# ---------------------------------------------------------------------------

#: each request's AdaptiveDistance under ``distance="auto"``: the
#: reference's defaults, which no caller of either package overrides
_CONTROLLER = dict(
    initial=1, min_distance=1, max_distance=8, wait_eps_s=100e-6, shrink_after=4
)


class PageStream:
    """Pipelined cold-page fetcher over a :class:`TransferEngine`.

    Keys are strings: per-request ``kv/{rid}/p{page}`` for private pages,
    content digests (``kvshared/...``) for COW-shared prefix pages.
    ``push`` enqueues a key's group charged to an *owning* request (the
    first pusher; ``sync`` re-assigns owners as requests retire); at most
    ``window(rid)`` groups per owner are submitted to the engine at once.
    ``pop`` waits the group's future, tops the windows back up, and returns
    the staged device tree; within one step, later pops of the *same* key
    return the staged tree for free and count a ``stats.shared_hits``.
    Under ``distance="auto"`` each request's :class:`AdaptiveDistance`
    observes the request's *per-step* aggregate stall (``step_done``), not
    per-group waits, so a shrink that re-introduces a stall arms the
    controller's sticky floor.  Keys pushed speculatively for a step that
    never consumes them are dropped by ``sync`` and counted.

    Each fetch passes its key to the engine (``submit_group(key=...)``), so
    the hazard sanitizer refuses a fetch of a page whose demotion writeback
    is still in flight, and the page shardings (``device_shardings``, under
    a mesh), so a fetched page group costs one request a (rank, page).
    """

    def __init__(
        self,
        engine: TransferEngine,
        *,
        distance: Union[int, str] = AUTO,
        device_shardings: Optional[Pytree] = None,
    ) -> None:
        self._engine = engine
        self._shardings = device_shardings
        self._auto = distance == AUTO
        self._static = None if self._auto else max(1, int(distance))
        self._controllers: dict[int, AdaptiveDistance] = {}
        self._pending: "OrderedDict[str, Pytree]" = OrderedDict()
        self._inflight: "OrderedDict[str, Any]" = OrderedDict()
        #: window accounting: each queued/in-flight key is charged to ONE
        #: request — the first pusher; ``sync`` re-assigns as owners retire
        self._owner: dict[str, int] = {}
        #: per-step memo of popped device trees: N sharers of one content
        #: key pay one fetch per step (cleared by ``step_done``)
        self._staged: dict[str, Pytree] = {}
        self._seq = 0
        #: per-request stall accumulated since the last ``step_done``
        self._step_waits: dict[int, float] = {}
        #: speculative pushes that were never consumed (waste metric)
        self.stale_drops = 0

    def window(self, rid: int) -> int:
        if not self._auto:
            return self._static
        ctl = self._controllers.get(rid)
        if ctl is None:
            ctl = self._controllers[rid] = AdaptiveDistance(**_CONTROLLER)
        return ctl.distance

    def _submit(self, key: str, tree: Pytree):
        fut = self._engine.submit_group(self._seq, tree, device_shardings=self._shardings, key=key)
        self._seq += 1
        self._inflight[key] = fut
        return fut

    def _top_up(self) -> None:
        # in-flight groups per owner, counted once and kept as keys submit
        inflight = Counter(self._owner.get(k) for k in self._inflight)
        for key in list(self._pending):
            rid = self._owner.get(key)
            if inflight[rid] < self.window(rid):
                self._submit(key, self._pending.pop(key))
                inflight[rid] += 1

    def push(self, rid: int, key: str, tree: Pytree) -> None:
        if key in self._pending or key in self._inflight:
            return
        self._owner[key] = rid
        self._pending[key] = tree
        self._top_up()

    def pop(self, rid: int, key: str, tree: Pytree, stats: StreamStats) -> Pytree:
        staged = self._staged.get(key)
        if staged is not None:
            # an aliasing request already fetched this content this step
            stats.shared_hits += 1
            return staged
        fut = self._inflight.pop(key, None)
        if fut is None:
            # never prefetched (cold start / late table change): fetch now —
            # the paper's on-demand penalty, paid only at boundaries
            self._pending.pop(key, None)
            fut = self._submit(key, tree)
            self._inflight.pop(key)
        self._owner.pop(key, None)
        w = fut.wait()
        stats.n_transfers += 1
        stats.n_groups += 1
        stats.h2d_requests += fut.n_requests
        stats.bytes_h2d += fut.nbytes
        stats.disk_requests += fut.disk_requests
        stats.bytes_disk += fut.disk_nbytes
        stats.transfer_wait_s += w
        stats.wait_per_group.append(w)
        stats.disk_wait_s += fut.disk_wait_s
        stats.disk_wait_per_group.append(fut.disk_wait_s)
        stats.n_devices = max(stats.n_devices, fut.n_devices)
        stats.n_device_groups += fut.n_devices
        if fut.is_resident:
            stats.cache_hits += 1
        else:
            stats.cache_misses += 1
            stats.unique_group_fetches += 1
            stats.fetched_device_groups += fut.n_devices
        if self._auto:
            self._step_waits[rid] = self._step_waits.get(rid, 0.0) + w
        stats.distance_trace.append(self.window(rid))
        self._top_up()
        # the consumer stream waits on the copy's event here, never on the
        # staging buffer
        dev = fut.group()
        self._staged[key] = dev
        return dev

    def step_done(self) -> None:
        """Feed each request's controller its aggregate stall for the step
        just consumed (after the step's pops, before the next ``push`` wave
        so the adapted window applies immediately), and release the step's
        staged shared trees."""
        self._staged.clear()
        if not self._auto:
            return
        for rid, w in self._step_waits.items():
            self.window(rid)  # ensure the controller exists
            self._controllers[rid].observe(w)
        self._step_waits.clear()
        self._top_up()

    def sync(self, valid: dict) -> None:
        """Drop queued/in-flight keys outside ``valid`` (stale speculation)
        and re-charge surviving keys to their current owners (``valid`` maps
        key -> owning rid).  In-flight futures complete on the worker
        regardless; only the references are released."""
        for key in [k for k in self._pending if k not in valid]:
            del self._pending[key]
            self._owner.pop(key, None)
            self.stale_drops += 1
        for key in [k for k in self._inflight if k not in valid]:
            del self._inflight[key]
            self._owner.pop(key, None)
            self.stale_drops += 1
        for key, rid in valid.items():
            if key in self._pending or key in self._inflight:
                self._owner[key] = rid

    def forget(self, rid: int) -> None:
        """Release a finished request's controller state (per-rid state must
        not grow with the request count)."""
        self._controllers.pop(rid, None)
        self._step_waits.pop(rid, None)


# ---------------------------------------------------------------------------
# the pager
# ---------------------------------------------------------------------------


class KVPager:
    """Per-request paged KV-cache manager over a batched decode cache.

    Owns the page tables of every live request, the residency state machine
    (hot device window / cold home kind / zero future pages), the fetch
    stream, and the demotion writebacks.  The serving loop drives it:

    ``admit``      split a prefilled per-slot cache into pages, demote the
                   pages behind the hot window to the home kind.
    ``prefetch``   push every cold page of every active request into the
                   stream (speculative for the next step; deduped).
    ``view``       pop this step's cold pages and return the per-slot page
                   view for :func:`assemble_view` / the paged decode step.
    ``update_current`` cut each active slot's partially-written page out of
                   the decode step's cache (the only page a step mutates).
    ``advance``    after ``pos`` moves past a page boundary: demote pages
                   that fell out of the hot window (pipelined D2H).
    ``evict`` / ``readmit`` park a request's device pages at the host
                   (freeing its slot) and later resume it cold.
    """

    def __init__(
        self,
        cache_template: Pytree,
        config: KVPagerConfig,
        *,
        slots: int,
        engine: TransferEngine,
        store=None,
        device_shardings: Optional[Pytree] = None,
    ) -> None:
        """``cache_template``: per-slot cache tree on the meta device (batch
        dim 1, context dim = the padded maximum length, a multiple of
        ``page_len``).  Pages live on the engine's device.
        ``device_shardings``: under a mesh, a tree of
        :class:`~repro_torch.core.memkind.Sharding` congruent with one page
        (:func:`page_template`); cold pages are fetched at these layouts and
        device pages are DTensors (each rank its own shard)."""
        if not paged_cache_supported(cache_template):
            raise ValueError(
                "paged KV serving requires a full-attention k/v cache "
                "(ring slot_pos / recurrent states cannot be paged)"
            )
        self.config = config
        self.kind = mk.as_kind(config.kind)
        self.slots = slots
        self.engine = engine
        self.store = store
        if self.kind == mk.DISK_HOST and store is None:
            raise ValueError("kind=disk_host requires a SpillStore")
        leaves = tr.leaves(cache_template)
        self.max_len = leaves[0].shape[_time_axis(leaves[0])]
        if self.max_len % config.page_len != 0:
            raise ValueError(
                f"cache length {self.max_len} must be a multiple of "
                f"page_len {config.page_len}"
            )
        self.n_pages = self.max_len // config.page_len
        page_shapes = page_template(cache_template, config.page_len)
        self.page_nbytes = sum(nbytes(s) for s in tr.leaves(page_shapes))
        device = engine.device
        self._zero_page = tr.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), page_shapes
        )
        if device_shardings is not None:
            self._zero_page = tr.tree_map(lambda z, sh: sh.put(z), self._zero_page,
                                          device_shardings)
        self.tables: dict[int, PageTable] = {}
        self._by_slot: dict[int, PageTable] = {}
        self.stream = PageStream(engine, distance=config.distance,
                                 device_shardings=device_shardings)
        self._wb_seq = 0
        self._pending_demotions: list[tuple[PageTable, int]] = []
        self.demoted_groups = 0
        self.peak_resident_bytes = 0
        #: content digest -> refcounted shared cold page (COW prefix sharing)
        self._shared: dict[str, SharedPage] = {}
        #: demotions satisfied by an existing shared cold copy: D2H
        #: writebacks (and spill chunks) NOT paid because an aliasing request
        #: already homed the same content
        self.shared_skipped_writebacks = 0

    # -- page plumbing --------------------------------------------------------
    def _page_of(self, cache: Pytree, slot: int, p: int) -> Pytree:
        """Page ``p`` of batch row ``slot``, cloned out of ``cache``."""
        L = self.config.page_len
        return tr.tree_map(
            lambda a: a.narrow(_batch_axis(a), slot, 1).narrow(_time_axis(a), p * L, L).clone(),
            cache,
        )

    # -- page-table state machine --------------------------------------------
    def current_page(self, table: PageTable) -> int:
        return table.pos // self.config.page_len

    def _hot_floor(self, table: PageTable) -> int:
        return max(0, self.current_page(table) - self.config.hot_pages)

    def _page_key(self, rid: int, p: int) -> str:
        return f"kv/{rid}/p{p:05d}"

    def _fetch_key(self, table: PageTable, p: int) -> str:
        """Engine transfer/spill key of a page: the content digest for a
        COW-shared page (one key per content for the whole batch), the
        per-request key otherwise."""
        rec = table.records[p]
        if rec.shared is not None:
            return rec.shared.key
        return self._page_key(table.rid, p)

    @staticmethod
    def _cold_home(rec: PageRecord) -> Optional[Pytree]:
        """A cold page's home tree: the shared record's for aliased pages."""
        return rec.shared.host if rec.shared is not None else rec.host

    def admit(
        self,
        rid: int,
        slot: int,
        cache_slot: Pytree,
        n_tokens: int,
        prefix_keys: Optional[list[str]] = None,
    ) -> PageTable:
        """Install a freshly prefilled per-slot cache as a page table.  Pages
        behind the hot window are demoted (caller flushes).  Pages past the
        write page start as the shared zero page; the others are cloned out
        of the prefill's buffer, which is then free.

        ``prefix_keys`` (from :func:`shared_prefix_keys`): content keys for
        the leading pages fully covered by the prompt's shared prefix — those
        records alias the refcounted shared registry.  Only pages strictly
        behind the write page are shareable (decode mutates the current
        page)."""
        cur = n_tokens // self.config.page_len
        records = [
            PageRecord(_DEVICE, dev=self._page_of(cache_slot, 0, p)) if p <= cur
            else PageRecord(_ZERO)
            for p in range(self.n_pages)
        ]
        if prefix_keys and self.kind != mk.DEVICE:
            for p, key in enumerate(prefix_keys):
                if p >= cur:
                    break
                sp = self._shared.get(key)
                if sp is None:
                    sp = self._shared[key] = SharedPage(key=key)
                sp.refs += 1
                records[p].shared = sp
        table = PageTable(rid=rid, slot=slot, pos=n_tokens, records=records)
        self.tables[rid] = table
        self._by_slot[slot] = table
        if self.kind != mk.DEVICE:
            for p in range(self._hot_floor(table)):
                self._demote(table, p)
        return table

    def _demote(self, table: PageTable, p: int) -> None:
        rec = table.records[p]
        sp = rec.shared
        if sp is not None:
            if sp.host is not None or sp.wb_pending:
                # an aliasing request already homed (or is homing) this
                # content: dropping the device reference IS the demotion
                rec.dev = None
                rec.state = _COLD
                self.shared_skipped_writebacks += 1
                return
        elif rec.host is not None:
            # a promoted page still carries its cold home copy, and pages
            # behind the write head are never mutated — dropping the device
            # reference IS the demotion (no redundant D2H / store rewrite)
            rec.dev = None
            rec.state = _COLD
            return
        self.engine.submit_writeback(self._wb_seq, rec.dev, key=self._fetch_key(table, p))
        self._wb_seq += 1
        if sp is not None:
            sp.wb_pending = True
        self._pending_demotions.append((table, p))
        rec.dev = None
        rec.state = _WB

    def flush_demotions(self, stats: StreamStats) -> None:
        """Drain pending page writebacks (pipelined D2H, in submit order) and
        re-home them at the cold kind."""
        if not self._pending_demotions:
            return
        pending, self._pending_demotions = self._pending_demotions, []
        t0 = time.perf_counter()
        hosts = self.engine.drain_writebacks()
        stats.writeback_drain_s += time.perf_counter() - t0
        for (table, p), host in zip(pending, hosts):
            leaves = tr.leaves(host)
            stats.n_transfers += 1
            stats.d2h_requests += len(leaves)
            stats.bytes_d2h += sum(nbytes(x) for x in leaves)
            rec = table.records[p]
            key = self._fetch_key(table, p)
            if self.kind == mk.DISK_HOST:
                self.store.put(key, host)
                host = self.store.get(key)
            else:
                host = _host_home(host)
            if rec.shared is not None:
                rec.shared.host = host
                rec.shared.wb_pending = False
            else:
                rec.host = host
            rec.state = _COLD
            self.demoted_groups += 1

    def cold_keys(self) -> "OrderedDict[str, tuple]":
        """Every cold page of every active request, slot-major then page
        order (the stream's submission = consumption order).  Maps the fetch
        key -> ``(owning rid, home tree)``; a COW-shared content key appears
        ONCE, owned by the first slot consuming it."""
        out: "OrderedDict[str, tuple]" = OrderedDict()
        for slot in sorted(self._by_slot):
            table = self._by_slot[slot]
            for p, rec in enumerate(table.records):
                if rec.state == _COLD:
                    key = self._fetch_key(table, p)
                    if key not in out:
                        out[key] = (table.rid, self._cold_home(rec))
        return out

    def prefetch(self) -> None:
        """Speculatively push the current cold set (deduped; stale keys from
        retired/evicted requests are dropped)."""
        cold = self.cold_keys()
        self.stream.sync({key: rid for key, (rid, _t) in cold.items()})
        for key, (rid, tree) in cold.items():
            self.stream.push(rid, key, tree)

    def view(self, stats: StreamStats) -> tuple:
        """This step's per-slot page view: hot pages by reference, cold pages
        popped from the stream, future pages the shared zero page."""
        view = []
        for slot in range(self.slots):
            table = self._by_slot.get(slot)
            if table is None:
                view.append((self._zero_page,) * self.n_pages)
                continue
            pages = []
            for p, rec in enumerate(table.records):
                if rec.state == _DEVICE:
                    pages.append(rec.dev)
                elif rec.state == _ZERO:
                    pages.append(self._zero_page)
                else:
                    if rec.state == _WB or (rec.shared is not None and rec.shared.host is None):
                        # demoted but never flushed (or aliasing a shared
                        # writeback still in the D2H queue): flush so the
                        # host bytes exist
                        self.flush_demotions(stats)
                    dev = self.stream.pop(
                        table.rid, self._fetch_key(table, p), self._cold_home(rec), stats,
                    )
                    if self.kind == mk.DEVICE or p >= self._hot_floor(table):
                        # home tier is the device (or the page re-entered the
                        # hot window after a readmit): promote
                        rec.dev = dev
                        rec.state = _DEVICE
                    pages.append(dev)
            view.append(tuple(pages))
        # one controller observation per request per step (see PageStream)
        self.stream.step_done()
        return tuple(view)

    def update_current(self, new_cache: Pytree) -> None:
        """Cut each active slot's current page out of the decode step's
        cache (the only page the step wrote), cloned so that it does not
        keep the step's whole assembled view alive.  The copies run inside
        a ``record_function`` span, which a profiler reads."""
        with record_function("update_current"):
            for slot, table in self._by_slot.items():
                p = self.current_page(table)
                rec = table.records[p]
                rec.dev = self._page_of(new_cache, slot, p)
                rec.host = None
                rec.state = _DEVICE
        self.peak_resident_bytes = max(self.peak_resident_bytes, self.device_resident_bytes())

    def advance(self, table: PageTable) -> None:
        """Call after ``table.pos`` advanced: demote pages that fell out of
        the hot window (no-op for the device home kind)."""
        if self.kind == mk.DEVICE:
            return
        for p in range(self._hot_floor(table)):
            if table.records[p].state == _DEVICE:
                self._demote(table, p)

    # -- continuous batching -------------------------------------------------
    def evict(self, rid: int, stats: StreamStats) -> None:
        """Park every device page at the host (spill store for disk homes)
        and free the request's batch slot; the table survives for
        ``readmit``."""
        table = self.tables[rid]
        for p, rec in enumerate(table.records):
            if rec.state == _DEVICE:
                self._demote(table, p)
        self.flush_demotions(stats)
        if table.slot is not None:
            self._by_slot.pop(table.slot, None)
        table.slot = None
        self.prefetch()  # drop the evicted request's in-flight keys

    def readmit(self, rid: int, slot: int) -> PageTable:
        """Resume an evicted request in a (free) batch slot; its pages are
        cold and stream back in over the following steps."""
        if slot in self._by_slot:
            raise ValueError(f"slot {slot} is occupied")
        table = self.tables[rid]
        if table.slot is not None:
            raise ValueError(f"request {rid} is not evicted")
        table.slot = slot
        self._by_slot[slot] = table
        return table

    def retire(self, rid: int, stats: StreamStats) -> None:
        """Drop a finished request: device pages freed, spill chunks deleted,
        slot released."""
        # in-flight demotions must land before their records are dropped
        # (flush zips pending entries with drained tickets in order — e.g. a
        # gen==1 request retires straight from admission)
        self.flush_demotions(stats)
        table = self.tables.pop(rid)
        if table.slot is not None:
            self._by_slot.pop(table.slot, None)
        for rec in table.records:
            sp = rec.shared
            if sp is None:
                continue
            # drop the shared chunk only at the LAST reference: aliasing
            # requests still decode against it
            sp.refs -= 1
            if sp.refs <= 0:
                self._shared.pop(sp.key, None)
                if self.kind == mk.DISK_HOST and self.store is not None:
                    if sp.key in self.store:
                        self.store.delete(sp.key)
        if self.kind == mk.DISK_HOST and self.store is not None:
            for p in range(self.n_pages):
                key = self._page_key(rid, p)
                if key in self.store:
                    self.store.delete(key)
        table.records = []
        self.stream.forget(rid)
        self.prefetch()

    # -- accounting ----------------------------------------------------------
    def device_resident_bytes(self) -> int:
        """Bytes of cache the device *retains* between steps (hot pages +
        promoted pages + the shared zero page)."""
        n_dev = sum(1 for t in self.tables.values() for r in t.records if r.state == _DEVICE)
        return (n_dev + 1) * self.page_nbytes  # +1: the shared zero page

    def total_cache_bytes(self) -> int:
        """Bytes of the full dense cache across all slots (what an unpaged
        device-resident run retains)."""
        return self.slots * self.n_pages * self.page_nbytes

    def shared_pages(self) -> int:
        """Live entries in the COW shared-page registry."""
        return len(self._shared)

    def shared_refs(self) -> int:
        """Total references into the shared registry."""
        return sum(sp.refs for sp in self._shared.values())
