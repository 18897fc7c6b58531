"""The port's KV pager held against the JAX package's on the same numpy inputs.

Both pagers are driven through the same schedule (admit, prefetch, view,
a decode write, update_current, advance, evict, readmit, retire) on the
same cache values: every assembled view must be bitwise the JAX package's,
and every accounting integer and ``StreamStats`` counter equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import kvpager as jkp
from repro.core import memkind as jmk
from repro.core.engine import TransferEngine as JaxTransferEngine
from repro.core.hoststream import StreamStats as JaxStreamStats
from repro.core.spillstore import SpillStore as JaxSpillStore
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.core import kvpager as kp
from repro_torch.core import memkind as mk
from repro_torch.core.engine import TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.spillstore import SpillStore
from repro_torch.train import steps as st

# (L, B, T, K, H) of a per-slot cache: 2 layers, 2 KV heads of 4
L, T, K, H = 2, 24, 2, 4

COUNTERS = ("n_transfers", "n_groups", "h2d_requests", "d2h_requests", "bytes_h2d", "bytes_d2h",
            "disk_requests", "bytes_disk", "unique_group_fetches", "cache_hits", "cache_misses",
            "shared_hits", "fetched_device_groups", "n_device_groups")


def _template_np():
    return {"k": np.zeros((L, 1, T, K, H), np.float32), "v": np.zeros((L, 1, T, K, H), np.float32)}


def _jax_template():
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), _template_np())


def _torch_template():
    return {k: torch.empty(a.shape, dtype=torch.float32, device="meta") for k, a in _template_np().items()}


# ---------------------------------------------------------------------------
# page math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_len", [1, 4, 5, 16])
@pytest.mark.parametrize("shared_len", [None, 0, 7, 12])
def test_shared_prefix_keys_equal_jax(page_len, shared_len):
    rng = np.random.default_rng(page_len)
    prompt = rng.integers(1, 50_000, 23, dtype=np.int64)  # keyed on its int32 bytes
    assert kp.shared_prefix_keys(prompt, page_len, shared_len) == \
        jkp.shared_prefix_keys(prompt, page_len, shared_len)


def test_shared_prefix_keys_are_content_addressed():
    a = np.arange(1, 17, dtype=np.int32)
    b = np.concatenate([a[:8], np.arange(90, 98, dtype=np.int32)])
    ka, kb = kp.shared_prefix_keys(a, 4), kp.shared_prefix_keys(b, 4)
    assert len(ka) == len(kb) == 4
    assert ka[:2] == kb[:2] and ka[2:] != kb[2:]
    assert kp.shared_prefix_keys(a, 4, shared_len=8) == ka[:2]
    # a page's key depends on everything before it (KV is causal)
    c = np.concatenate([np.arange(50, 54, dtype=np.int32), a[4:8]])
    assert kp.shared_prefix_keys(c, 4)[1] != ka[1]


def test_page_template_cuts_the_context_axis():
    pt = kp.page_template(_torch_template(), 4)
    jpt = jkp.page_template(_jax_template(), 4)
    for name in ("k", "v"):
        assert tuple(pt[name].shape) == jpt[name].shape == (L, 1, 4, K, H)
        assert pt[name].device.type == "meta"


@pytest.mark.parametrize("n_slots, n_pages", [(1, 1), (3, 4)])
def test_assemble_view_equals_jax_and_always_allocates(n_slots, n_pages):
    rng = np.random.default_rng(0)
    pages = [[{n: rng.standard_normal((L, 1, 4, K, H)).astype(np.float32) for n in ("k", "v")}
              for _ in range(n_pages)] for _ in range(n_slots)]
    view = tuple(tuple({n: torch.from_numpy(a) for n, a in pg.items()} for pg in slot) for slot in pages)
    jview = tuple(tuple({n: jnp.asarray(a) for n, a in pg.items()} for pg in slot) for slot in pages)
    out, ref = kp.assemble_view(view), jkp.assemble_view(jview)
    for name in ("k", "v"):
        assert out[name].shape == (L, n_slots, 4 * n_pages, K, H)
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]))
    # the decode step writes into the assembled view in place: no page may
    # share its memory
    out["k"].fill_(7.0)
    for slot in view:
        for pg in slot:
            assert not (pg["k"] == 7.0).any()


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_paged_cache_supported_equals_jax(arch):
    ours = kp.paged_cache_supported(st.abstract_caches(get_smoke_config(arch), 1, 16))
    theirs = jkp.paged_cache_supported(jax_steps.abstract_caches(jax_get_smoke_config(arch), 1, 16))
    assert ours == theirs == (arch == "smollm-360m")
    assert st.paged_cache_supported is kp.paged_cache_supported  # one definition


@pytest.mark.parametrize("bad", [dict(page_len=0), dict(hot_pages=-1)])
def test_pager_config_validates_its_knobs(bad):
    with pytest.raises(ValueError, match=next(iter(bad))):
        kp.KVPagerConfig(**bad)
    with pytest.raises(ValueError, match=next(iter(bad))):
        jkp.KVPagerConfig(**bad)


@pytest.mark.parametrize("case", ["recurrentgemma", "unaligned", "disk_without_store"])
def test_pager_refuses(case):
    """The guards of the JAX package's pager: an unpageable cache, a length
    that is not a multiple of the page, a disk home without a store."""
    template, cfg, match = _torch_template(), kp.KVPagerConfig(page_len=4), "full-attention"
    if case == "recurrentgemma":
        template = st.abstract_caches(get_smoke_config("recurrentgemma-2b"), 1, 16)
    elif case == "unaligned":
        template, match = st.abstract_caches(get_smoke_config("smollm-360m"), 1, 18), "multiple"
    else:
        cfg, match = kp.KVPagerConfig(page_len=4, kind=mk.DISK_HOST), "SpillStore"
    with TransferEngine(device="cpu") as engine:
        with pytest.raises(ValueError, match=match):
            kp.KVPager(template, cfg, slots=1, engine=engine)


# ---------------------------------------------------------------------------
# the pager's schedule against the JAX package's
# ---------------------------------------------------------------------------

class _Pair:
    """The port's and the JAX package's pagers, driven in lock-step."""

    def __init__(self, kind, tmp_path, *, slots=2, page_len=4, hot_pages=1, distance="auto"):
        self.engine = TransferEngine(device="cpu")
        self.jengine = JaxTransferEngine()
        self.store = SpillStore(tmp_path / "torch") if kind == "disk_host" else None
        self.jstore = JaxSpillStore(tmp_path / "jax") if kind == "disk_host" else None
        cfg = dict(page_len=page_len, hot_pages=hot_pages, distance=distance)
        self.p = kp.KVPager(_torch_template(), kp.KVPagerConfig(kind=mk.as_kind(kind), **cfg),
                            slots=slots, engine=self.engine, store=self.store)
        self.j = jkp.KVPager(_jax_template(), jkp.KVPagerConfig(kind=jmk.as_kind(kind), **cfg),
                             slots=slots, engine=self.jengine, store=self.jstore)
        self.stats, self.jstats = StreamStats(), JaxStreamStats()

    def close(self):
        for x in (self.engine, self.jengine, self.store, self.jstore):
            if x is not None:
                x.close()

    def admit(self, rid, slot, cache, n_tokens, prefix_keys=None):
        self.p.admit(rid, slot, {n: torch.from_numpy(a.copy()) for n, a in cache.items()}, n_tokens,
                     prefix_keys=prefix_keys)
        self.j.admit(rid, slot, {n: jnp.asarray(a) for n, a in cache.items()}, n_tokens,
                     prefix_keys=prefix_keys)

    def both(self, method, *args):
        """The same call on both pagers (with each one's stats where the
        method takes them)."""
        with_stats = method in _WITH_STATS
        getattr(self.p, method)(*args, *([self.stats] if with_stats else []))
        getattr(self.j, method)(*args, *([self.jstats] if with_stats else []))

    def step(self, rng):
        """view -> assemble -> a decode write at each slot's position ->
        update_current -> advance; the assembled views must be bitwise
        equal."""
        dense = kp.assemble_view(self.p.view(self.stats))
        jdense = jkp.assemble_view(self.j.view(self.jstats))
        self.p.prefetch()
        self.j.prefetch()
        for name in ("k", "v"):
            np.testing.assert_array_equal(dense[name].numpy(), np.asarray(jdense[name]))
        for slot, table in self.p._by_slot.items():
            row = rng.standard_normal((L, K, H)).astype(np.float32)
            for name in ("k", "v"):
                dense[name][:, slot, table.pos] = torch.from_numpy(row)
                jdense[name] = jdense[name].at[:, slot, table.pos].set(row)
        self.p.update_current(dense)
        self.j.update_current(jdense)
        for pager in (self.p, self.j):
            for table in list(pager._by_slot.values()):
                table.pos += 1
                pager.advance(table)
        self.both("flush_demotions")

    def check(self):
        for name in COUNTERS:
            assert getattr(self.stats, name) == getattr(self.jstats, name), name
        for name in ("demoted_groups", "peak_resident_bytes", "shared_skipped_writebacks"):
            assert getattr(self.p, name) == getattr(self.j, name), name
        for name in ("device_resident_bytes", "total_cache_bytes", "shared_pages", "shared_refs"):
            assert getattr(self.p, name)() == getattr(self.j, name)(), name
        assert self.p.stream.stale_drops == self.j.stream.stale_drops
        assert list(self.p.cold_keys()) == list(self.j.cold_keys())
        assert {r: [x.state for x in t.records] for r, t in self.p.tables.items()} == \
            {r: [x.state for x in t.records] for r, t in self.j.tables.items()}
        if self.store is not None:
            assert sorted(self.store.keys()) == sorted(self.jstore.keys())


_WITH_STATS = ("flush_demotions", "evict", "retire")


@pytest.mark.parametrize("distance", ["auto", 2])
@pytest.mark.parametrize("kind", ["device", "pinned_host", "disk_host"])
def test_pager_schedule_matches_jax(kind, distance, tmp_path):
    rng = np.random.default_rng(1)
    pair = _Pair(kind, tmp_path, distance=distance)
    try:
        prompt = rng.integers(1, 100, 12, dtype=np.int32)
        keys = kp.shared_prefix_keys(prompt, 4)
        cache = lambda: {n: rng.standard_normal((L, 1, T, K, H)).astype(np.float32) for n in ("k", "v")}
        pair.admit(0, 0, cache(), 9, prefix_keys=keys)
        pair.admit(1, 1, cache(), 11, prefix_keys=keys)  # aliases the first two pages
        pair.both("flush_demotions")
        pair.both("prefetch")
        pair.check()
        for _ in range(3):
            pair.step(rng)
            pair.check()
        pair.both("evict", 0)
        pair.check()
        pair.step(rng)
        pair.both("readmit", 0, 0)
        for _ in range(2):
            pair.step(rng)
            pair.check()
        pair.both("retire", 1)
        pair.step(rng)
        pair.both("retire", 0)
        pair.check()
        assert pair.p.shared_pages() == 0 and not pair.p.tables
    finally:
        pair.close()


def test_pages_cut_out_of_a_buffer_do_not_pin_it(tmp_path):
    """Admission and update_current clone their pages: a hot page must not
    keep the prefill's (or the step's) whole buffer alive."""
    pair = _Pair("pinned_host", tmp_path)
    try:
        cache = {n: torch.zeros((L, 1, T, K, H)) for n in ("k", "v")}
        pair.p.admit(0, 0, cache, 9)
        for rec in pair.p.tables[0].records:
            if rec.dev is not None:
                assert rec.dev["k"].untyped_storage().nbytes() == L * 4 * K * H * 4
        dense = kp.assemble_view(pair.p.view(pair.stats))
        pair.p.update_current(dense)
        cur = pair.p.tables[0].records[pair.p.current_page(pair.p.tables[0])]
        assert cur.dev["v"].untyped_storage().nbytes() == L * 4 * K * H * 4
    finally:
        pair.close()


def test_host_homes_are_numpy(tmp_path):
    """Pinned-host pages are homed as numpy arrays, as in the JAX package:
    a CPU tensor would pass through the CPU engine without a request."""
    pair = _Pair("pinned_host", tmp_path)
    try:
        pair.admit(0, 0, {n: np.ones((L, 1, T, K, H), np.float32) for n in ("k", "v")}, 13)
        pair.both("flush_demotions")
        homes = [r.host for r in pair.p.tables[0].records if r.state == "cold"]
        assert homes and all(isinstance(x, np.ndarray) for h in homes for x in h.values())
    finally:
        pair.close()


def test_paged_decode_step_runs_the_decode_step_on_the_assembled_view():
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32")
    params = st.init_params(cfg, 0, "cpu")
    cache = st.make_prefill_step(cfg, 2, 16)(params, {"tokens": torch.arange(1, 19).reshape(2, 9)})[1]
    pages = tuple(tuple({n: cache[n][:, b:b + 1, p * 4:(p + 1) * 4].clone() for n in ("k", "v")}
                        for p in range(4)) for b in range(2))
    batch, pos = {"tokens": torch.tensor([[3], [4]])}, torch.tensor([9, 9], dtype=torch.int32)
    paged = st.make_paged_decode_step(cfg)(params, pages, batch, pos)
    dense = st.make_decode_step(cfg)(params, st.clone_caches(cache), batch, pos)
    assert torch.equal(paged[0], dense[0])
    for name in ("k", "v"):
        assert torch.equal(paged[1][name], dense[1][name])
