"""The port's paper slice held against the JAX package's: memory kinds,
``OffloadRef``, ``@offload`` (quickstart listings 1-3), the graph streaming
engine and the local-copy memory model.

Both packages get the same numpy inputs; the port runs on the CPU by
request (``device="cpu"``).  Values agree within f32 rtol 2e-4 / atol 2e-3
across frameworks, integer counters exactly, and ``__call__``, ``.eager``
and ``.stream_host`` in every mode bit for bit within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memkind as jmk
from repro.core import prefetch as jpf
from repro.core.hoststream import StreamStats as JaxStreamStats
from repro.core.localcopy import LocalCopyCache as JaxLocalCopyCache
from repro.core.offload import offload as jax_offload
from repro.core.refspec import OffloadRef as JaxOffloadRef
from repro.core.refspec import PrefetchSpec as JaxPrefetchSpec
from repro_torch.core import memkind as mk
from repro_torch.core import prefetch as pf
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.localcopy import LocalCopyCache
from repro_torch.core.offload import offload
from repro_torch.core.refspec import AUTO, OffloadRef, PrefetchSpec

F32_TOL = dict(rtol=2e-4, atol=2e-3)
MODES = ("eager", "on_demand", "prefetch")
LISTING2 = dict(buffer_size=10, elements_per_fetch=2, distance=4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# memory kinds and placement policies
# ---------------------------------------------------------------------------

KIND_FIELDS = ("jax_kind", "level", "directly_addressable", "jax_addressable", "staging_jax_kind")


def test_kinds_have_the_jax_fields():
    assert [k.jax_kind for k in mk.all_kinds()] == [k.jax_kind for k in jmk.all_kinds()]
    for p, j in zip(mk.all_kinds(), jmk.all_kinds()):
        assert type(p).__name__ == type(j).__name__
        for f in KIND_FIELDS:
            assert getattr(p, f) == getattr(j, f)
        assert mk.as_kind(p.jax_kind) == p
    with pytest.raises(ValueError, match="unknown memory kind"):
        mk.as_kind("vmem")


def test_kind_resolution_on_the_cpu_matches_jax():
    """The JAX package's CPU backend cannot execute host placements, so its
    host kinds resolve to device; the port's CPU does the same."""
    assert mk.host_offload_supported("cpu") is jmk.host_offload_supported() is False
    for p, j in zip(mk.all_kinds(), jmk.all_kinds()):
        assert mk.resolve_kind(p, device="cpu").jax_kind == jmk.resolve_kind(j).jax_kind
        assert (mk.resolve_kind(p, device="cpu", allow_fallback=False).jax_kind
                == jmk.resolve_kind(j, allow_fallback=False).jax_kind)


def test_placement_policies_match_jax():
    assert mk.POLICIES.keys() == jmk.POLICIES.keys()
    for name in mk.POLICIES:
        p, j = mk.get_policy(name), jmk.get_policy(name)
        for f in ("params", "opt_state", "kv_cache"):
            assert getattr(p, f).jax_kind == getattr(j, f).jax_kind
        assert (p.requires_host(), p.requires_spill()) == (j.requires_host(), j.requires_spill())
    assert mk.HOST_OPT.with_(params=mk.DISK_HOST).requires_spill()
    with pytest.raises(ValueError, match="unknown placement policy"):
        mk.get_policy("nvme_everything")


def test_place_round_trip_listing3():
    x = np.arange(8.0, dtype=np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    jhost = jmk.place(jnp.asarray(x), mesh, jax.sharding.PartitionSpec(), jmk.PINNED_HOST)
    jdev = jmk.place(jhost, mesh, jax.sharding.PartitionSpec(), jmk.DEVICE)
    host = mk.place(x, mk.PINNED_HOST, "cpu")
    dev = mk.place(host, mk.DEVICE, "cpu")
    assert dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))
    tree = mk.place({"a": x, "b": [x[:2]]}, mk.UNPINNED_HOST, "cpu")
    assert mk.kind_of(tree["b"][0]) == mk.UNPINNED_HOST


def test_place_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.place(np.zeros(3, np.float32), mk.PINNED_HOST)


def test_offload_ref_rejects_what_jax_rejects():
    with pytest.raises(ValueError) as jerr:
        JaxOffloadRef(kind=jmk.DEVICE, prefetch=JaxPrefetchSpec())
    with pytest.raises(ValueError) as perr:
        OffloadRef(kind=mk.DEVICE, prefetch=PrefetchSpec())
    assert str(perr.value) == str(jerr.value)
    # a spec is taken, as the JAX package takes it (its placement under a
    # mesh: test_offload_ref_spec_places_each_ranks_shard)
    assert OffloadRef(kind=mk.PINNED_HOST, spec=("data",)).spec == tuple(
        JaxOffloadRef(kind=jmk.PINNED_HOST, spec=jax.sharding.PartitionSpec("data")).spec)
    r, j = OffloadRef(kind=mk.PINNED_HOST, prefetch=PrefetchSpec()), JaxOffloadRef(
        kind=jmk.PINNED_HOST, prefetch=JaxPrefetchSpec())
    assert r.streamed == j.streamed is True
    assert OffloadRef().streamed == JaxOffloadRef().streamed is False


def test_offload_ref_spec_places_each_ranks_shard():
    """``OffloadRef(spec=...)`` places by ``sharding_for`` on the function's
    mesh (the default: a ``("data",)`` mesh over the ranks, one here): the
    kernel sees a DTensor of the value, the host home keeps the rank's shard
    and its placement."""
    import torch.distributed as dist

    from repro_torch.parallel.local import full_local

    if dist.is_initialized():
        pytest.skip("this process holds a group")
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    b = np.ones((6, 4), np.float32)

    def add(x, y):
        return x + y

    streamed = PrefetchSpec(buffer_size=2, elements_per_fetch=2)
    refs = dict(x=OffloadRef(kind=mk.UNPINNED_HOST, spec=("data",), prefetch=streamed),
                y=OffloadRef(kind=mk.UNPINNED_HOST, spec=("data",), prefetch=streamed))
    f = offload(add, refs=refs, device="cpu")
    try:
        assert tuple(f.mesh().mesh_dim_names) == ("data",)
        home = f.place("x", a)
        assert isinstance(home, mk.HostShard) and home.shape == (6, 4)
        out = f(a, b)
        np.testing.assert_array_equal(np.asarray(full_local(out)), a + b)
        np.testing.assert_array_equal(np.asarray(full_local(f.eager(a, b))), a + b)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# @offload: quickstart listings 1-2, __call__ vs .eager vs .stream_host
# ---------------------------------------------------------------------------

def test_listing1_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 100, 1000).astype(np.float32) for _ in range(2))

    @jax_offload
    def jkernel(a, b):
        return a + b

    @offload(device="cpu")
    def kernel(a, b):
        return a + b

    out = kernel(a, b)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(jkernel(a, b)))
    np.testing.assert_array_equal(kernel.eager(a, b).numpy(), a + b)


def _listing2(pkg_offload, pkg_mk, ref_cls, spec_cls, **kw):
    spec = spec_cls(**LISTING2)

    @pkg_offload(refs=dict(a=ref_cls(kind=pkg_mk.PINNED_HOST, prefetch=spec),
                           b=ref_cls(kind=pkg_mk.PINNED_HOST, prefetch=spec)), **kw)
    def kernel(a, b):
        return a * 2.0 + b

    return kernel


@pytest.mark.parametrize("mode", MODES)
def test_listing2_call_eager_and_stream_host_agree(mode):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((64, 128)).astype(np.float32) for _ in range(2))
    jk = _listing2(jax_offload, jmk, JaxOffloadRef, JaxPrefetchSpec)
    pk = _listing2(offload, mk, OffloadRef, PrefetchSpec, device="cpu")
    try:
        jst, pst = JaxStreamStats(), StreamStats()
        jout = jk.stream_host(a, b, mode=mode, stats=jst)
        outs = [pk(a, b), pk.eager(a, b), pk.stream_host(a, b, mode=mode, stats=pst)]
    finally:
        jk.close()
        pk.close()
    for out in outs:
        assert torch.equal(out, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jk(a, b)), **F32_TOL)
    np.testing.assert_allclose(outs[2].numpy(), jout, **F32_TOL)
    for f in ("n_groups", "h2d_requests", "bytes_h2d", "d2h_requests", "bytes_d2h",
              "peak_inflight_bytes", "n_transfers"):
        assert getattr(pst, f) == getattr(jst, f), f
    assert pst.requests_per_group == 1.0


def test_stream_host_from_disk_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((32, 16)).astype(np.float32) for _ in range(2))
    jk = _listing2(jax_offload, jmk, JaxOffloadRef, JaxPrefetchSpec)
    pk = _listing2(offload, mk, OffloadRef, PrefetchSpec, device="cpu")
    try:
        jst, pst = JaxStreamStats(), StreamStats()
        jout = jk.stream_host(a, b, stats=jst, policy=jmk.DISK_PARAMS)
        out = pk.stream_host(a, b, stats=pst, policy=mk.DISK_PARAMS, spill_dir=tmp_path / "s")
        pinned = pk.stream_host(a, b)
    finally:
        jk.close()
        pk.close()
    assert torch.equal(out, pinned)
    np.testing.assert_allclose(out.numpy(), jout, **F32_TOL)
    for f in ("n_groups", "h2d_requests", "bytes_h2d", "disk_requests", "bytes_disk"):
        assert getattr(pst, f) == getattr(jst, f), f
    assert pst.disk_requests == pst.n_groups == 16
    assert (tmp_path / "s").exists()  # a caller's spill directory is durable


def test_private_spill_store_is_deleted_on_close():
    x = np.ones((8, 2), np.float32)
    spec = PrefetchSpec(2, 4, 1)

    @offload(refs=dict(x=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec)), device="cpu")
    def k(x):
        return x + 1

    k.stream_host(x, policy=mk.DISK_PARAMS)
    spill_dir = k._spill_store.dir
    assert spill_dir.exists()
    k.close()
    assert not spill_dir.exists()


def test_fixed_arguments_ride_along_and_lower_is_not_ported():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 4)).astype(np.float32)
    scale = np.float32(3.0)
    spec = PrefetchSpec(buffer_size=2, elements_per_fetch=3, distance=1)

    @offload(refs=dict(x=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec)), device="cpu")
    def k(x, scale):
        return x * scale

    try:
        for out in (k(x, scale), k.eager(x, scale), k.stream_host(x, scale)):
            np.testing.assert_array_equal(out.numpy(), x * scale)
    finally:
        k.close()
    # lower(), the dry-run's trace: x (pinned host) streams through a ring of
    # distance + 1 = 2 blocks of 3 rows; scale rides along on the device
    low = k.lower(x, scale)
    assert (low.n_blocks, low.host_bytes, low.window_bytes) == (4, x.nbytes, 2 * 3 * 4 * 4)
    mem = low.memory_analysis()
    assert (mem.argument_size_in_bytes, mem.output_size_in_bytes) == (4, x.nbytes)
    whole = k.lower(x, scale, streamed=False)  # the eager call: x copied whole
    assert (whole.n_blocks, whole.host_bytes, whole.window_bytes) == (1, x.nbytes, 0)
    assert whole.memory_analysis().temp_size_in_bytes == x.nbytes
    with pytest.raises(ValueError, match="unknown arguments"):
        offload(refs=dict(y=OffloadRef()), device="cpu")(lambda x: x)


@pytest.mark.parametrize("height", [256, 512])
def test_lower_streams_listing_4_through_its_ring(height):
    """The quickstart's listing 4 product with its ``x`` homed at pinned
    host and streamed: lowered at two heights of the host array, the host
    bytes follow the height while the device holds the same ring window
    (distance 2 + 1 blocks of one row) and each block costs the same
    FLOPs; the device arguments are ``w`` alone."""
    from repro_torch.kernels.streamed_matmul import streamed_matmul

    spec = PrefetchSpec(buffer_size=3, elements_per_fetch=1, distance=2)

    @offload(refs=dict(x=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec)), device="cpu")
    def listing4(x, w):
        return streamed_matmul(x, w, spec=spec)

    x = np.zeros((height, 512), np.float32)
    w = torch.zeros((512, 256))
    low = listing4.lower(x, w)
    assert low.n_blocks == height and low.host_bytes == height * 512 * 4
    assert low.window_bytes == 3 * 512 * 4
    assert low.flops // low.n_blocks == 2 * 512 * 256
    assert low.compile().cost_analysis()["flops"] == 2.0 * height * 512 * 256
    mem = low.compile().memory_analysis()
    assert (mem.argument_size_in_bytes, mem.output_size_in_bytes, mem.alias_size_in_bytes) == (
        w.numel() * 4, height * 256 * 4, 0)


# ---------------------------------------------------------------------------
# the graph streaming engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distance", [0, 1, 2, AUTO])
@pytest.mark.parametrize("elems", [1, 2, 4])
def test_streamed_scan_matches_jax_and_is_schedule_invariant(distance, elems):
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    x0 = rng.standard_normal((4, 16)).astype(np.float32)

    def jbody(c, wl):
        c = jnp.tanh(c @ wl)
        return c, c.sum()

    def body(c, wl):
        c = torch.tanh(c @ wl)
        return c, c.sum()

    jspec = JaxPrefetchSpec(buffer_size=4, elements_per_fetch=elems, distance=distance)
    spec = PrefetchSpec(buffer_size=4, elements_per_fetch=elems, distance=distance)
    jc, jys = jpf.streamed_scan(jbody, jnp.asarray(x0), jnp.asarray(w), prefetch=jspec)
    c, ys = pf.streamed_scan(body, torch.from_numpy(x0), w, prefetch=spec, device="cpu")
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **F32_TOL)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **F32_TOL)
    base_c, base_ys = pf.streamed_scan(body, torch.from_numpy(x0), w,
                                       prefetch=PrefetchSpec(1, 1, 0), device="cpu")
    assert torch.equal(c, base_c) and torch.equal(ys, base_ys)


def test_stream_blocks_and_eager_transfer():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((12, 3)).astype(np.float32)
    out = pf.stream_blocks(lambda x: x * 2, (a,), prefetch=PrefetchSpec(2, 3, 1), device="cpu")
    np.testing.assert_array_equal(out.numpy(), a * 2)
    np.testing.assert_array_equal(_np(pf.fetch_chunk({"a": a}, 3, "cpu")["a"]), a[3])
    assert pf.eager_transfer([a], "cpu")[0].device.type == "cpu"
    with pytest.raises(ValueError, match="not divisible"):
        pf.stream_blocks(lambda x: x, (a,), prefetch=PrefetchSpec(2, 5, 1), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        pf.streamed_scan(lambda c, x: (c, None), 0, {}, prefetch=PrefetchSpec(), device="cpu")


# ---------------------------------------------------------------------------
# the local-copy memory model (paper §3.3)
# ---------------------------------------------------------------------------

def test_local_copy_cache_matches_jax():
    jc = JaxLocalCopyCache(capacity_bytes=3 * 16 * 4)
    pc = LocalCopyCache(capacity_bytes=3 * 16 * 4, device="cpu")
    for c in (jc, pc):
        for i in range(5):
            c.register(f"v{i}", np.full(16, float(i), np.float32))
            c.read(f"v{i}")
        c.read("v4")
        a = c.read("v0")
        c.write("v0", a * 3.0)
        c.invalidate("v1")
        c.read("v1")
    assert pc.stats == jc.stats
    np.testing.assert_array_equal(_np(pc.home("v0")), np.asarray(jc.home("v0")))
    np.testing.assert_array_equal(pc.read("v0").numpy(), np.full(16, 0.0, np.float32))
    pc.invalidate()
    assert pc.read("v2").numpy()[0] == 2.0
