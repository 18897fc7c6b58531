"""The port's transfer engine, host streaming and spill store held against
the JAX package's.

Both packages get the same numpy inputs (``np.random.default_rng``).  By
the port's comparison rules: integer counters (requests, bytes, groups,
peaks) are exactly equal, pure data movement (pack/unpack, spill round
trips) is bitwise, float compute agrees within f32 rtol 2e-4 / atol 2e-3,
and modes and distances are bitwise equal within the port.  The port runs
on the CPU by request (``device="cpu"``); tests marked ``cuda`` run the
engine on a card and skip without one.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import hoststream as jhs
from repro.core import spillstore as jspill
from repro_torch.core import tree as tr
from repro_torch.core.engine import (
    AdaptiveDistance,
    EngineConfig,
    GroupLayout,
    LinkModel,
    TransferEngine,
    group_signature,
)
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.spillstore import SpillStore, is_disk_leaf

CPU = torch.device("cpu")
F32_TOL = dict(rtol=2e-4, atol=2e-3)
MODES = ("eager", "on_demand", "prefetch")
#: StreamStats integer counters that must match the JAX package exactly
COUNTERS = ("n_transfers", "h2d_requests", "d2h_requests", "bytes_h2d", "bytes_d2h", "n_groups",
            "disk_requests", "bytes_disk", "peak_inflight_bytes", "n_runs", "cache_hits",
            "cache_misses", "unique_group_fetches", "retries", "give_ups")
TIMEOUT_S = 60.0


def run_with_timeout(fn, timeout_s: float = TIMEOUT_S):
    """Run ``fn`` on a daemon thread: a deadlock fails the test."""
    box: dict = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"timed out after {timeout_s}s (possible deadlock)"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _mixed_group(rng):
    return {
        "f32": rng.standard_normal((5, 7)).astype(np.float32),
        "f64": rng.standard_normal((3, 2)),
        "f16": rng.standard_normal((3, 4)).astype(np.float16),
        "i32": rng.integers(-1000, 1000, (11,)).astype(np.int32),
        "i64": rng.integers(-1000, 1000, (4,)),
        "u8": rng.integers(0, 255, (13,)).astype(np.uint8),
        "bool": rng.integers(0, 2, (9,)).astype(bool),
    }


def _counters(st) -> dict:
    return {c: getattr(st, c) for c in COUNTERS}


# ---------------------------------------------------------------------------
# GroupLayout: pack/unpack is bitwise and lays bytes out as the JAX package
# ---------------------------------------------------------------------------

def test_group_layout_matches_jax_byte_for_byte():
    group = _mixed_group(np.random.default_rng(0))
    jl, pl = jeng.GroupLayout(group), GroupLayout(group, device=CPU)
    assert (pl.staging_bytes, pl.payload_bytes, pl.n_packed, pl.n_requests) == (
        jl.staging_bytes, jl.payload_bytes, jl.n_packed, jl.n_requests)
    assert [(i, o, s, nb) for i, o, s, _, nb in pl.metas] == [
        (i, o, tuple(s), nb) for i, o, s, _, nb in jl.metas]
    jst = jl.pack_into(jax.tree.leaves(group), jl.new_staging())
    pst = pl.pack_into(tr.leaves(group), pl.new_staging()).numpy()
    for _, o, _, _, nb in jl.metas:  # padding is uninitialised in both
        assert bytes(pst[o:o + nb]) == bytes(jst[o:o + nb])


def test_group_layout_unpack_is_bitwise_at_canonical_dtypes():
    group = _mixed_group(np.random.default_rng(1))
    layout = GroupLayout(group, device=CPU)
    leaves = tr.leaves(group)
    out = layout.unpack(layout.pack_into(leaves, layout.new_staging()).clone(), leaves)
    ref = jax.tree.map(np.asarray, jax.device_put(group))  # canonical f64->f32, i64->i32
    for key in group:
        assert out[key].numpy().dtype == ref[key].dtype
        np.testing.assert_array_equal(out[key].numpy(), ref[key])


def test_resident_leaves_pass_through_by_reference():
    rng = np.random.default_rng(2)
    dev_leaf = torch.arange(6.0)
    group = {"host": rng.standard_normal((4, 4)).astype(np.float32), "dev": dev_leaf}
    assert group_signature(group, CPU) != group_signature({**group, "dev": dev_leaf.numpy()}, CPU)
    with TransferEngine(device="cpu") as eng:
        fut = eng.submit_group(0, group)
        fut.wait()
        assert fut.n_requests == 1 and fut.nbytes == 64
        assert fut.group()["dev"] is dev_leaf
        fut2 = eng.submit_group(1, {"dev": dev_leaf})
        fut2.wait()
        assert fut2.is_resident and fut2.n_requests == 0


@pytest.mark.parametrize("coalesce", [True, False])
def test_request_accounting_matches_jax(coalesce):
    group = _mixed_group(np.random.default_rng(3))
    with jeng.TransferEngine(jeng.EngineConfig(coalesce=coalesce)) as je, \
            TransferEngine(EngineConfig(coalesce=coalesce), device="cpu") as pe:
        jf, pf = je.submit_group(0, group), pe.submit_group(0, group)
        jf.wait()
        pf.wait()
        assert (pf.n_requests, pf.nbytes) == (jf.n_requests, jf.nbytes)
        jg, pg = jax.tree.map(np.asarray, jf.group()), pf.group()
        for key in group:
            np.testing.assert_array_equal(pg[key].numpy(), jg[key])


def test_staging_pool_is_reused_not_grown():
    groups = [np.full((64,), float(i), np.float32) for i in range(12)]
    with TransferEngine(device="cpu") as eng:
        for i, g in enumerate(groups):
            fut = eng.submit_group(i, g)
            fut.wait()
            np.testing.assert_array_equal(fut.group().numpy(), g)
        # on the CPU the "device" buffer is the staging memory itself, so a
        # buffer in use is never recycled (the JAX package's alias guard)
        assert eng.staging_allocs == len(groups)


def test_sanitize_is_not_ported():
    """The sanitizer is ported now (this test once pinned its refusal):
    ``EngineConfig(sanitize=True)`` builds one, and it refuses a fetch of a
    key whose writeback is still in flight."""
    from repro_torch.core.schedcheck import HazardError

    with TransferEngine(EngineConfig(sanitize=True), device="cpu") as eng:
        assert eng.sanitizer is not None
        eng.submit_writeback(0, {"w": torch.ones(2)}, key="k")
        with pytest.raises(HazardError):
            eng.submit_group(1, np.ones(2, np.float32), key="k")
    assert TransferEngine(EngineConfig(sanitize=False), device="cpu").sanitizer is None


# ---------------------------------------------------------------------------
# AdaptiveDistance: the same controller trace as the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_distance_trace_matches_jax(seed):
    rng = np.random.default_rng(seed)
    waits = np.where(rng.random(300) < 0.3, 1e-3, 1e-6)
    kw = dict(initial=2, min_distance=1, max_distance=6, wait_eps_s=100e-6, shrink_after=3)
    jc, pc = jeng.AdaptiveDistance(**kw), AdaptiveDistance(**kw)
    for i, w in enumerate(waits):
        if i % 50 == 49:
            assert pc.boost(2) == jc.boost(2)
        assert pc.observe(float(w)) == jc.observe(float(w))


#: the shard suite's sharded row, its 80 measured waits (us) of 5 runs: one
#: of the port's two gloo ranks (its window ended at 5) and the JAX
#: package's one executor (ended at 7), on a CPU
_SHARD_WAITS_US = {
    "port_rank": [
        1896.2, 17.0, 16.9, 12.4, 10.7, 12.0, 8.4, 10.3, 1460.0, 11.4, 11.7, 9.7, 19.0, 12.2,
        10.9, 8.0, 14426.6, 12.5, 9.4, 4350.4, 10.5, 10.8, 12.3, 1644.1, 10.4, 2099.4, 2198.0,
        9.2, 4.7, 1592.8, 3474.1, 359.4, 5736.0, 19.2, 9.0, 16.1, 8.9, 11.6, 10.0, 9.5, 6.4,
        10.8, 11.3, 7.2, 6.5, 6.8, 6.4, 5.2, 3815.7, 1483.7, 1350.5, 8.5, 8.5, 9.0, 9.7, 8.4,
        15.0, 13.8, 10.1, 9.0, 8.5, 8.5, 9.1, 5.8, 2911.7, 6497.2, 3187.3, 8.5, 9.2, 6.4, 6.3,
        8.7, 7.2, 10.9, 11.3, 9.7, 9.3, 8.8, 7.5, 9.0],
    "jax_executor": [
        2416.4, 259.7, 1761.6, 696.2, 7.5, 123.6, 1264.7, 555.8, 219.7, 1086.8, 1072.6, 1929.6,
        1142.7, 963.0, 1792.3, 1044.4, 2528.0, 8.8, 11.5, 7.7, 1210.3, 2189.0, 562.5, 6.9, 11.3,
        13.8, 11.5, 12.5, 147.6, 2008.0, 11.6, 7.3, 2916.0, 10.1, 8.5, 7.7, 9.4, 9.5, 133.1,
        1190.6, 1209.7, 1181.3, 1216.3, 1272.2, 1201.9, 1201.3, 1243.5, 1111.2, 2581.2, 770.8,
        1267.1, 1254.8, 540.9, 1214.4, 8.3, 197.0, 1339.7, 1282.3, 1224.8, 1229.0, 1197.6, 16.6,
        8.5, 282.7, 2460.7, 6.2, 1213.7, 2652.6, 6.6, 11.7, 8.2, 1125.5, 1472.8, 11.0, 13.3, 12.5,
        10.9, 9.9, 13.6, 7.3],
}


@pytest.mark.parametrize("source", sorted(_SHARD_WAITS_US))
def test_adaptive_distance_on_the_shard_suites_measured_waits(source):
    """The shard suite's ``final_distance`` moves with the measured waits,
    not with the controller: the waits one run measured, fed to both
    packages' controllers at the executor's settings, give one trace."""
    cfg = EngineConfig()
    kw = dict(initial=cfg.min_distance, min_distance=cfg.min_distance,
              max_distance=cfg.max_distance, wait_eps_s=cfg.wait_eps_s,
              shrink_after=cfg.shrink_after)
    jc, pc = jeng.AdaptiveDistance(**kw), AdaptiveDistance(**kw)
    ours = [pc.observe(w * 1e-6) for w in _SHARD_WAITS_US[source]]
    theirs = [jc.observe(w * 1e-6) for w in _SHARD_WAITS_US[source]]
    assert ours == theirs
    assert 1 < ours[-1] <= cfg.max_distance


def test_engine_widen_reaches_registered_controllers():
    with TransferEngine(device="cpu") as eng:
        ctrl = AdaptiveDistance(initial=1, max_distance=8)
        eng.register_controller(ctrl)
        assert eng.widen(2) == [3, 4]  # the controller, then the disk window


# ---------------------------------------------------------------------------
# retries under injected faults: the JAX package's counts
# ---------------------------------------------------------------------------

def _flaky(real, faults_at):
    calls = {"n": 0}

    def wrapper(*a, **kw):
        calls["n"] += 1
        if calls["n"] in faults_at:
            raise RuntimeError("injected transient fault")
        return real(*a, **kw)

    return wrapper, calls


@pytest.mark.parametrize("faults_at", [(1,), (2, 5), (3, 4)])
def test_transient_h2d_faults_retry_like_jax(monkeypatch, faults_at):
    rng = np.random.default_rng(4)
    groups = [{"x": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(5)]
    cfg_j = jeng.EngineConfig(max_attempts=3, retry_backoff_s=1e-4)
    cfg_p = EngineConfig(max_attempts=3, retry_backoff_s=1e-4)
    sj, sp = jhs.StreamStats(), StreamStats()

    def body():
        with jhs.HostStreamExecutor(lambda c, g: (c, g["x"] * 2.0), writeback=True,
                                    engine_config=cfg_j) as ex:
            zero = jnp.zeros(())
            flaky, _ = _flaky(jax.device_put, faults_at)
            monkeypatch.setattr(jax, "device_put", flaky)
            _, jouts = ex.run(zero, groups, mode="prefetch", stats=sj)
            monkeypatch.undo()
        flaky, _ = _flaky(GroupLayout.put_staged, faults_at)
        monkeypatch.setattr(GroupLayout, "put_staged", flaky)
        with HostStreamExecutor(lambda c, g: (c, g["x"] * 2.0), writeback=True,
                                engine_config=cfg_p, device="cpu") as ex:
            _, pouts = ex.run(torch.zeros(()), groups, mode="prefetch", stats=sp)
        monkeypatch.undo()
        for j, p, g in zip(jouts, pouts, groups):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
            np.testing.assert_array_equal(p.numpy(), g["x"] * 2.0)

    run_with_timeout(body)
    assert sp.retries == sj.retries == len(faults_at)
    assert _counters(sp) == _counters(sj)


def test_permanent_fault_surfaces_after_max_attempts(monkeypatch):
    calls = {"n": 0}

    def dead_put(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("injected permanent H2D fault")

    st = StreamStats()

    def body():
        monkeypatch.setattr(GroupLayout, "put_staged", dead_put)
        cfg = EngineConfig(max_attempts=3, retry_backoff_s=1e-4)
        with HostStreamExecutor(lambda c, g: c, engine_config=cfg, device="cpu") as ex:
            with pytest.raises(RuntimeError, match="permanent H2D fault"):
                ex.run(torch.zeros(()), [np.zeros(4, np.float32)] * 2, mode="on_demand", stats=st)

    run_with_timeout(body)
    assert calls["n"] == 3 and st.give_ups == 1 and st.retries == 2


def test_transient_disk_and_d2h_faults_retry(monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    host = [{"x": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(4)]
    store = SpillStore(tmp_path / "spill")
    disk = []
    for i, g in enumerate(host):
        store.put(f"g{i}", g)
        disk.append(store.get(f"g{i}"))
    st = StreamStats()

    def body():
        acquire, acalls = _flaky(TransferEngine._acquire_disk_staging, (2,))
        get, gcalls = _flaky(TransferEngine._get, (3,))
        monkeypatch.setattr(TransferEngine, "_acquire_disk_staging", acquire)
        monkeypatch.setattr(TransferEngine, "_get", get)
        cfg = EngineConfig(max_attempts=3, retry_backoff_s=1e-4)
        with HostStreamExecutor(lambda c, g: (c, g["x"] + 1.0), writeback=True,
                                engine_config=cfg, device="cpu") as ex:
            _, outs = ex.run(torch.zeros(()), disk, mode="prefetch", stats=st)
        for o, g in zip(outs, host):
            np.testing.assert_array_equal(o.numpy(), g["x"] + 1.0)

    run_with_timeout(body)
    store.close()
    assert st.retries == 2 and st.give_ups == 0
    assert st.disk_requests == st.h2d_requests == st.n_groups == 4


# ---------------------------------------------------------------------------
# the spill store: one chunk format for both packages
# ---------------------------------------------------------------------------

def _spill_tree(seed):
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return bf, {
        "w": rng.standard_normal((6, 4)).astype(np.float32),
        "i": rng.integers(-5, 5, (7,)).astype(np.int32),
        "m": rng.integers(0, 2, (3,)).astype(bool),
        "s": np.float32(2.5),
    }


def test_spill_chunks_written_by_either_package_read_bitwise_in_the_other(tmp_path):
    bf, tree = _spill_tree(6)
    jtree = {**tree, "b": np.asarray(jnp.asarray(bf, jnp.bfloat16))}
    ptree = {**tree, "b": torch.from_numpy(bf).to(torch.bfloat16)}
    js, ps = jspill.SpillStore(tmp_path / "jax"), SpillStore(tmp_path / "port")
    js.put("layer/0", jtree)
    ps.put("layer/0", ptree)
    # the same bytes and the same manifest entry, file for file
    jfile = js.dir / js._manifest["layer/0"]["file"]
    pfile = ps.dir / ps._manifest["layer/0"]["file"]
    assert jfile.name == pfile.name and jfile.read_bytes() == pfile.read_bytes()
    assert json.loads((js.dir / "manifest.json").read_text()) == json.loads(
        (ps.dir / "manifest.json").read_text())
    # the port reads the JAX package's chunk ...
    got = SpillStore(tmp_path / "jax").get("layer/0", template=ptree)
    assert all(is_disk_leaf(v) for k, v in got.items() if k != "s" or v.size)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]), tree[k])
    from repro_torch.core.arrays import host_tensor

    assert torch.equal(host_tensor(got["b"]), ptree["b"])
    # ... and the JAX package reads the port's
    jgot = jspill.SpillStore(tmp_path / "port").get("layer/0", template=jtree)
    for k in jtree:
        np.testing.assert_array_equal(np.asarray(jgot[k]), np.asarray(jtree[k]))
    jspill.SpillStore(tmp_path / "port").verify_chunk("layer/0")
    SpillStore(tmp_path / "jax").verify_chunk("layer/0")


def test_spill_crc_mismatch_recovers_from_durable_home(tmp_path):
    _, tree = _spill_tree(7)
    store = SpillStore(tmp_path / "s")
    store.put("g", tree)
    store.set_recovery(lambda key: tree)
    path = store.dir / store._manifest["g"]["file"]
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF  # flip bits of leaf 0 ("i", sorted first)
    path.write_bytes(bytes(raw))
    with TransferEngine(device="cpu") as eng:
        fut = eng.submit_group(0, store.get("g"))
        fut.wait()
        np.testing.assert_array_equal(fut.group()["i"].numpy(), tree["i"])
    assert store.crc_failures == 1 and store.recoveries == 1


def test_disk_tier_roundtrip_against_source_bytes(tmp_path):
    """disk -> host staging -> device equals the source bytes (the JAX
    package's own engine output is not the reference here)."""
    group = _mixed_group(np.random.default_rng(8))
    store = SpillStore(tmp_path / "s")
    store.put("g", group)
    st = StreamStats()
    with HostStreamExecutor(lambda c, g: c + [g], device="cpu") as ex:
        (staged,), _ = ex.run([], [store.get("g")], stats=st)
    canon = jax.tree.map(np.asarray, jax.device_put(group))
    for k in group:
        np.testing.assert_array_equal(staged[k].numpy(), canon[k])
    assert (st.disk_requests, st.h2d_requests) == (1, 1)
    assert st.bytes_disk == st.bytes_h2d == GroupLayout(group, device=CPU).payload_bytes


# ---------------------------------------------------------------------------
# HostStreamExecutor: the lung-NN Fig 3 small config through both packages
# ---------------------------------------------------------------------------

N_PX, N_HIDDEN, BATCH, N_GROUPS = 3600, 100, 8, 16


@pytest.fixture(scope="module")
def lung_nn():
    rng = np.random.default_rng(9)
    w1 = (rng.standard_normal((N_PX, N_HIDDEN)) * 0.01).astype(np.float32)
    w2 = (rng.standard_normal((N_HIDDEN, 1)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((BATCH, N_PX)).astype(np.float32)
    ys = (xs[:, ::97].sum(-1, keepdims=True) > 0).astype(np.float32)
    h = 1 / (1 + np.exp(-(xs @ w1)))
    p = 1 / (1 + np.exp(-(h @ w2)))
    dh = (((p - ys) @ w2.T) * h * (1 - h)).astype(np.float32)
    gp = N_PX // N_GROUPS
    return ([xs[:, i * gp:(i + 1) * gp] for i in range(N_GROUPS)],
            [w1[i * gp:(i + 1) * gp] for i in range(N_GROUPS)], dh)


def _jax_fig3(x_groups, w1_groups, dh, mode):
    @jax.jit
    def ff_apply(carry, group):
        xg, wg = group
        return carry + xg @ wg

    @jax.jit
    def grad_apply(carry, group):
        xg, wg, d = group
        gw = xg.T @ d
        return carry + jnp.sum(gw * wg), gw

    from repro.core.refspec import PrefetchSpec as JSpec

    spec = JSpec(buffer_size=4, elements_per_fetch=1, distance=2)  # the benchmark's
    st, st2 = jhs.StreamStats(), jhs.StreamStats()
    with jhs.HostStreamExecutor(ff_apply) as ex:
        ff, _ = ex.run(jnp.zeros((BATCH, N_HIDDEN)), list(zip(x_groups, w1_groups)),
                       prefetch=spec, mode=mode, stats=st)
    with jhs.HostStreamExecutor(grad_apply, writeback=True) as ex:
        cg, outs = ex.run(jnp.zeros(()), list(zip(x_groups, w1_groups, [jnp.asarray(dh)] * N_GROUPS)),
                          prefetch=spec, mode=mode, stats=st2)
    return (np.asarray(ff), np.asarray(cg), [np.asarray(o) for o in outs]), st, st2


@pytest.mark.parametrize("mode", MODES)
def test_fig3_small_matches_jax(lung_nn, mode):
    from repro_torch.benchmarks.offload_modes import SPEC, ff_apply, grad_apply

    x_groups, w1_groups, dh = lung_nn
    (jff, jcg, jouts), jst, jst2 = _jax_fig3(x_groups, w1_groups, dh, mode)
    st, st2 = StreamStats(), StreamStats()
    with HostStreamExecutor(ff_apply, device="cpu") as ex:
        ff, _ = ex.run(torch.zeros((BATCH, N_HIDDEN)), list(zip(x_groups, w1_groups)),
                       prefetch=SPEC, mode=mode, stats=st)
    with HostStreamExecutor(grad_apply, writeback=True, device="cpu") as ex:
        cg, outs = ex.run(torch.zeros(()), list(zip(x_groups, w1_groups,
                                                    [torch.from_numpy(dh)] * N_GROUPS)),
                          prefetch=SPEC, mode=mode, stats=st2)
    assert _counters(st) == _counters(jst)
    assert _counters(st2) == _counters(jst2)
    assert st.h2d_requests == st.n_groups == N_GROUPS
    np.testing.assert_allclose(ff.numpy(), jff, **F32_TOL)
    np.testing.assert_allclose(cg.numpy(), jcg, **F32_TOL)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), j, **F32_TOL)


def test_fig3_small_modes_bitwise_within_the_port():
    from repro_torch.benchmarks import common as C
    from repro_torch.benchmarks.offload_modes import run_modes

    cfg = C.LungNNConfig(n_pixels=N_PX, batch_images=BATCH)
    params = C.init_lung_nn(cfg, "cpu")
    xs, ys = C.make_images(cfg, BATCH, "cpu")
    rows, outs = run_modes(params, xs, ys, groups=N_GROUPS, device=CPU, repeats=1)
    base = outs["prefetch"]
    for mode in MODES:
        assert torch.equal(outs[mode]["ff"], base["ff"])
        assert torch.equal(outs[mode]["cg"], base["cg"])
        assert all(torch.equal(a, b) for a, b in zip(outs[mode]["cg_groups"], base["cg_groups"]))
    payload = (BATCH + N_HIDDEN) * (N_PX // N_GROUPS) * 4
    for r in rows:
        assert r["h2d_requests"] == r["cg_h2d_requests"] == N_GROUPS
        assert r["bytes_h2d"] == r["cg_bytes_h2d"] == payload * N_GROUPS


@pytest.mark.parametrize("distance", [1, 2, 4, AUTO])
def test_distances_bitwise_equal_eager(distance):
    rng = np.random.default_rng(10)
    groups = [(rng.standard_normal((8, 16)).astype(np.float32),
               rng.standard_normal((16, 8)).astype(np.float32)) for _ in range(10)]

    def apply(c, g):
        return c + g[0] @ g[1]

    with HostStreamExecutor(apply, device="cpu") as ex:
        base, _ = ex.run(torch.zeros(8, 8), groups, mode="eager")
        link = EngineConfig(link=LinkModel(request_s=1e-5, bandwidth_Bps=1e10, latency_s=2e-4))
        with HostStreamExecutor(apply, engine_config=link, device="cpu") as ex2:
            out, _ = ex2.run(torch.zeros(8, 8), groups, mode="prefetch",
                             prefetch=PrefetchSpec(buffer_size=5, distance=distance))
    assert torch.equal(out, base)


def test_failed_run_does_not_leak_writebacks_into_next_run():
    calls = {"n": 0}

    def apply(carry, g):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return carry, g * 2.0

    groups = [np.full((2,), float(i), np.float32) for i in range(4)]
    with HostStreamExecutor(apply, writeback=True, device="cpu") as ex:
        with pytest.raises(RuntimeError, match="injected"):
            ex.run(torch.zeros(()), groups)
        _, outs = ex.run(torch.zeros(()), groups)
    assert [o.tolist() for o in outs] == [[2.0 * i] * 2 for i in range(4)]


def test_blocking_writeback_schedule_matches_jax():
    rng = np.random.default_rng(11)
    groups = [{"a": rng.standard_normal(3).astype(np.float32),
               "b": rng.standard_normal(2).astype(np.float32)} for _ in range(4)]
    seed_j = jeng.EngineConfig(coalesce=False, async_writeback=False)
    seed_p = EngineConfig(coalesce=False, async_writeback=False)
    sj, sp = jhs.StreamStats(), StreamStats()
    with jhs.HostStreamExecutor(lambda c, g: (c, g), writeback=True, engine_config=seed_j) as ex:
        _, jouts = ex.run(jnp.zeros(()), groups, mode="on_demand", stats=sj)
    with HostStreamExecutor(lambda c, g: (c, g), writeback=True, engine_config=seed_p,
                            device="cpu") as ex:
        _, pouts = ex.run(torch.zeros(()), groups, mode="on_demand", stats=sp)
    assert _counters(sp) == _counters(sj)
    for j, p in zip(jouts, pouts):
        for k in j:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_stream_stats_reports_match_jax():
    rng = np.random.default_rng(12)
    groups = [rng.standard_normal(4).astype(np.float32) for _ in range(6)]
    sj, sp = jhs.StreamStats(), StreamStats()
    with jhs.HostStreamExecutor(lambda c, g: c + g.sum()) as ex:
        ex.run(jnp.zeros(()), groups, stats=sj)
    with HostStreamExecutor(lambda c, g: c + g.sum(), device="cpu") as ex:
        ex.run(torch.zeros(()), groups, stats=sp)
    jrow, prow = sj.as_row(), sp.as_row()
    assert prow.keys() == jrow.keys()
    assert json.loads(json.dumps(prow))["per_tier"]["h2d"]["requests"] == 6
    for tier in ("h2d", "d2h", "disk"):
        assert prow["per_tier"][tier].keys() == jrow["per_tier"][tier].keys()
        assert prow["per_tier"][tier]["requests"] == jrow["per_tier"][tier]["requests"]
    assert sum(sp.wait_hist().values()) == 6 and sp.wait_hist().keys() == sj.wait_hist().keys()
    sp.reset()
    assert sp.n_groups == 0 and sp.mode == "prefetch" and not sp.wait_per_group


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_leaves_pass_through_on_card(cuda):
    """A leaf already on the card costs no request and no byte, whether the
    engine was given ``None``, ``"cuda"`` or ``"cuda:0"``."""
    dev_leaf = torch.arange(6.0, device=cuda)
    group = {"host": np.ones((4, 4), np.float32), "dev": dev_leaf}
    for device in (None, "cuda", torch.device("cuda", torch.cuda.current_device())):
        with TransferEngine(device=device) as eng:
            fut = eng.submit_group(0, group)
            fut.wait()
            assert (fut.n_requests, fut.nbytes) == (1, 64)
            staged = fut.group()
            assert staged["dev"] is dev_leaf and staged["host"].is_cuda
            assert torch.equal(staged["host"].cpu(), torch.ones(4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_engine_on_card_agrees_with_the_cpu(cuda, lung_nn, mode):
    """Staging buffers recycled across groups never corrupt a copy in
    flight: one staging slot and the default pool give the same bits on
    the card, and those agree with the CPU run."""
    from repro_torch.benchmarks.offload_modes import SPEC, ff_apply

    x_groups, w1_groups, _ = lung_nn
    outs = {}
    for name, dev, slots in (("cpu", CPU, 2), ("cuda1", cuda, 1), ("cuda2", cuda, 2)):
        st = StreamStats()
        with HostStreamExecutor(ff_apply, device=dev,
                                engine_config=EngineConfig(staging_slots=slots)) as ex:
            outs[name], _ = ex.run(torch.zeros((BATCH, N_HIDDEN), device=dev),
                                   list(zip(x_groups, w1_groups)), prefetch=SPEC, mode=mode,
                                   stats=st)
        assert st.h2d_requests == N_GROUPS
    assert torch.equal(outs["cuda1"], outs["cuda2"])
    np.testing.assert_allclose(outs["cuda1"].cpu().numpy(), outs["cpu"].numpy(), **F32_TOL)
