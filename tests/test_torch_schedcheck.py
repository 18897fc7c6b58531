"""The port's schedule verifier and hazard sanitizer held against the JAX
package's.

The analyzers run over each package's plan of the same config: the reports
must be equal string for string, and ``verify_schedule`` must refuse the same
inputs.  The sanitizers take the same event sequences and must raise at the
same events.  The port's engine and pager pass transfer keys, so a sanitized
paged session decodes the unsanitized session's tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import schedcheck as jsc
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.core import schedcheck as sc
from repro_torch.core.arrays import BF16HostArray, host_array
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.train import steps as st


def _plans(arch="smollm-360m", **kw):
    pc, jc = get_smoke_config(arch), jax_get_smoke_config(arch)
    return (WeightStreamPlan(pc, st.abstract_params(pc), **kw),
            JaxPlan(jc, jax_steps.abstract_params(jc), **kw))


KV = dict(slots=2, page_len=4, hot_pages=1, page_nbytes=960, max_len=24)


@pytest.mark.parametrize("lpg", [1, 2])
@pytest.mark.parametrize("d", [0, 1, 2, 4])
@pytest.mark.parametrize("kv", [None, KV])
def test_serve_reports_equal_jax(lpg, d, kv):
    ours, theirs = _plans(layers_per_group=lpg)
    budgets = (None, ours.peak_device_bytes(1), ours.peak_device_bytes(2) + 5000, 10_000)
    for budget in budgets:
        for cached, cap in ((True, None), (True, 0), (True, 20_000), (False, None)):
            kw = dict(distance=d, cached=cached, cache_capacity=cap, budget_bytes=budget, kv=kv)
            a = sc.analyze_serve_schedule(ours, **kw)
            b = jsc.analyze_serve_schedule(theirs, **kw)
            assert str(a) == str(b)
            assert (a.ok, a.peak_bytes, len(a.violations)) == (b.ok, b.peak_bytes, len(b.violations))


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
@pytest.mark.parametrize("lpg", [1, 3])
@pytest.mark.parametrize("d", [1, 2])
def test_train_reports_equal_jax(arch, lpg, d):
    ours, theirs = _plans(arch, layers_per_group=lpg)
    for cached, cap in ((True, None), (True, 0), (True, 50_000), (False, None)):
        for budget in (None, ours.peak_device_bytes(1)):
            kw = dict(distance=d, cached=cached, cache_capacity=cap, budget_bytes=budget,
                      spill=True)
            a = sc.analyze_train_schedule(ours, **kw)
            b = jsc.analyze_train_schedule(theirs, **kw)
            assert str(a) == str(b)
            assert [dataclasses.astuple(p) for p in a.phases] == [
                dataclasses.astuple(p) for p in b.phases]


def test_exact_peak_equals_fast_path_on_the_port_plan():
    ours, _ = _plans(layers_per_group=1)
    for d in (1, 2, 4):
        rep = sc.analyze_train_schedule(ours, distance=d, cached=False)
        assert rep.ok
        assert max(p.peak_bytes for p in rep.phases[:2]) == ours.peak_device_bytes(d)


@pytest.mark.parametrize("case", ["budget", "kv_raw", "pins", "kv_budget"])
def test_verify_refuses_the_same_schedules(case):
    ours, theirs = _plans(layers_per_group=1)
    if case == "budget":
        run = lambda m, p: m.analyze_serve_schedule(p, distance=3, budget_bytes=p.peak_device_bytes(1))
    elif case == "kv_raw":
        run = lambda m, p: m.analyze_serve_schedule(p, distance=1, kv=KV, flush_demotions=False)
    elif case == "pins":
        run = lambda m, p: m.analyze_train_schedule(
            p, distance=1, cache_capacity=100, pin_keys=["g001_layers_000_001", "nope"])
    else:
        run = lambda m, p: m.analyze_serve_schedule(p, distance=1, budget_bytes=1000, kv=KV)
    a, b = run(sc, ours), run(jsc, theirs)
    assert not a.ok and str(a) == str(b)
    with pytest.raises(sc.ScheduleError) as exc:
        sc.verify_schedule(a)
    with pytest.raises(jsc.ScheduleError):
        jsc.verify_schedule(b)
    assert exc.value.report is a and str(exc.value) == str(b)
    assert [v.rule for v in a.violations] == [v.rule for v in b.violations]


@pytest.mark.parametrize("seed", range(6))
def test_sanitizer_raises_at_the_same_events(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = sc.HazardSanitizer(), jsc.HazardSanitizer()
    for _ in range(200):
        ev = rng.integers(5)
        key = [None, "g0", "g1", "kv/0/p00001"][rng.integers(4)]
        buf = int(rng.integers(3))
        from_pool = bool(rng.integers(2))
        drained = [key, key] if rng.random() < 0.5 else [key]
        outcomes = []
        for s, err in ((ours, sc.HazardError), (theirs, jsc.HazardError)):
            try:
                if ev == 0:
                    s.on_fetch(key)
                elif ev == 1:
                    s.on_writeback(key)
                elif ev == 2:
                    s.on_drained(drained)
                elif ev == 3:
                    s.on_staging_acquire(buf, from_pool=from_pool)
                else:
                    s.on_staging_release(buf)
                outcomes.append("ok")
            except err:
                outcomes.append("hazard")
        assert outcomes[0] == outcomes[1]
        assert (ours.checks, ours.hazards) == (theirs.checks, theirs.hazards)


def test_engine_refuses_a_fetch_behind_its_writeback():
    with TransferEngine(EngineConfig(sanitize=True), device="cpu") as eng:
        out = {"w": torch.ones(4)}
        eng.submit_writeback(0, out, key="g")
        with pytest.raises(sc.HazardError, match="writeback"):
            eng.submit_group(1, {"w": np.ones(4, np.float32)}, key="g")
        eng.drain_writebacks()
        fut = eng.submit_group(2, {"w": np.ones(4, np.float32)}, key="g")
        fut.wait()
        assert fut.key == "g" and eng.sanitizer.checks >= 2


def test_tree_fingerprint_reads_equal_bytes_equally():
    a = np.arange(100, dtype=np.float32)
    t = torch.arange(100, dtype=torch.float32)
    mark = lambda tree: [m[1:] for m in sc.tree_fingerprint(tree)]  # without the ids
    assert mark({"w": a}) == mark({"w": t}) == mark({"w": a.copy()})
    b = torch.arange(100, dtype=torch.float32).to(torch.bfloat16)
    hb = host_array(b)
    assert isinstance(hb, BF16HostArray)
    assert mark({"w": b}) == mark({"w": hb})
    assert mark({"w": a}) != mark({"w": a + 1})
    assert sc.tree_fingerprint({"w": a})[0][0] == id(a)


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "1", "yes", "TRUE"])
def test_sanitize_enabled_reads_the_env_like_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("REPRO_SANITIZE", value)
    assert sc.sanitize_enabled() == jsc.sanitize_enabled()
    assert EngineConfig().sanitize == sc.sanitize_enabled()


@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
def test_sanitized_paged_session_decodes_the_same_tokens(kv_kind):
    """The pager passes its page keys to the engine: demotions and readmits
    (an evicted request re-fetching its pages) pass the sanitizer."""
    from repro_torch.launch import serve as sv

    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32")
    params = st.init_params(cfg, 0, "cpu")
    prompts = np.random.default_rng(1).integers(1, 256, (3, 13), dtype=np.int32)
    runs = []
    for sanitize in (False, True):
        engine = TransferEngine(EngineConfig(sanitize=sanitize), device="cpu")
        with engine, sv.ServeSession(cfg, slots=2, max_len=32, kv_kind=kv_kind, page_len=4,
                                     params=params, engine=engine, device="cpu") as s:
            rids = [s.submit(p, 9) for p in prompts]
            s.admit_pending()
            s.step()
            s.step()
            s.evict(rids[0])
            s.step()
            s.readmit(rids[0])
            runs.append(s.run())
            if sanitize:
                assert engine.sanitizer.checks > 0 and engine.sanitizer.hazards == 0
    for rid in runs[0]:
        np.testing.assert_array_equal(runs[0][rid], runs[1][rid])
