"""The port's serve front end and copy-on-write prefix sharing held against
the JAX package's.

The load generator's traces and the SLO scheduler's virtual-clock reports
must equal the JAX package's field by field; prefix sharing must be bitwise
invisible with the JAX package's counters, and its refcounts and spill-chunk
deletions must leave the same directory listings.
"""
import dataclasses
import os
import time

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.serve import SLO as JaxSLO
from repro.serve import LoadGenConfig as JaxLoadGenConfig
from repro.serve import OfferedRequest as JaxOfferedRequest
from repro.serve import Phase as JaxPhase
from repro.serve import SLOScheduler as JaxSLOScheduler
from repro.serve import generate as jax_generate
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.kvpager import shared_prefix_keys
from repro_torch.launch import serve as sv
from repro_torch.serve import SLO, LoadGenConfig, OfferedRequest, Phase, SLOScheduler, generate

SEED = 5


def _cfgs():
    jc = dataclasses.replace(jax_get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    pc = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    return jc, pc


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


@pytest.fixture(scope="module")
def params():
    jc, pc = _cfgs()
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    return params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")


def _trace(phase_cls, cfg_cls, **kw):
    base = dict(
        seed=5,
        phases=(phase_cls(1.0, 4.0), phase_cls(0.25, 16.0)),
        prompt_lens=(8, 12, 20),
        prompt_mix=(0.5, 0.3, 0.2),
        gen_lens=(2, 4),
        gen_mix=(0.5, 0.5),
        shared_prefix_len=8,
        shared_frac=0.5,
        vocab_size=64,
    )
    base.update(kw)
    return cfg_cls(**base)


def _both_traces(**kw):
    return (generate(_trace(Phase, LoadGenConfig, **kw)),
            jax_generate(_trace(JaxPhase, JaxLoadGenConfig, **kw)))


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def _same_trace(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.arrival_s, a.gen, a.shared) == (b.arrival_s, b.gen, b.shared)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("kw", [dict(), dict(seed=11), dict(seed=3, shared_prefix_len=0),
                                dict(seed=9, shared_frac=1.0, prompt_lens=(4, 8, 64))])
def test_loadgen_trace_equals_jax(kw):
    _same_trace(*_both_traces(**kw))


def test_default_loadgen_trace_equals_jax():
    """The defaults' bursty phases (4 s at 2/s, 1 s at 8/s, 4 s at 2/s)."""
    kw = dict(seed=1, shared_prefix_len=8)
    _same_trace(generate(LoadGenConfig(**kw)), jax_generate(JaxLoadGenConfig(**kw)))


def test_loadgen_dataclasses_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    for ours, theirs in ((Phase, JaxPhase), (LoadGenConfig, JaxLoadGenConfig),
                         (OfferedRequest, JaxOfferedRequest), (SLO, JaxSLO)):
        assert names(ours) == names(theirs)
    assert dataclasses.asdict(LoadGenConfig()) == dataclasses.asdict(JaxLoadGenConfig())


@pytest.mark.parametrize("bad, match", [(lambda: Phase(0.0, 1.0), "duration_s"),
                                        (lambda: Phase(1.0, -1.0), "rate_rps"),
                                        (lambda: LoadGenConfig(prompt_mix=(1.0,)), "align"),
                                        (lambda: LoadGenConfig(shared_frac=1.5), "shared_frac")])
def test_loadgen_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


# ---------------------------------------------------------------------------
# the SLO scheduler
# ---------------------------------------------------------------------------

def _scrub(rep):
    """The report without its wall-clock transfer waits, the one real-time
    residue under the virtual clock."""
    rep = dict(rep)
    rep["per_tier"] = {t: {k: v for k, v in d.items() if k != "wait_s"}
                       for t, d in rep["per_tier"].items()}
    return rep


def _both_reports(mesh, params, slo, offered=None, jax_offered=None, **kw):
    jc, pc = _cfgs()
    skw = dict(slots=2, max_len=32, kv_kind="pinned_host", page_len=4, hot_pages=1, seed=SEED)
    with sv.ServeSession(pc, params=params, device="cpu", **skw) as s:
        ours = SLOScheduler(s, offered or generate(_trace(Phase, LoadGenConfig)),
                            slo=SLO(*slo), **kw).run()
    with jax_serve.ServeSession(jc, mesh, **skw) as s:
        theirs = JaxSLOScheduler(s, jax_offered or jax_generate(_trace(JaxPhase, JaxLoadGenConfig)),
                                 slo=JaxSLO(*slo), **kw).run()
    return ours, theirs


def test_scheduler_report_equals_jax(mesh, params):
    """Virtual clock, seeded trace: the report is the JAX package's, field by
    field, and a second run reproduces it."""
    ours, theirs = _both_reports(mesh, params, (0.2, 0.05), max_queue=8, virtual_step_s=0.01)
    assert _scrub(ours) == _scrub(theirs)
    again, _ = _both_reports(mesh, params, (0.2, 0.05), max_queue=8, virtual_step_s=0.01)
    assert _scrub(again) == _scrub(ours)
    assert ours["completed"] == ours["submitted"] > 0 and ours["emitted_tokens"] > 0


@pytest.mark.parametrize("slo, attained", [((0.0, 0.0), 0.0), ((1e9, 1e9), 1.0)])
def test_scheduler_goodput_counts_only_slo_attaining(mesh, params, slo, attained):
    ours, theirs = _both_reports(mesh, params, slo, virtual_step_s=0.01)
    assert _scrub(ours) == _scrub(theirs)
    assert ours["completed"] > 0 and ours["slo_attainment"] == attained
    assert (ours["goodput_rps"] > 0.0) == (attained > 0)


def test_scheduler_sheds_overload_and_counts_oversize(mesh, params):
    def offered(phase, cfg, req):
        big = req(arrival_s=0.0, prompt=np.arange(1, 40, dtype=np.int32), gen=4, shared=False)
        gen_fn = generate if phase is Phase else jax_generate
        trace = gen_fn(_trace(phase, cfg, phases=(phase(0.2, 60.0),)))
        return list(trace) + [big]

    ours, theirs = _both_reports(mesh, params, (0.5, 0.1),
                                 offered=offered(Phase, LoadGenConfig, OfferedRequest),
                                 jax_offered=offered(JaxPhase, JaxLoadGenConfig, JaxOfferedRequest),
                                 max_queue=1, virtual_step_s=0.01)
    assert _scrub(ours) == _scrub(theirs)
    assert ours["rejected_overload"] > 0 and ours["rejected_oversize"] == 1
    assert ours["offered"] == ours["completed"] + ours["rejected_oversize"] + ours["rejected_overload"]


def _port_run(params, offered, step_sleep_s=0.0, **kw):
    """The port's report, latency records and tokens over ``offered``; each
    step first sleeps ``step_sleep_s``."""
    _, pc = _cfgs()
    with sv.ServeSession(pc, slots=2, max_len=32, kv_kind="pinned_host", page_len=4, hot_pages=1,
                         params=params, device="cpu") as s:
        real_step = s.step
        s.step = lambda: (time.sleep(step_sleep_s), real_step())[1]
        sched = SLOScheduler(s, offered, slo=SLO(0.5, 0.1), **kw)
        rep = sched.run()
        return rep, sched.tracked, {rid: r.emitted for rid, r in s.requests.items()}


def test_scheduler_first_phase_is_independent_of_later_arrivals(params):
    """Under the virtual clock a request's stamps and tokens depend only on
    the requests that arrived before it, so the trace cut to its first phase
    gives the first phase's requests what the whole trace gives them."""
    cfg = _trace(Phase, LoadGenConfig)
    offered = generate(cfg)
    first = [o for o in offered if o.arrival_s < cfg.phases[0].duration_s]
    assert 0 < len(first) < len(offered)
    _, tracked, tokens = _port_run(params, offered, virtual_step_s=0.01)
    _, tracked1, tokens1 = _port_run(params, first, virtual_step_s=0.01)
    assert sorted(tracked1) == list(range(len(first)))
    for rid in tracked1:
        assert tracked1[rid] == tracked[rid] and tokens1[rid] == tokens[rid]


STEP_SLEEP_S = 0.05


def test_scheduler_wall_clock_stamps_after_the_step(params):
    """Under the wall clock a token is stamped once the step that emitted it
    has returned, so TTFT and TPOT hold each step's own time."""
    offered = [OfferedRequest(arrival_s=0.0, prompt=np.arange(1, 9, dtype=np.int32), gen=4,
                              shared=False)]
    rep, tracked, _ = _port_run(params, offered, virtual_step_s=None, step_sleep_s=STEP_SLEEP_S)
    assert rep["completed"] == 1 and tracked[0].n_emitted == 4
    assert rep["ttft_s"]["p50"] >= STEP_SLEEP_S and rep["tpot_s"]["p50"] >= STEP_SLEEP_S


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing
# ---------------------------------------------------------------------------

COUNTERS = ("n_groups", "h2d_requests", "d2h_requests", "bytes_h2d", "bytes_d2h", "disk_requests",
            "unique_group_fetches", "shared_hits")


def _session_run(session, prompts, gen):
    with session as s:
        rids = [s.submit(p, gen) for p in prompts]
        out = s.run()
        acc = {n: getattr(s.stats, n) for n in COUNTERS}
        acc.update(skipped=s.pager.shared_skipped_writebacks, demoted=s.pager.demoted_groups)
        return np.stack([out[r] for r in rids]), acc


@pytest.mark.parametrize("page_len", [4, 8])
@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
def test_prefix_sharing_bitwise_equals_unshared(mesh, params, kv_kind, page_len):
    """Sharing changes no token, and its counters are the JAX package's with
    and without it."""
    jc, pc = _cfgs()
    prompts = np.random.default_rng(9).integers(1, 256, (3, 24), dtype=np.int32)
    prompts[:, :16] = prompts[0, :16]
    kw = dict(slots=3, max_len=30, kv_kind=kv_kind, page_len=page_len, hot_pages=1, seed=SEED)
    runs = {}
    for sharing in (True, False):
        ours = _session_run(sv.ServeSession(pc, params=params, device="cpu", prefix_sharing=sharing,
                                            **kw), prompts, 6)
        theirs = _session_run(jax_serve.ServeSession(jc, mesh, prefix_sharing=sharing, **kw),
                              prompts, 6)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
        runs[sharing] = ours
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    on, off = runs[True][1], runs[False][1]
    assert on["shared_hits"] > 0 and off["shared_hits"] == 0
    assert on["unique_group_fetches"] < off["unique_group_fetches"]
    if kv_kind == "disk_host":
        assert on["disk_requests"] < off["disk_requests"]


def test_prefix_sharing_lifecycle_leaves_the_jax_listing(mesh, params, tmp_path):
    """Refcounts drop once per retiring sharer, a shared chunk is deleted at
    its last reference only, and after every step the spill directory lists
    the JAX package's chunk files."""
    jc, pc = _cfgs()
    head = np.arange(1, 17, dtype=np.int32)
    shared_keys = set(shared_prefix_keys(head, 4))
    prompts = [np.concatenate([head, np.arange(40 + 10 * i, 44 + 10 * i, dtype=np.int32)])
               for i in range(3)]
    gens = [2, 5, 9]  # staggered: sharers retire one at a time
    kw = dict(slots=3, max_len=32, kv_kind="disk_host", page_len=4, hot_pages=1, seed=SEED)
    ours = sv.ServeSession(pc, params=params, device="cpu", spill_dir=str(tmp_path / "torch"), **kw)
    theirs = jax_serve.ServeSession(jc, mesh, spill_dir=str(tmp_path / "jax"), **kw)
    deleted = []
    with ours, theirs:
        real_delete = ours._store.delete
        ours._store.delete = lambda key: (deleted.append(key), real_delete(key))[1]
        for s in (ours, theirs):
            for p, g in zip(prompts, gens):
                s.submit(p, g)
            s.admit_pending()
        listing = lambda s: sorted(f for f in os.listdir(s._store.dir) if f.endswith(".bin"))
        assert listing(ours) == listing(theirs) != []
        assert ours.pager.shared_refs() == theirs.pager.shared_refs() > 0
        refs = []
        while ours.pending_work() or theirs.pending_work():
            ours.step()
            theirs.step()
            assert listing(ours) == listing(theirs)
            assert ours.pager.shared_refs() == theirs.pager.shared_refs()
            refs.append(ours.pager.shared_refs())
            if len(ours.pager.tables) > 0:
                # a sharer is still decoding: no shared chunk was deleted
                assert not set(deleted) & shared_keys
        assert refs == sorted(refs, reverse=True) and refs[-1] == 0
        assert ours.pager.shared_pages() == 0 and listing(ours) == []
        spilled = [k for k in deleted if k in shared_keys]
        assert spilled and len(spilled) == len(set(spilled))  # once each
        assert not ours.pager.stream._owner and not ours.pager.stream._staged


@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
def test_evict_readmit_with_prefix_sharing_bitwise(params, kv_kind):
    _, pc = _cfgs()
    head = np.arange(1, 13, dtype=np.int32)
    prompts = [np.concatenate([head, np.arange(t, t + 4, dtype=np.int32)]) for t in (40, 60)]

    def run(interrupt):
        with sv.ServeSession(pc, slots=2, max_len=32, kv_kind=kv_kind, page_len=4, hot_pages=1,
                             params=params, device="cpu") as s:
            rid = s.submit(prompts[0], 10)
            s.submit(prompts[1], 12)
            s.admit_pending()
            assert s.pager.shared_refs() > 0
            for _ in range(3):
                s.step()
            if interrupt:
                s.evict(rid)
                s.step()
                s.readmit(rid)
            while s.pending_work():
                s.step()
            return np.asarray(s.requests[rid].emitted, np.int32)

    np.testing.assert_array_equal(run(True), run(False))
