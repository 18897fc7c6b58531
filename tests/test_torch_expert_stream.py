"""Route-aware expert streaming held against the JAX package's, on the CPU.

The expert-split weight-stream plan (``expert_stream=True``: per layer a
non-expert group of attention, norms and router, then one group per
expert), the schedule analyzer's reports on it, and serving with the
experts homed at pinned host or disk: the JAX package's serve and
``ServeSession`` run the f32 smoke configs (mixtral-8x7b with 8 experts
top-2, unpaged; qwen3-moe-235b with 8 experts top-2, paged) on its own
weights, the port the same weights converted and the same prompts.  Plan,
analyzer and expert-traffic integers must be equal, and the greedy tokens.
Inside the port, routed, all-expert and device-resident runs give the same
bits at every home.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import schedcheck as jax_sc
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.train import steps as jax_steps
from repro_torch.benchmarks import weight_stream as bench
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import home_from_numpy, params_from_numpy
from repro_torch.core import schedcheck as sc
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.engine import TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.weightstream import WeightStreamPlan, merge_expert_slice
from repro_torch.launch import serve as sv
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as st

SEED = 7
ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
EXPERT_COUNTERS = ("n_transfers", "n_groups", "h2d_requests", "bytes_h2d", "disk_requests",
                   "bytes_disk", "unique_group_fetches", "cache_hits", "cache_misses",
                   "fetched_device_groups")


def _cfgs(arch, **kw):
    """(port config, JAX config): the f32 smoke config with 8 experts."""
    kw = {"dtype": "float32", "attn_impl": "pallas", "n_experts": 8, **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def _bits(x) -> np.ndarray:
    return host_tensor(x).detach().contiguous().view(torch.uint8).numpy()


def _same_tree(a, b) -> None:
    la, lb = tr.leaves(a), tr.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


@pytest.fixture(scope="module", params=ARCHS)
def jax_init(request):
    """(arch, the JAX package's f32 smoke weights as numpy)."""
    _, jc = _cfgs(request.param)
    p = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    return request.param, jax.tree.map(np.asarray, p)


# ---------------------------------------------------------------------------
# the expert plan
# ---------------------------------------------------------------------------


def _expert_integers(plan) -> dict:
    return {
        "groups": [dataclasses.astuple(g) for g in plan.groups],
        "units": [dataclasses.astuple(u) for u in plan.units],
        "fetch": plan.fetch_sequence_bytes(),
        "peaks": [plan.peak_device_bytes(d) for d in range(5)],
        "max_d": [plan.max_distance_for_budget(cap) for cap in (2, 8)],
        "capacity": plan.residency_capacity_bytes(),
        "experts": (plan.expert_names, plan.per_expert_bytes, plan.nonexpert_layer_bytes,
                    plan.layers_per_group, plan.n_groups, plan.total_param_bytes),
        "expert_groups": [g.key for g in plan.expert_groups],
        "by_layer": [[g.key for g in plan.experts_for_layer(lo)] for lo in range(plan.n_layers)],
        "home_bytes": [plan.group_bytes(g, fetch=False) for g in plan.groups],
    }


def _plans(pc, jc, **kw):
    out = []
    for cls, c, abstract in ((WeightStreamPlan, pc, st.abstract_params),
                             (JaxPlan, jc, jax_steps.abstract_params)):
        try:
            out.append(cls(c, abstract(c), expert_stream=True, **kw))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_expert_plan_integers_equal_jax(arch, full):
    pc = get_config(arch) if full else get_smoke_config(arch)
    jc = jax_get_config(arch) if full else jax_smoke(arch)
    free, _ = _plans(pc, jc)
    floor = free.peak_device_bytes(1)
    for budget in (None, floor / 1e6 * 0.99, floor / 1e6, floor / 1e6 * 1.3, floor / 1e6 * 3):
        ours, theirs = _plans(pc, jc, device_budget_mb=budget)
        if isinstance(theirs, str):
            assert ours == theirs  # the floor's message, word for word
            continue
        assert _expert_integers(ours) == _expert_integers(theirs), budget


def test_mixtral_full_width_expert_plan():
    """The full-width cell's integers: 46.70 B parameters (the config's
    count leaves out the norms' 266,240), 93,405,585,408 bytes in bf16;
    83,968,000 bytes a non-expert group, 352,321,536 an expert; a distance-1
    floor of three MoE units (8,707,620,864 bytes)."""
    cfg = get_config("mixtral-8x7b")
    assert cfg.param_count()[0] == 46_702_526_464 == 93_405_585_408 // 2 - 266_240
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), expert_stream=True,
                            device_budget_mb=9000)
    assert plan.total_param_bytes == 93_405_585_408
    assert (plan.nonexpert_layer_bytes, plan.per_expert_bytes) == (83_968_000, 352_321_536)
    assert plan.n_groups == 2 + 32 * 9 and plan.layers_per_group == 1
    assert plan.peak_device_bytes(1) == 8_707_620_864
    assert plan.max_distance_for_budget() == 1
    assert plan.residency_capacity_bytes() == 292_379_136 < plan.per_expert_bytes


def test_expert_stream_guards_equal_jax():
    for arch, match in (("smollm-360m", "requires an MoE config"),
                        ("recurrentgemma-2b", "needs the uniform layout")):
        pc, jc = get_smoke_config(arch), jax_smoke(arch)
        ours, theirs = _plans(pc, jc)
        assert ours == theirs and match in ours


def test_expert_home_and_merge_equal_jax(jax_init):
    """``init_home`` of the converted weights is the JAX package's expert
    home leaf for leaf; ``assemble`` restacks it, and ``merge_expert_slice``
    rebuilds each layer's slice bitwise."""
    arch, jp = jax_init
    pc, jc = _cfgs(arch)
    params = params_from_numpy(jp, pc, "cpu")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), expert_stream=True)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), expert_stream=True)
    home = plan.init_home(params)
    jhome = home_from_numpy(jplan.init_home(jp))
    assert home["groups"].keys() == jhome["groups"].keys()
    for key in home["groups"]:
        _same_tree(home["groups"][key], jhome["groups"][key])
    _same_tree(plan.assemble(home), params.as_dict())
    blocks = params.as_dict()["blocks"]
    for u in plan.units:
        parts = [tr.tree_map(torch.from_numpy, home["groups"][plan.groups[i].key])
                 for i in u.gidx]
        merged = merge_expert_slice(parts[0], parts[1:])
        _same_tree(merged, tr.tree_map(lambda a: a[u.lo:u.hi], blocks))


@pytest.mark.parametrize("arch", ARCHS)
def test_groupwise_init_is_the_device_init(arch):
    """The expert-split group-wise init (one layer's f32 slice at a time)
    gives ``init_home`` of the whole model's init, bitwise."""
    pc, _ = _cfgs(arch, dtype="bfloat16")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), expert_stream=True)
    ref = plan.init_home(st.init_params(pc, 3, "cpu"))
    home = st.init_weight_streamed_params(pc, plan, 3, "cpu")
    assert home["groups"].keys() == ref["groups"].keys()
    for key in ref["groups"]:
        _same_tree(home["groups"][key], ref["groups"][key])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", [True, False])
def test_analyzer_reports_equal_jax(arch, route):
    pc, jc = get_smoke_config(arch), jax_smoke(arch)
    free, _ = _plans(pc, jc)
    for budget in (None, free.peak_device_bytes(2) / 1e6):
        ours, theirs = _plans(pc, jc, device_budget_mb=budget)
        for d in (1, 2):
            cap = ours.residency_capacity_bytes()
            for fan in (None, 3):
                kw = dict(distance=d, cache_capacity=cap, route_experts=route, fan_in=fan)
                a, b = sc.analyze_serve_schedule(ours, **kw), jax_sc.analyze_serve_schedule(theirs, **kw)
                assert str(a) == str(b) and a.ok == b.ok
            kw = dict(distance=d, cache_capacity=cap, spill=True)
            a, b = sc.analyze_train_schedule(ours, **kw), jax_sc.analyze_train_schedule(theirs, **kw)
            assert str(a) == str(b) and a.ok == b.ok


def test_schedule_sweep_passes():
    """The sweep over every supported smoke config x layout x expert_stream
    (``python -m repro_torch.core.schedcheck``) finds no violation."""
    assert sc._sweep() == 0


# ---------------------------------------------------------------------------
# the streamed serve steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("distance, cached", [(0, False), (1, True), ("auto", False)])
def test_streamed_steps_are_the_monolithic_bits(arch, distance, cached):
    """The expert-split prefill (each layer merged from its groups) and the
    routed decode give the device-resident steps' bits, with and without a
    cache; the decode fetches only the routed experts, one request each."""
    pc, _ = _cfgs(arch, dtype="bfloat16", attn_type="full")
    params = st.init_params(pc, 1, "cpu")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), expert_stream=True)
    home = plan.init_home(params)
    stats, es = StreamStats(), StreamStats()
    kw = dict(engine=TransferEngine(device="cpu"), stats=stats,
              prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=distance),
              residency=ResidencyCache(None) if cached else None)
    batch, seq = 2, 20
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, pc.vocab_size, (batch, 9)))
    logits, caches = st.make_weight_streamed_prefill_step(pc, plan, batch, seq, **kw)(
        home, {"tokens": toks})
    ref_logits, ref_caches = st.make_prefill_step(pc, batch, seq)(params, {"tokens": toks})
    assert torch.equal(logits, ref_logits)
    decode = st.make_weight_streamed_decode_step(pc, plan, paged=False, expert_stats=es, **kw)
    alle = st.make_weight_streamed_decode_step(pc, plan, paged=False, route_experts=False,
                                               **{**kw, "stats": StreamStats()})
    mono = st.make_decode_step(pc)
    all_caches = st.clone_caches(caches)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(3):
        pos = torch.full((batch,), 9 + i, dtype=torch.int32)
        logits, caches = decode(home, caches, {"tokens": tok}, pos)
        a_logits, all_caches = alle(home, all_caches, {"tokens": tok}, pos)
        ref_logits, ref_caches = mono(params, ref_caches, {"tokens": tok}, pos)
        assert torch.equal(logits, ref_logits) and torch.equal(a_logits, ref_logits)
        tok = logits[:, -1].argmax(-1)[:, None]
    for k in ref_caches:
        assert torch.equal(caches[k], ref_caches[k]) and torch.equal(all_caches[k], ref_caches[k])
    every = 3 * pc.n_layers * pc.n_experts  # the all-expert decode's submits
    aes = alle.expert_stats
    assert decode.expert_stats is es and aes.unique_group_fetches + aes.cache_hits == every
    for s in (es, aes):
        assert s.h2d_requests == s.unique_group_fetches
        assert s.bytes_h2d == s.unique_group_fetches * plan.per_expert_bytes
    if not cached:
        assert 0 < es.unique_group_fetches < every and es.cache_hits == 0
        assert es.per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0
    else:  # the prefill left every expert resident
        assert es.unique_group_fetches == aes.unique_group_fetches == 0


# ---------------------------------------------------------------------------
# serving against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mixtral_serve(mesh):
    """The JAX package's unpaged mixtral serves: device, routed, all-expert."""
    _, jc = _cfgs("mixtral-8x7b")
    kw = dict(batch=2, prompt_len=8, gen=6, kv_page_len=0, seed=SEED, warmup=False)
    out = {"device": jax_serve.serve(jc, mesh, **kw)}
    for name, route in (("routed", True), ("all", False)):
        out[name] = jax_serve.serve(jc, mesh, **kw, param_kind="pinned_host", expert_stream=True,
                                    route_experts=route, param_cache_mb=0)
    return out


@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_mixtral_serve_equals_jax(jax_mixtral_serve, kind):
    """The JAX package's weights and prompts through the port's serve loop:
    the device run's tokens equal the JAX package's; the routed and the
    all-expert runs give the device run's tokens and the JAX package's
    expert traffic, integer for integer."""
    pc, jc = _cfgs("mixtral-8x7b")
    jp = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jp), pc, "cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (2, 8), 1,
                                            jc.vocab_size), np.int32)
    run = lambda **kw: sv.serve_loop(pc, params, prompts, 6, device=torch.device("cpu"),
                                     warmup=False, **kw)
    base = run()
    np.testing.assert_array_equal(base["generated"], jax_mixtral_serve["device"]["generated"])
    for name, route in (("routed", True), ("all", False)):
        res = run(param_kind=kind, expert_stream=True, route_experts=route, param_cache_mb=0.0)
        ref = jax_mixtral_serve[name]
        np.testing.assert_array_equal(res["generated"], base["generated"])
        assert res["expert_decode_bytes"] == ref["expert_decode_bytes"] > 0
        assert res["expert_decode_fetches"] == ref["expert_decode_fetches"]
        for c in EXPERT_COUNTERS:
            if c not in ("disk_requests", "bytes_disk"):
                assert getattr(res["expert_stats"], c) == getattr(ref["expert_stats"], c), c
        assert res["expert_stats"].per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0
        if kind == "disk_host":
            assert res["expert_stats"].disk_requests == res["expert_stats"].unique_group_fetches
    routed = run(param_kind=kind, expert_stream=True, param_cache_mb=0.0)["expert_decode_bytes"]
    assert 2 * routed <= jax_mixtral_serve["all"]["expert_decode_bytes"]


def test_expert_lru_turns_refetches_into_hits():
    """An unbounded cache keeps the routed experts on the card: resident
    hits at zero link bytes, the same tokens (the JAX package's check)."""
    pc, _ = _cfgs("mixtral-8x7b", dtype="bfloat16")
    kw = dict(batch=2, prompt_len=8, gen=5, kv_page_len=0, seed=SEED, warmup=False, device="cpu")
    base = sv.serve(pc, **kw)
    routed = sv.serve(pc, **kw, param_kind="pinned_host", expert_stream=True, param_cache_mb=0)
    cached = sv.serve(pc, **kw, param_kind="pinned_host", expert_stream=True)
    for r in (routed, cached):
        np.testing.assert_array_equal(r["generated"], base["generated"])
    assert cached["expert_stats"].cache_hits > 0
    assert cached["expert_decode_bytes"] < routed["expert_decode_bytes"]


def test_mixtral_decodes_past_its_window_like_jax():
    """A smoke mixtral (window 16) prefills 13 tokens and decodes 8 steps
    through its ring, which wraps: logits and caches equal the JAX
    package's."""
    from repro.models import transformer as jax_tf
    from repro_torch.models import transformer

    pc, jc = _cfgs("mixtral-8x7b", attn_impl="xla")
    jp = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jp), pc, "cpu")
    toks = np.random.default_rng(3).integers(1, pc.vocab_size, (2, 13), dtype=np.int32)
    jcaches = jax_tf.init_caches(jc, 2, 24, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, jp, {"tokens": jax.numpy.asarray(toks)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, 2, 24, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"tokens": torch.from_numpy(toks).long()},
                                         caches)
    assert tuple(caches["slot_pos"].shape) == (pc.n_layers, 16)
    for i in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-3)
        nxt = np.asarray(jax.numpy.argmax(jl[:, -1], axis=-1), np.int32)
        jl, jcaches = jax_tf.decode_step(jc, jp, {"tokens": jax.numpy.asarray(nxt[:, None])},
                                         jcaches, jax.numpy.asarray(13 + i, jax.numpy.int32))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, {"tokens": torch.tensor(nxt[:, None])},
                                                 caches, torch.tensor(13 + i, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-3)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(np.asarray(caches[name].float()),
                                   np.asarray(jcaches[name], np.float32), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
def test_paged_qwen3_session_equals_jax(mesh, kv_kind):
    """qwen3-moe (full attention: its cache pages) through the paged
    ``ServeSession`` with the experts routed from pinned host: the JAX
    session's tokens and expert traffic; the port's device-resident session's
    tokens."""
    pc, jc = _cfgs("qwen3-moe-235b-a22b")
    jp = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jp), pc, "cpu")
    prompts = np.random.default_rng(0).integers(1, 256, (3, 9), dtype=np.int32)
    kw = dict(slots=2, max_len=16, kv_kind=kv_kind, page_len=4, seed=SEED)
    stream = dict(param_kind="pinned_host", expert_stream=True, param_cache_mb=0.0)
    out = {}
    for name, s in (("device", sv.ServeSession(pc, params=params, device="cpu", **kw)),
                    ("routed", sv.ServeSession(pc, params=params, device="cpu", **kw, **stream)),
                    ("jax", jax_serve.ServeSession(jc, mesh, **kw, **stream))):
        with s:
            rids = [s.submit(p, 5) for p in prompts]
            res = s.run()
            out[name] = ([res[r] for r in rids], s.expert_stats)
    for a, b, c in zip(out["device"][0], out["routed"][0], out["jax"][0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    es, jes = out["routed"][1], out["jax"][1]
    for c in EXPERT_COUNTERS:
        if c not in ("disk_requests", "bytes_disk"):
            assert getattr(es, c) == getattr(jes, c), c
    assert es.per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0
    assert out["device"][1] is None


def test_session_refuses_expert_stream_of_device_weights():
    pc, _ = _cfgs("qwen3-moe-235b-a22b")
    with pytest.raises(ValueError, match="requires --param-kind pinned_host or disk_host"):
        sv.ServeSession(pc, slots=1, max_len=8, page_len=4, expert_stream=True, device="cpu")


def test_cli_serves_routed_experts(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "8", "--gen", "3", "--kv-page-len", "0", "--param-kind", "pinned_host",
        "--expert-stream", "--verify-schedule"])
    assert sv.main() == 0
    out = capsys.readouterr().out
    assert "experts:" in out and "schedule[serve]" in out and "expert fan-in" in out


def test_bench_expert_gates_pass_on_cpu():
    rows, ok, summary = bench.expert_gates(torch.device("cpu"))
    assert all(ok.values()), summary
    assert {r["route_experts"] for r in rows} == {True, False}
