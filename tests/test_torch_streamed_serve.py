"""Streamed-weight serving held against the JAX package's, and against the
port's own device-resident path.

On the CPU, the f32 smoke config with ``attn_impl="pallas"`` (the plain
versions here), the JAX package's weights converted:

* the streamed prefill and decode steps equal the monolithic ones bitwise
  (logits and caches);
* ``serve`` (unpaged) and ``ServeSession`` (paged) with the weights at
  ``pinned_host`` and ``disk_host`` give the JAX package's tokens, weight
  stream counters, residency counters and schedule reports, and the same
  ``params/`` spill listing;
* refused combinations leak no thread and no spill directory.

The ``cuda`` tests run smollm-360m's full widths, cut to 4 layers, through
the CUDA kernels on the card (``chip_smoke.py`` phase 2w runs all 32).
"""
import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import home_from_numpy, params_from_numpy
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.core import tree as tr
from repro_torch.launch import serve as sv
from repro_torch.models import moe, transformer
from repro_torch.train import steps as st

SEED = 7
CPU = torch.device("cpu")
COUNTERS = ("n_groups", "n_runs", "h2d_requests", "bytes_h2d", "disk_requests", "bytes_disk",
            "unique_group_fetches", "cache_hits", "cache_misses", "peak_inflight_bytes")


def _cfgs():
    jc = dataclasses.replace(jax_get_smoke_config("smollm-360m"), dtype="float32",
                             attn_impl="pallas")
    pc = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    return jc, pc


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs()
    return jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0])


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jparams, _cfgs()[1], "cpu")


def _counters(stats) -> dict:
    return {n: getattr(stats, n) for n in COUNTERS}


# ---------------------------------------------------------------------------
# streamed steps against the monolithic ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lpg", [1, 2])
@pytest.mark.parametrize("distance", [0, 1, "auto"])
@pytest.mark.parametrize("cached", [False, True])
def test_streamed_prefill_decode_match_monolithic(params, lpg, distance, cached):
    _, cfg = _cfgs()
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=lpg)
    home = plan.init_home(params)
    stats = StreamStats()
    kw = dict(engine=TransferEngine(device="cpu"), stats=stats,
              prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=distance),
              residency=ResidencyCache(None) if cached else None)
    batch, seq = 2, 24
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, 256, (batch, 11)))
    prefill = st.make_weight_streamed_prefill_step(cfg, plan, batch, seq, **kw)
    logits, caches = prefill(home, {"tokens": tokens}, 7)
    ref_logits, ref_caches = st.make_prefill_step(cfg, batch, seq)(params, {"tokens": tokens}, 7)
    assert torch.equal(logits, ref_logits)
    for k in ref_caches:
        assert torch.equal(caches[k], ref_caches[k])
    decode = st.make_weight_streamed_decode_step(cfg, plan, paged=False, **kw)
    mono = st.make_decode_step(cfg)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(3):
        pos = torch.full((batch,), 11 + i, dtype=torch.int32)
        logits, caches = decode(home, caches, {"tokens": tok}, pos)
        ref_logits, ref_caches = mono(params, ref_caches, {"tokens": tok}, pos)
        assert torch.equal(logits, ref_logits)
        for k in ref_caches:
            assert torch.equal(caches[k], ref_caches[k])
        tok = logits[:, -1].argmax(-1)[:, None]
    assert stats.n_runs == 4 and stats.h2d_requests == stats.unique_group_fetches
    if cached:  # everything resident after the first pass
        assert stats.unique_group_fetches == plan.n_groups


def test_group_stages_are_the_monolithic_layer_body(params):
    """One group's stage over narrowed cache views writes the same caches,
    in place, as the monolithic pass over the whole stack."""
    _, cfg = _cfgs()
    tokens = torch.arange(1, 10)[None]
    caches = transformer.init_caches(cfg, 1, 16, cfg.compute_dtype, CPU)
    x = transformer.embed_stage(cfg, params.as_dict(), {"tokens": tokens})
    angles = transformer.stage_angles(cfg, {"tokens": tokens}, 9)
    blocks = params.as_dict()["blocks"]
    view = {k: v.narrow(0, 0, cfg.n_layers) for k, v in caches.items()}
    x, out = transformer.block_group_prefill(cfg, blocks, view, x, angles)
    assert out is view and view["k"].data_ptr() == caches["k"].data_ptr()
    ref = transformer.init_caches(cfg, 1, 16, cfg.compute_dtype, CPU)
    logits, _ = transformer.prefill(cfg, params, {"tokens": tokens}, ref)
    assert torch.equal(transformer.head_stage_logits(cfg, params.as_dict(), x[:, -1:]), logits)
    assert all(torch.equal(caches[k], ref[k]) for k in ref)
    one = transformer.init_cache_group(cfg, 3, 2, 16, cfg.compute_dtype, CPU)
    assert one["k"].shape == (3, 2) + tuple(ref["k"].shape[2:])
    # a MoE layer's decode stage in two halves (attention and the router,
    # then the routed experts): the layer body's decode, on its cache view
    mcfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), n_experts=8)
    mparams = st.init_params(mcfg, 0, CPU).as_dict()
    mcaches = transformer.init_caches(mcfg, 1, 16, mcfg.compute_dtype, CPU)
    x = transformer.embed_stage(mcfg, mparams, {"tokens": tokens})
    x, _ = transformer.block_group_prefill(mcfg, mparams["blocks"], mcaches, x,
                                           transformer.stage_angles(mcfg, {"tokens": tokens}, 9))
    pos = torch.tensor(9, dtype=torch.int32)
    step = {"tokens": tokens[:, -1:]}
    x1 = transformer.embed_stage(mcfg, mparams, step)
    angles = transformer.stage_angles(mcfg, step, 1, pos=pos)
    layer = {k: v.narrow(0, 0, 1) for k, v in mcaches.items()}
    twin = {k: v.clone() for k, v in layer.items()}
    slice0 = tr.tree_map(lambda a: a[:1], mparams["blocks"])
    ref_x, _ = transformer.block_group_decode(mcfg, slice0, layer, x1, angles, pos)
    ne = {**{k: v for k, v in slice0.items() if k != "moe"},
          "moe": {"router": slice0["moe"]["router"]}}
    x_attn, h2, top_w, top_i = transformer.block_decode_pre_moe(mcfg, ne, twin, x1, angles, pos)
    stack = {n: slice0["moe"][n][0] for n in ("wi", "wo", "wg")}
    assert torch.equal(x_attn + moe.decode_apply(mcfg, stack, top_w, top_i, h2), ref_x)
    assert all(torch.equal(twin[k], layer[k]) for k in layer)


# ---------------------------------------------------------------------------
# serving against the JAX package
# ---------------------------------------------------------------------------

UNPAGED = dict(batch=2, prompt_len=13, gen=6)


@pytest.mark.parametrize("param_kind", ["pinned_host", "disk_host"])
@pytest.mark.parametrize("budget, cache_mb, lpg", [(None, None, None), (0.35, None, None),
                                                   (0.45, None, 1), (None, 0.0, 1)])
def test_unpaged_streamed_serve_equals_jax(mesh, params, param_kind, budget, cache_mb, lpg):
    jc, pc = _cfgs()
    # a fixed window: under "auto" the controller's growth follows the host's
    # timing, and with it which head fetches find the embed table resident
    kw = dict(param_kind=param_kind, device_budget_mb=budget, param_cache_mb=cache_mb,
              param_layers_per_group=lpg, param_distance=1)
    theirs = jax_serve.serve(jc, mesh, kv_page_len=0, seed=SEED, **UNPAGED, **kw)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1),
                                            (UNPAGED["batch"], UNPAGED["prompt_len"]), 1,
                                            jc.vocab_size), np.int32)
    ours = sv.serve_loop(pc, params, prompts, UNPAGED["gen"], device=CPU, **kw)
    np.testing.assert_array_equal(ours["generated"], theirs["generated"])
    assert _counters(ours["param_stats"]) == _counters(theirs["param_stats"])
    assert ours["param_plan"].grouping() == theirs["param_plan"].grouping()
    assert ours["expert_stats"] is theirs["expert_stats"] is None
    assert ours["expert_decode_bytes"] == theirs["expert_decode_bytes"] == 0
    device = sv.serve_loop(pc, params, prompts, UNPAGED["gen"], device=CPU)
    np.testing.assert_array_equal(ours["generated"], device["generated"])
    if cache_mb == 0.0:
        assert ours["param_step_fetches"] == [ours["param_plan"].n_groups] * (UNPAGED["gen"] - 1)


def test_serve_takes_the_jax_home_converted(mesh, jparams, params):
    """A plan home converted from the JAX package's serves the same tokens as
    the port's home of the converted parameters."""
    jc, pc = _cfgs()
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1)
    home = home_from_numpy(jplan.init_home(jparams))
    prompts = np.random.default_rng(3).integers(1, 256, (2, 9), dtype=np.int32)
    a = sv.serve_loop(pc, home, prompts, 4, device=CPU, param_kind="pinned_host",
                      param_layers_per_group=1)
    b = sv.serve_loop(pc, params, prompts, 4, device=CPU, param_kind="pinned_host",
                      param_layers_per_group=1)
    np.testing.assert_array_equal(a["generated"], b["generated"])


PAGED = dict(slots=2, max_len=24, page_len=4)


def _session_run(session, prompts, gen, listing_of=None):
    with session as s:
        for p in prompts:
            s.submit(p, gen)
        toks = s.run()
        listing = sorted(p.name for p in listing_of.iterdir()) if listing_of else None
        return dict(tokens=toks, stats=_counters(s.param_stats), kv=s.stats.h2d_requests,
                    report=str(s.schedule_report), residency=s.param_residency.counters(),
                    fetches=list(s.param_step_fetches), listing=listing,
                    compiles=s.prefill_compiles())


@pytest.mark.parametrize("param_kind", ["pinned_host", "disk_host"])
@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
@pytest.mark.parametrize("budget, cache_mb, lpg", [(None, None, None), (0.45, None, 1),
                                                   (0.6, None, None), (None, 0.0, 1)])
def test_paged_streamed_session_equals_jax(mesh, params, tmp_path, param_kind, kv_kind, budget,
                                           cache_mb, lpg):
    jc, pc = _cfgs()
    prompts = np.random.default_rng(0).integers(1, 256, (3, 11), dtype=np.int32)
    kw = dict(PAGED, kv_kind=kv_kind, param_kind=param_kind, device_budget_mb=budget,
              param_cache_mb=cache_mb, param_layers_per_group=lpg, param_distance=1)
    runs = []
    for name, make in (("port", lambda d: sv.ServeSession(pc, params=params, device="cpu",
                                                          seed=SEED, spill_dir=str(d), **kw)),
                       ("jax", lambda d: jax_serve.ServeSession(jc, mesh, seed=SEED,
                                                                spill_dir=str(d), **kw))):
        d = tmp_path / name
        listing = d / "params" if param_kind == "disk_host" and kv_kind == "disk_host" else None
        runs.append(_session_run(make(d), prompts, 5, listing))
    ours, theirs = runs
    for rid in theirs["tokens"]:
        np.testing.assert_array_equal(ours["tokens"][rid], theirs["tokens"][rid])
    for key in ("stats", "report", "residency", "fetches", "listing", "compiles"):
        assert ours[key] == theirs[key], key
    if listing is not None:
        assert any(n.endswith(".bin") for n in ours["listing"])


def _leaks_nothing(build, spill) -> None:
    n0 = threading.active_count()
    build()
    assert threading.active_count() == n0
    assert not spill.exists()


@pytest.mark.parametrize("kwargs, match", [
    (dict(device_budget_mb=0.005), "consumed by the KV hot window"),
    (dict(device_budget_mb=0.12), "cannot hold even a distance-1 weight stream"),
    (dict(device_budget_mb=0.6, param_cache_mb=5.0), "param_cache_mb=5.0"),
])
def test_refused_budgets_leak_nothing_and_match_jax(mesh, params, tmp_path, kwargs, match):
    jc, pc = _cfgs()
    kw = dict(slots=2, max_len=16, kv_kind="disk_host", page_len=4, param_kind="disk_host",
              **kwargs)
    spill = tmp_path / "kv"
    with pytest.raises(ValueError, match=match) as ours:
        _leaks_nothing(lambda: sv.ServeSession(pc, params=params, device="cpu",
                                               spill_dir=str(spill), **kw), spill)
    with pytest.raises(ValueError) as theirs:
        jax_serve.ServeSession(jc, mesh, spill_dir=str(tmp_path / "jax"), **kw)
    assert str(ours.value) == str(theirs.value)


def test_external_engine_above_the_budget_cap_is_refused(params):
    _, pc = _cfgs()
    loose = TransferEngine(EngineConfig(max_distance=8), device="cpu")
    with pytest.raises(ValueError, match="exceeds the device budget's cap 1"):
        sv.ServeSession(pc, params=params, device="cpu", engine=loose, param_kind="pinned_host",
                        device_budget_mb=0.3, param_layers_per_group=1, **PAGED)


def test_serve_returns_the_weight_keys(params):
    _, pc = _cfgs()
    for page_len in (0, 4):
        res = sv.serve(pc, batch=2, prompt_len=9, gen=4, kv_page_len=page_len, seed=SEED,
                       param_kind="pinned_host", device_budget_mb=0.45, params=params,
                       device="cpu")
        ps, plan = res["param_stats"], res["param_plan"]
        assert isinstance(ps, StreamStats) and ps.h2d_requests == ps.unique_group_fetches > 0
        assert plan.n_groups == len(plan.groups) and res["expert_stats"] is None
        assert ps.peak_inflight_bytes + res["param_residency"]["peak_resident_bytes"] <= 450_000


@pytest.mark.parametrize("flags, out", [
    (["--kv-page-len", "0", "--param-kind", "disk_host", "--device-budget-mb", "0.5"], "weights:"),
    (["--param-kind", "pinned_host", "--device-budget-mb", "0.6", "--verify-schedule"],
     "OK: occupancy, hazards, pins verified"),
    (["--kv-kind", "disk_host", "--param-kind", "disk_host", "--param-cache-mb", "0"],
     "weight residency: 0 hits"),
])
def test_cli_streams_weights_on_cpu(monkeypatch, capsys, flags, out):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", "--batch", "2",
                                      "--prompt-len", "12", "--gen", "4", *flags])
    assert sv.main() == 0
    assert out in capsys.readouterr().out


def test_cli_verify_schedule_prints_the_jax_report(monkeypatch, capsys):
    from repro.launch import serve as jax_cli

    flags = ["serve", "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "4",
             "--kv-kind", "pinned_host", "--kv-page-len", "4", "--param-kind", "pinned_host",
             "--device-budget-mb", "0.25", "--verify-schedule"]
    reports = []
    for main, extra in ((sv.main, ["--device", "cpu"]), (jax_cli.main, [])):
        monkeypatch.setattr(sys, "argv", flags + extra)
        assert main() == 0
        out = capsys.readouterr().out
        reports.append(out[out.index("schedule[serve]"):out.index("OK: occupancy")])
    assert reports[0] == reports[1] and "kv pages" in reports[0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: streamed weights through the CUDA attention kernels")
    return torch.device("cuda")


def _card_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("smollm-360m"), n_layers=4, attn_impl="pallas")


def _card_serve(cfg, params, device, **kw):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    flash_attention.launches = decode_attention.launches = 0
    res = sv.serve(cfg, batch=3, prompt_len=100, gen=kw.pop("gen", 8), seed=0, params=params,
                   device=device, **kw)
    return res, (flash_attention.launches, decode_attention.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("param_kind", ["pinned_host", "disk_host"])
def test_streamed_unpaged_serve_on_card(cuda, param_kind):
    """(a), (b): tokens bitwise the device-resident run's, the same kernel
    launches, one H2D request per fetched group, within the budget."""
    cfg = _card_cfg()
    params = st.init_params(cfg, 0, cuda)
    dev, dev_launches = _card_serve(cfg, params, cuda, kv_page_len=0)
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=1)
    budget = plan.peak_device_bytes(1) / 1e6 + 1
    res, launches = _card_serve(cfg, params, cuda, kv_page_len=0, param_kind=param_kind,
                                device_budget_mb=budget)
    np.testing.assert_array_equal(res["generated"], dev["generated"])
    assert launches == dev_launches and min(launches) > 0
    ps, rc = res["param_stats"], res["param_residency"]
    assert ps.h2d_requests == ps.unique_group_fetches > 0
    assert ps.peak_inflight_bytes + rc["peak_resident_bytes"] <= budget * 1e6
    assert res["param_plan"].total_param_bytes > budget * 1e6
    if param_kind == "disk_host":
        assert ps.disk_requests >= ps.unique_group_fetches


@pytest.mark.cuda
def test_streamed_paged_session_and_residency_on_card(cuda):
    """(c), (d): the paged session at pinned-host pages and weights gives the
    device-resident tokens under a verified schedule; no budget keeps the
    model resident (0 groups a step), no cache fetches every group."""
    cfg = _card_cfg()
    params = st.init_params(cfg, 0, cuda)
    dev, _ = _card_serve(cfg, params, cuda, kv_page_len=0)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (3, 100), dtype=np.int32)
    with sv.ServeSession(cfg, slots=3, max_len=108, kv_kind="pinned_host", params=params,
                         param_kind="pinned_host", device_budget_mb=150, device=cuda) as s:
        rids = [s.submit(p, 8) for p in prompts]  # serve()'s prompts for seed 0
        out = s.run()
        assert s.schedule_report.ok and s._wplan.n_groups == 6
        assert s.param_stats.h2d_requests == s.param_stats.unique_group_fetches > 0
    np.testing.assert_array_equal(np.stack([out[r] for r in rids]), dev["generated"])
    for kw, each in (({}, lambda n: 0), ({"param_cache_mb": 0.0}, lambda n: n)):
        res, _ = _card_serve(cfg, params, cuda, kv_page_len=0, param_kind="pinned_host", **kw)
        np.testing.assert_array_equal(res["generated"], dev["generated"])
        n = res["param_plan"].n_groups
        assert res["param_step_fetches"] == [each(n)] * 7


@pytest.mark.cuda
def test_sanitized_streamed_serve_and_sub_floor_budget_on_card(cuda, monkeypatch):
    """(e): the sanitized run is bitwise and raises no hazard; a budget under
    the distance-1 floor is refused before any thread exists."""
    cfg = _card_cfg()
    params = st.init_params(cfg, 0, cuda)
    dev, _ = _card_serve(cfg, params, cuda, kv_page_len=0)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), device_budget_mb=140)
    engine = TransferEngine(EngineConfig(max_distance=plan.max_distance_for_budget()),
                            device=cuda)
    with engine:
        res, _ = _card_serve(cfg, params, cuda, kv_page_len=0, param_kind="pinned_host",
                             device_budget_mb=140, engine=engine)
    np.testing.assert_array_equal(res["generated"], dev["generated"])
    assert engine.sanitizer.checks > 0 and engine.sanitizer.hazards == 0
    n0 = threading.active_count()
    with pytest.raises(ValueError, match="distance-1"):
        _card_serve(cfg, params, cuda, kv_page_len=0, param_kind="pinned_host",
                    device_budget_mb=40)
    assert threading.active_count() == n0
