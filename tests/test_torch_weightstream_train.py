"""The port's streamed-weight train step held against itself and the JAX
package's.

Inside the port, bitwise: every home (pinned host, disk) and prefetch
distance gives the device home's losses and parameters, for the uniform,
period and unrolled layouts; the group-wise init gives
``init_train_state``'s bits; the residency cache changes traffic, never
values.  Against the JAX package, from its own initialized state and its
batches: the losses within the bf16 tolerance (2e-2), the stream counters
and the schedule reports equal.
"""
import dataclasses
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import schedcheck as jsc
from repro.core.refspec import PrefetchSpec as JaxPrefetch
from repro.core.spillstore import SpillStore as JaxSpillStore
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.data.synthetic import SyntheticConfig as JaxSC
from repro.data.synthetic import synthetic_batch as jax_batch
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy, weight_streamed_state_from_numpy
from repro_torch.core import schedcheck as sc
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.spillstore import SpillStore, is_disk_leaf
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.adamw import is_state_leaf
from repro_torch.runtime.driver import DriverConfig
from repro_torch.train import steps as st

BF16_TOL = 2e-2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=32)
#: the JAX package's stream counters a run must reproduce
COUNTERS = ("h2d_requests", "unique_group_fetches", "cache_hits", "disk_requests",
            "peak_inflight_bytes", "n_groups")


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_smoke_config("smollm-360m"), n_layers=4)


@pytest.fixture(scope="module")
def plan(cfg):
    return WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=2)


def _batch(cfg, step=0):
    return synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 16, 2, seed=0), step)


def _bits(x) -> np.ndarray:
    t = host_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).detach().cpu()
    return t.contiguous().view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)


def _assert_same_state(a, b):
    """Parameters and moments of two states, bit for bit."""
    for part in ("params", "opt"):
        for key in b[part]["groups"]:
            la, lb = tr.leaves(a[part]["groups"][key]), tr.leaves(b[part]["groups"][key])
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                assert np.array_equal(_bits(x), _bits(y)), (part, key)


def _run(cfg, plan, kind, *, n=2, distance="auto", residency=None, state=None, batches=None,
         seed=0, device="cpu"):
    """``n`` streamed steps at ``kind`` on ``device``; returns (losses, state
    as bytes, the step's param stats, opt stats and cache)."""
    with tempfile.TemporaryDirectory() as d:
        store = SpillStore(d, ephemeral=True) if kind == "disk_host" else None
        step = st.make_weight_streamed_train_step(
            cfg, AdamWConfig(**OPT), plan=plan, param_kind=kind, spill_store=store,
            prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=distance),
            residency=residency, device=device)
        s = state if state is not None else st.init_weight_streamed_state(cfg, plan, seed, device)
        if kind == "device":
            s = st.device_weight_streamed_state(plan, s, device)
        elif kind == "disk_host":
            s = st.spill_weight_streamed_state(plan, s, store)
        losses = []
        try:
            for k in range(n):
                b = batches[k] if batches else _batch(cfg, k)
                s, m = step(s, {name: v.to(device) for name, v in b.items()})
                losses.append(float(m["loss"]))
            if kind == "disk_host":
                assert plan.is_spilled(s["params"])
                assert all(is_disk_leaf(v) for v in tr.leaves(s["opt"]["groups"]))
            s = {part: {"groups": tr.tree_map(lambda x: _bits(x).copy(), s[part]["groups"])}
                 for part in ("params", "opt")}
        finally:
            step.close()
            if store is not None:
                store.close()
    return losses, s, step.param_stats, step.opt_stats, step.residency


@pytest.fixture(scope="module")
def device_run(cfg, plan):
    return _run(cfg, plan, "device")


# ---------------------------------------------------------------------------
# every home and distance gives the device home's bits
# ---------------------------------------------------------------------------


def test_streamed_train_bitwise_vs_device(cfg, plan, device_run):
    ref_losses, ref_state, *_ = device_run
    losses, state, stats, _, _ = _run(cfg, plan, "pinned_host")
    assert losses == ref_losses
    _assert_same_state(state, ref_state)
    # one coalesced H2D request per fetched group; the unbounded cache (no
    # budget) makes every later visit a resident pass-through
    assert stats.per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0
    assert stats.h2d_requests == stats.unique_group_fetches > 0
    assert 0 < stats.cache_hits and stats.h2d_requests < stats.n_groups


def test_streamed_train_disk_home_bitwise_and_writes_back(cfg, plan, device_run):
    losses, state, stats, _, _ = _run(cfg, plan, "disk_host")
    assert losses == device_run[0]
    _assert_same_state(state, device_run[1])
    assert stats.disk_requests > 0


@pytest.mark.parametrize("distance", [0, 1])
def test_streamed_train_static_distances_bitwise(cfg, plan, device_run, distance):
    losses, state, *_ = _run(cfg, plan, "pinned_host", distance=distance)
    assert losses == device_run[0]
    _assert_same_state(state, device_run[1])


def test_streamed_loss_is_the_whole_tree_steps(cfg, plan, device_run):
    """The staged program (embed, layer groups, head) computes the monolithic
    train step's loss."""
    params, opt = st.init_train_state(cfg, 0, "cpu")
    step = st.make_train_step(cfg, AdamWConfig(**OPT))
    for k, want in enumerate(device_run[0]):
        params, opt, m = step(params, opt, _batch(cfg, k))
        np.testing.assert_allclose(want, float(m["loss"]), rtol=BF16_TOL, atol=BF16_TOL)


def _layout_cfg(arch, over):
    c = get_smoke_config(arch)
    return dataclasses.replace(c, **over) if over else c


LAYOUTS = {"uniform": ("smollm-360m", {"n_layers": 4}, 2),
           "period": ("recurrentgemma-2b", {"n_layers": 6}, 1),
           "unrolled": ("recurrentgemma-2b", {}, 2),
           "xlstm-unrolled": ("xlstm-1.3b", {}, 2),
           "xlstm-period": ("xlstm-1.3b", {"n_layers": 6}, 1)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_groupwise_init_matches_init_train_state(layout):
    """Group-wise init walks ``init_model``'s draws group by group: homes and
    f32 masters bitwise those of ``init_train_state`` at the same seed."""
    arch, over, lpg = LAYOUTS[layout]
    c = _layout_cfg(arch, over)
    p = WeightStreamPlan(c, st.abstract_params(c), layers_per_group=lpg)
    assert p.layout == layout.split("-")[-1]
    params, opt = st.init_train_state(c, 3, "cpu")
    ref_home = p.init_home(params)
    flat, treedef = tr.flatten(opt["leaves"], is_leaf=is_state_leaf)
    masters = p.init_home(tr.unflatten(treedef, [s["master"] for s in flat]))
    state = st.init_weight_streamed_state(c, p, 3, "cpu")
    home = st.init_weight_streamed_params(c, p, 3, "cpu")
    for g in p.groups:
        for tree in (state["params"]["groups"][g.key], home["groups"][g.key]):
            for a, b in zip(tr.leaves(tree), tr.leaves(ref_home["groups"][g.key]), strict=True):
                assert np.array_equal(_bits(a), _bits(b)), g.key
        flat = tr.flatten(state["opt"]["groups"][g.key], is_leaf=is_state_leaf)[0]
        for o, r in zip(flat, tr.leaves(masters["groups"][g.key]), strict=True):
            assert o["master"].dtype == np.float32
            assert np.array_equal(_bits(o["master"]), _bits(r))
            assert not o["m"].any() and not o["v"].any()
    assert int(state["opt"]["step"]) == 0


def _budgeted_plan(c, lpg):
    free = WeightStreamPlan(c, st.abstract_params(c), layers_per_group=lpg)
    return WeightStreamPlan(c, st.abstract_params(c), layers_per_group=lpg,
                            device_budget_mb=free.peak_device_bytes(2) / 1e6)


@pytest.mark.parametrize("layout, disk", [("unrolled", True), ("period", False),
                                          ("xlstm-unrolled", True), ("xlstm-period", True)])
def test_hetero_streamed_train_bitwise_under_budget(layout, disk):
    """The unrolled and period layouts stream under a budget: every home
    gives the device home's losses and state."""
    arch, over, lpg = LAYOUTS[layout]
    c = _layout_cfg(arch, over)
    p = _budgeted_plan(c, lpg)
    assert p.layout == layout.split("-")[-1] and p.device_budget_bytes is not None
    ref_losses, ref_state, *_ = _run(c, p, "device")
    for kind in ("pinned_host",) + (("disk_host",) if disk else ()):
        losses, state, *_ = _run(c, p, kind)
        assert losses == ref_losses, kind
        _assert_same_state(state, ref_state)


# ---------------------------------------------------------------------------
# the residency cache changes traffic, never values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", [0, 1, "auto"])
@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_cached_train_bitwise_equals_uncached(cfg, plan, kind, distance):
    u_losses, u_state, u_stats, _, _ = _run(cfg, plan, kind, distance=distance,
                                            residency=ResidencyCache(0))
    c_losses, c_state, c_stats, _, _ = _run(cfg, plan, kind, distance=distance,
                                            residency=ResidencyCache(None))
    assert c_losses == u_losses
    _assert_same_state(c_state, u_state)
    assert u_stats.unique_group_fetches == u_stats.n_groups and u_stats.cache_hits == 0
    assert c_stats.unique_group_fetches < c_stats.n_groups and c_stats.cache_hits > 0


def test_zero_slack_budget_degenerates_to_plain_streaming(cfg, plan):
    """A budget equal to the window's peak leaves the default cache no
    capacity: the traffic is the uncached schedule's, the values too."""
    tight = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=2,
                             device_budget_mb=plan.peak_device_bytes(1) / 1e6)
    assert tight.residency_capacity_bytes() == 0
    losses, state, stats, _, cache = _run(cfg, tight, "pinned_host", distance=1)
    assert cache is not None and cache.capacity_bytes == 0
    assert stats.cache_hits == 0 and stats.unique_group_fetches == stats.n_groups > 0
    ref_losses, ref_state, *_ = _run(cfg, plan, "pinned_host", distance=1,
                                     residency=ResidencyCache(0))
    assert losses == ref_losses
    _assert_same_state(state, ref_state)


def _step(cfg, plan, kind="pinned_host"):
    return st.make_weight_streamed_train_step(
        cfg, AdamWConfig(**OPT), plan=plan, param_kind=kind,
        prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance="auto"), device="cpu")


def test_cached_groups_fresh_after_optimizer_update(cfg, plan, device_run):
    """After a step every cached group equals its re-homed (updated) bytes,
    so the next step trains from the new weights."""
    step = _step(cfg, plan)
    state = st.init_weight_streamed_state(cfg, plan, 0, "cpu")
    try:
        state, _ = step(state, _batch(cfg, 0))
        cache = step.residency
        assert cache is not None and len(cache) > 0
        for key in cache.keys():
            for a, b in zip(tr.leaves(cache.peek(key)), tr.leaves(state["params"]["groups"][key]),
                            strict=True):
                assert np.array_equal(_bits(a), _bits(b)), key
        assert cache.pinned_bytes == 0  # pins cover one turnaround only
        state, m = step(state, _batch(cfg, 1))
    finally:
        step.close()
    assert float(m["loss"]) == device_run[0][1]
    _assert_same_state({p: {"groups": tr.tree_map(_bits, state[p]["groups"])}
                        for p in ("params", "opt")}, device_run[1])


def test_failed_step_clears_cache(cfg, plan):
    """A step that dies mid-stream may leave refreshed but uncommitted
    groups: the cache comes back empty, and the next step still runs."""
    step = _step(cfg, plan)
    state = st.init_weight_streamed_state(cfg, plan, 0, "cpu")
    try:
        state, _ = step(state, _batch(cfg, 0))
        assert len(step.residency) > 0
        with pytest.raises(Exception):
            step(state, {"tokens": torch.zeros((2, 16), dtype=torch.long)})  # no targets
        assert len(step.residency) == 0
        state, m = step(state, _batch(cfg, 1))
        assert np.isfinite(float(m["loss"]))
    finally:
        step.close()


def test_driver_restart_clears_stale_cache(cfg, tmp_path):
    """A failure outside the step (here before step 2, with no checkpoint yet)
    restores older state without the step's own clear: the launcher's
    restart hook drops the cache, so the replay equals the unfailed run."""
    from repro_torch.launch.train import build_trainer

    def losses(root, fail_at):
        d = build_trainer(
            cfg, global_batch=2, seq_len=16, opt_cfg=AdamWConfig(**OPT),
            driver_cfg=DriverConfig(total_steps=4, checkpoint_every=4, checkpoint_dir=str(root),
                                    log_every=0, max_restarts=1),
            fail_at=fail_at, param_kind="pinned_host", param_layers_per_group=2, device="cpu")
        d.run()
        return {h["step"]: h["loss"] for h in d.history}, d.restarts

    ref, _ = losses(tmp_path / "ref", None)
    got, restarts = losses(tmp_path / "chaos", {2})
    assert restarts == 1 and got == ref


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_split_head_grads_matches_jax(cfg, plan):
    jplan = JaxPlan(jax_smoke("smollm-360m"), jax_steps.abstract_params(jax_smoke("smollm-360m")))
    dp = {"ln_f": {"scale": 1}, "embed": {"tok": 2}}
    assert plan.split_head_grads(dp) == jplan.split_head_grads(dp)


def _jax_run(jc, jplan, kind, distance, n):
    """The JAX package's streamed steps from its own init; returns (its
    initial state and batches as numpy, losses, param and opt stats)."""
    with tempfile.TemporaryDirectory() as d:
        store = JaxSpillStore(d, ephemeral=True) if kind == "disk_host" else None
        step = jax_steps.make_weight_streamed_train_step(
            jc, JaxAdamW(**OPT), plan=jplan, param_kind=kind, spill_store=store,
            prefetch=JaxPrefetch(buffer_size=jplan.n_groups + 2, distance=distance))
        s0 = jax_steps.init_weight_streamed_state(jax.random.PRNGKey(0), jc, jplan)
        init = jax.tree.map(np.asarray, s0)
        if kind == "disk_host":
            s0 = jax_steps.spill_weight_streamed_state(jplan, s0, store)
        batches = [{k: np.asarray(v) for k, v in
                    jax_batch(jc, JaxSC(jc.vocab_size, 16, 2, seed=0), k).items()}
                   for k in range(n)]
        losses = []
        try:
            s = s0
            for b in batches:
                s, m = step(s, b)
                losses.append(float(m["loss"]))
        finally:
            step.close()
            if store is not None:
                store.close()
    return init, batches, losses, step.param_stats, step.opt_stats


@pytest.mark.parametrize("kind, distance, tight", [("pinned_host", 1, False),
                                                   ("disk_host", 0, True)])
def test_losses_and_stream_counters_equal_jax(cfg, kind, distance, tight):
    """From the JAX package's initialized state and batches: the losses
    within the bf16 tolerance, and every stream counter of the weight
    passes and the optimizer pass equal, with and without a budget."""
    jc = dataclasses.replace(jax_smoke("smollm-360m"), n_layers=4)
    kw = dict(layers_per_group=2)
    if tight:
        free = WeightStreamPlan(cfg, st.abstract_params(cfg), **kw)
        kw["device_budget_mb"] = free.peak_device_bytes(1) / 1e6
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), **kw)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), **kw)
    init, batches, j_losses, j_stats, j_opt = _jax_run(jc, jplan, kind, distance, 2)
    state = weight_streamed_state_from_numpy(init)
    batches = [{k: tensor_from_numpy(v) for k, v in b.items()} for b in batches]
    losses, _, stats, opt_stats, _ = _run(cfg, plan, kind, distance=distance, state=state,
                                          batches=batches)
    np.testing.assert_allclose(losses, j_losses, rtol=BF16_TOL, atol=BF16_TOL)
    for ours, theirs in ((stats, j_stats), (opt_stats, j_opt)):
        assert {c: getattr(ours, c) for c in COUNTERS} == {c: getattr(theirs, c) for c in COUNTERS}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_schedule_reports_equal_jax(layout):
    """The analysis the step verifies at construction (its window, cache and
    spill) reads string for string as the JAX package's."""
    arch, over, lpg = LAYOUTS[layout]
    c, jc = _layout_cfg(arch, over), dataclasses.replace(jax_smoke(arch), **over)
    ours = _budgeted_plan(c, lpg)
    theirs = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=lpg,
                     device_budget_mb=ours.device_budget_bytes / 1e6)
    cap = ours.residency_capacity_bytes()
    assert cap == theirs.residency_capacity_bytes()
    kw = dict(distance=ours.max_distance_for_budget(cached_bytes=cap), cache_capacity=cap,
              spill=True)
    a, b = sc.analyze_train_schedule(ours, **kw), jsc.analyze_train_schedule(theirs, **kw)
    assert str(a) == str(b) and a.ok


@pytest.mark.parametrize("page_len", [0, 4], ids=["serve_loop", "ServeSession"])
@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_serving_homes_built_group_wise_keep_the_tokens(page_len, kind):
    """Without given weights, ``serve_loop`` and ``ServeSession`` build their
    home group by group from the seed: the tokens are those of the weights
    drawn whole (device-resident serving at the same seed)."""
    from repro_torch.launch.serve import serve

    c = get_smoke_config("smollm-360m")
    kw = dict(batch=2, prompt_len=8, gen=4, kv_page_len=page_len, seed=5, warmup=False,
              device="cpu")
    want = serve(c, **kw)["generated"]
    got = serve(c, **kw, param_kind=kind, param_layers_per_group=1)
    assert np.array_equal(got["generated"], want)
    assert got["param_stats"].unique_group_fetches > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the group-wise init draws from the card's generator")
    return torch.device("cuda")


@pytest.mark.cuda
def test_groupwise_init_and_every_home_bitwise_on_card(cuda, cfg, plan):
    """On the card: the group-wise init draws ``init_train_state``'s bits
    from the card's generator, and every home and distance trains the
    device home's bits."""
    params, _ = st.init_train_state(cfg, 0, cuda)
    ref_home = plan.init_home(params)
    home = st.init_weight_streamed_params(cfg, plan, 0, cuda)
    for g in plan.groups:
        for a, b in zip(tr.leaves(home["groups"][g.key]), tr.leaves(ref_home["groups"][g.key]),
                        strict=True):
            assert np.array_equal(_bits(a), _bits(b)), g.key
    ref_losses, ref_state, *_ = _run(cfg, plan, "device", device=cuda)
    for kind, distance in (("pinned_host", "auto"), ("pinned_host", 0), ("disk_host", 1)):
        losses, state, *_ = _run(cfg, plan, kind, distance=distance, device=cuda)
        assert losses == ref_losses, (kind, distance)
        _assert_same_state(state, ref_state)
