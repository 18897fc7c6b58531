"""The port's runtime: the fault-tolerant driver, the straggler monitor, the
one-card elastic checks and the recovery benchmark, with the driver cases of
the JAX package's ``tests/test_runtime.py`` and ``tests/test_recovery.py``
ported.

The straggler monitors of both packages run on one injected clock (each
module's ``time`` replaced), so the events compare exactly and no test
sleeps.  A last test scans the port's sources and ``chip_smoke.py`` for
imports of JAX or of the JAX package.
"""
import ast
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

from repro.runtime import elastic as jax_el
from repro.runtime import straggler as jax_straggler
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_to_numpy
from repro_torch.core import tree as tr
from repro_torch.core.engine import AdaptiveDistance, EngineConfig, TransferEngine
from repro_torch.core.memkind import place
from repro_torch.data import SyntheticConfig, synthetic_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import elastic as el
from repro_torch.runtime import straggler
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.train import steps as st

ROOT = Path(__file__).resolve().parents[1]


class Clock:
    """A ``time`` stand-in whose ``perf_counter`` the test advances."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def _clocked(monkeypatch, *modules) -> Clock:
    clock = Clock()
    for m in modules:
        monkeypatch.setattr(m, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    return clock


# ---------------------------------------------------------------------------
# straggler monitor: both packages on one injected clock
# ---------------------------------------------------------------------------

DURATIONS = {
    "steady_then_one_straggler": [0.1] * 10 + [0.15] + [0.1] * 5,
    "jitter_below_threshold": [0.1, 0.1003, 0.0998, 0.1001] * 4 + [0.1004],
    "ramp_and_spikes": [0.05 + 0.001 * i for i in range(12)] + [0.3, 0.06, 0.9, 0.061],
    "microsecond_steps": [1e-6] * 10 + [1.5e-6, 1e-6, 5e-3],
    "window_rolls_over": [0.1] * 20 + [0.5] * 20 + [0.1, 2.0],
}


@pytest.mark.parametrize("name", sorted(DURATIONS))
def test_straggler_events_match_jax_on_an_injected_clock(monkeypatch, name):
    clock = _clocked(monkeypatch, straggler, jax_straggler)
    seen = {"ours": [], "theirs": []}
    ours = straggler.StragglerMonitor(window=16, z_threshold=6.0, on_event=seen["ours"].append)
    theirs = jax_straggler.StragglerMonitor(window=16, z_threshold=6.0,
                                            on_event=seen["theirs"].append)
    for i, d in enumerate(DURATIONS[name]):
        ours.start_step(i)
        theirs.start_step(i)
        clock.now += d
        a, b = ours.end_step(), theirs.end_step()
        assert (a is None) == (b is None)
    events = [[dataclasses.astuple(e) for e in seen[k]] for k in ("ours", "theirs")]
    assert events[0] == events[1]
    assert [dataclasses.astuple(e) for e in ours.events] == events[0]
    assert list(ours.window) == list(theirs.window)


def test_straggler_flags_the_slow_step_only(monkeypatch):
    clock = _clocked(monkeypatch, straggler)
    seen = []
    mon = straggler.StragglerMonitor(window=16, z_threshold=6.0, on_event=seen.append)
    for i, d in enumerate([1e-6] * 10 + [0.15]):
        mon.start_step(i)
        clock.now += d
        mon.end_step()
    assert len(seen) == 1 and seen[0].step == 10 and seen[0].duration_s == pytest.approx(0.15)


def test_straggler_deadline_on_an_injected_clock(monkeypatch):
    clock = _clocked(monkeypatch, straggler)
    mon = straggler.StragglerMonitor(deadline_s=0.01)
    assert not mon.check_deadline()
    mon.start_step(0)
    clock.now += 0.005
    assert not mon.check_deadline()
    clock.now += 0.01
    assert mon.check_deadline()
    with pytest.raises(AssertionError):
        straggler.StragglerMonitor().end_step()


# ---------------------------------------------------------------------------
# the driver (tests/test_runtime.py and tests/test_recovery.py, ported)
# ---------------------------------------------------------------------------


def _driver(tmp_path, fail_at=None, steps=8, every=4, max_restarts=3):
    cfg = get_smoke_config("smollm-360m")
    step_raw = st.make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                                   total_steps=steps))

    def step_fn(state, batch):
        # a restore hands back host numpy: place it, as the launcher does
        p, o, m = step_raw(place(state["params"], "device", "cpu"),
                           place(state["opt"], "device", "cpu"), batch)
        return {"params": p, "opt": o}, m

    sc = SyntheticConfig(cfg.vocab_size, 16, 2, seed=1)

    def init_state():
        p, o = st.init_train_state(cfg, 0, "cpu")
        return {"params": p, "opt": o}

    p_abs, o_abs = st.abstract_train_state(cfg)
    dcfg = DriverConfig(total_steps=steps, checkpoint_every=every, checkpoint_dir=str(tmp_path),
                        log_every=0, max_restarts=max_restarts)
    return TrainDriver(dcfg, step_fn, lambda i: synthetic_batch(cfg, sc, i), init_state,
                       fail_at=fail_at, template=lambda: {"params": p_abs, "opt": o_abs})


def test_driver_trains_and_checkpoints(tmp_path):
    d = _driver(tmp_path / "a")
    d.run()
    assert d.ckpt.all_steps() == [3, 7]
    losses = [h["loss"] for h in d.history]
    assert len(losses) == 8 and all(np.isfinite(losses))


def test_driver_restart_restores_the_saved_state_and_replays_the_losses(tmp_path):
    """A failure at step 6 restores step 3's checkpoint bit for bit, and
    every loss equals the unfailed run's exactly."""
    ok = _driver(tmp_path / "ok")
    ok.run()
    failing = _driver(tmp_path / "fail", fail_at={6})
    saved, restored = {}, []
    real_save, real_restore = failing.ckpt.save, failing.ckpt.restore

    def save(step, tree, **kw):
        saved[step] = tree_to_numpy(tree)
        return real_save(step, tree, **kw)

    def restore(template, **kw):
        out = real_restore(template, **kw)
        restored.append(out)
        return out

    failing.ckpt.save, failing.ckpt.restore = save, restore
    failing.run()
    assert failing.restarts == 1 and len(restored) == 1
    step, state = restored[0]
    assert step == 3
    for a, b in zip(tr.leaves(state), tr.leaves(saved[3])):
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8))
    assert [h["step"] for h in failing.history] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    ok_losses = {h["step"]: h["loss"] for h in ok.history}
    assert all(h["loss"] == ok_losses[h["step"]] for h in failing.history)


def test_driver_writes_each_checkpoint_step_once(tmp_path):
    """When ``checkpoint_every`` divides ``total_steps`` the last step is
    committed by the final blocking save alone (the JAX package's driver
    also queues an async save of it, writing the step twice)."""
    d = _cheap_driver(tmp_path, steps=8, every=2, max_restarts=1)
    calls = []
    real = d.ckpt.save
    d.ckpt.save = lambda step, tree, **kw: (calls.append((step, kw.get("blocking", False))),
                                            real(step, tree, **kw))
    d.run()
    assert calls == [(1, False), (3, False), (5, False), (7, True)]
    assert d.ckpt.all_steps() == [3, 5, 7]


def test_driver_gives_up_after_max_restarts(tmp_path):
    d = _driver(tmp_path / "x", fail_at={2, 3, 4, 5, 6})
    d.cfg = DriverConfig(total_steps=8, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / "x"), log_every=0, max_restarts=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        d.run()
    assert d.restarts == 3


def _cheap_driver(tmp_path, *, steps=12, every=2, max_restarts=1, fail_at=None, engine=None,
                  always_fail_from=None, **kw):
    def step_fn(state, batch):
        if always_fail_from is not None and batch >= always_fail_from:
            raise RuntimeError(f"persistent fault at step {batch}")
        x = state["x"] + 1.0
        return {"x": x}, {"loss": float(np.sum(x))}

    dcfg = DriverConfig(total_steps=steps, checkpoint_every=every, checkpoint_dir=str(tmp_path),
                        log_every=0, max_restarts=max_restarts)
    return TrainDriver(dcfg, step_fn, lambda i: i, lambda: {"x": np.zeros(4, np.float32)},
                       fail_at=fail_at, engine=engine, **kw)


def test_restart_budget_resets_after_healthy_steps(tmp_path):
    d = _cheap_driver(tmp_path / "a", max_restarts=1, fail_at={4, 9})
    d.run()
    assert d.restarts == 2
    assert d.history[-1]["step"] == 11


def test_restart_budget_still_trips_on_crash_loop(tmp_path):
    d = _cheap_driver(tmp_path / "b", max_restarts=1, always_fail_from=4)
    with pytest.raises(RuntimeError, match="persistent fault"):
        d.run()


def test_straggler_event_widens_engine_prefetch(monkeypatch, tmp_path):
    """The driver wires straggler events into the engine: a flagged step
    boosts every registered ``AdaptiveDistance`` and the disk window (on the
    injected clock: no sleep)."""
    clock = _clocked(monkeypatch, straggler)
    eng = TransferEngine(EngineConfig(disk_slots=1, disk_max_slots=4), device="cpu")
    try:
        ctrl = AdaptiveDistance(initial=1, max_distance=8)
        eng.register_controller(ctrl)
        mon = _cheap_driver(tmp_path, engine=eng).monitor
        for _ in range(10):
            mon.start_step(0)
            clock.now += 1e-3
            mon.end_step()
        before = ctrl.distance
        mon.start_step(1)
        clock.now += 0.15
        assert mon.end_step() is not None
        assert ctrl.distance > before
    finally:
        eng.close()


def test_driver_closes_the_engine_then_the_spill_store_and_drops_writebacks(tmp_path):
    order = []

    class Engine:
        def __init__(self):
            self.discarded = 0

        def discard_writebacks(self):
            self.discarded += 1

        def close(self):
            order.append("engine")

    class Store:
        def close(self):
            order.append("store")

    eng = Engine()
    d = _cheap_driver(tmp_path, engine=eng, fail_at={3}, spill_store=Store(), max_restarts=2)
    d.run()
    assert order == ["engine", "store"] and eng.discarded == 1


def test_driver_refuses_a_checkpoint_of_another_mesh_on_restart(tmp_path):
    two = {"n_devices": 2, "shape": [2, 1], "axes": ["data", "model"]}
    d = _cheap_driver(tmp_path, fail_at={3}, run_meta={"mesh": two})
    with pytest.raises(el.RemeshRequired, match="compiled for 2 devices .* now 1; relaunch"):
        d.run()


# ---------------------------------------------------------------------------
# elastic, on one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, model, pods, pod_size", [
    (512, 16, True, None), (480, 16, True, None), (256, 16, True, None), (48, 16, True, 24),
    (64, 16, True, 32), (8, 2, False, None), (1, 1, False, None), (100, 16, True, None),
    (4, 8, True, None), (4, 0, True, None),
])
def test_elastic_mesh_shape_matches_jax(n, model, pods, pod_size):
    def call(f):
        try:
            return f(n, model=model, prefer_pods=pods, pod_size=pod_size)
        except ValueError as e:
            return str(e)

    assert call(el.elastic_mesh_shape) == call(jax_el.elastic_mesh_shape)


def test_mesh_fingerprint_is_the_jax_one_device_mesh():
    assert el.mesh_fingerprint() == jax_el.mesh_fingerprint(jax_el.elastic_local_mesh(model=1))

    class Mesh:  # a DeviceMesh's interface (2 ranks: test_torch_remesh.py)
        mesh_dim_names = ("data", "model")
        shape = (2, 1)

        def size(self):
            return 2

    shape, axes = jax_el.elastic_mesh_shape(2, model=1, prefer_pods=False)
    assert el.mesh_fingerprint(Mesh()) == {"n_devices": 2, "shape": list(shape),
                                           "axes": list(axes)}


def test_check_restart_mesh_raises_on_device_count_change():
    el.check_restart_mesh(el.mesh_fingerprint())
    jax_el.check_restart_mesh(el.mesh_fingerprint())
    for expected in ({"n_devices": 2, "shape": [2], "axes": ["data"]},
                     {"n_devices": 2, "shape": [1, 2], "axes": ["data", "model"]}):
        with pytest.raises(el.RemeshRequired) as ours:
            el.check_restart_mesh(expected)
        with pytest.raises(jax_el.RemeshRequired) as theirs:
            jax_el.check_restart_mesh(expected)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("key", ["g000_embed", "g004_head", "g002_layers_002_004",
                                 "g003_period_000_004", "g002_block_002_003",
                                 "g002_expert_001_002_e03", "g002_expert_001_002",
                                 "g002_layers_001_002_e01", "step", "leaves", "g1_embed"])
def test_parse_group_key_matches_jax(key):
    assert el.parse_group_key(key) == jax_el.parse_group_key(key)


# ---------------------------------------------------------------------------
# grouped (weight-streamed) checkpoints: saved under the JAX package's names,
# resharded into the JAX package's files
# ---------------------------------------------------------------------------

#: (arch, config overrides, layers a group before, after)
RESHARDS = {
    "uniform-split": ("smollm-360m", {"n_layers": 4}, 2, 1),
    "uniform-merge": ("smollm-360m", {"n_layers": 4}, 1, 3),
    "period": ("recurrentgemma-2b", {"n_layers": 6}, 1, 2),
    "unrolled": ("recurrentgemma-2b", {}, 2, 1),
    "moe-merge": ("mixtral-8x7b", {}, 1, 2),
}


def _ws_plans(arch, over, lpg, expert_stream=False):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.core.weightstream import WeightStreamPlan as JaxPlan
    from repro.train import steps as jax_steps
    from repro_torch.core.weightstream import WeightStreamPlan

    pc = dataclasses.replace(get_smoke_config(arch), **over)
    jc = dataclasses.replace(jax_smoke(arch), **over)
    kw = dict(expert_stream=True) if expert_stream else dict(layers_per_group=lpg)
    return (pc, WeightStreamPlan(pc, st.abstract_params(pc), **kw),
            JaxPlan(jc, jax_steps.abstract_params(jc), **kw))


def _grouped_checkpoint(root, arch, over, lpg, step=3, expert_stream=False):
    """A port checkpoint of a weight-streamed state after one streamed step
    (moments non-zero), grouped ``lpg`` layers a group (or expert-split)."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, plan, _ = _ws_plans(arch, over, lpg, expert_stream)
    fn = st.make_weight_streamed_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                                              total_steps=4),
                                            plan=plan, param_kind="pinned_host", device="cpu")
    state = st.init_weight_streamed_state(cfg, plan, 0, "cpu")
    try:
        state, _ = fn(state, synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 16, 2, 0), 0))
    finally:
        fn.close()
    CheckpointManager(root, keep=0).save(step, state, blocking=True, extra_meta={"k": 1})
    return state


def _files(d: Path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir()) if f.suffix == ".npy"}


@pytest.mark.parametrize("case", sorted(RESHARDS))
def test_reshard_gives_the_jax_files_byte_for_byte(tmp_path, case):
    """The same grouped checkpoint, copied twice and resharded to a new
    grouping by each package: the same leaf files, byte for byte, and the
    same leaf list."""
    import shutil

    from repro.checkpoint.manager import CheckpointManager as JaxCkpt
    from repro_torch.checkpoint import CheckpointManager

    arch, over, before, after = RESHARDS[case]
    _grouped_checkpoint(tmp_path / "orig", arch, over, before)
    shutil.copytree(tmp_path / "orig", tmp_path / "ours")
    shutil.copytree(tmp_path / "orig", tmp_path / "theirs")
    _, plan, jplan = _ws_plans(arch, over, after)
    assert el.reshard_grouped_checkpoint(CheckpointManager(tmp_path / "ours", keep=0), plan)
    assert jax_el.reshard_grouped_checkpoint(JaxCkpt(tmp_path / "theirs", keep=0), jplan)
    ours, theirs = (tmp_path / d / "step_00000003" for d in ("ours", "theirs"))
    a, b = _files(ours), _files(theirs)
    assert sorted(a) == sorted(b) and len(a) > 10
    assert all(a[k] == b[k] for k in a)
    la, lb = (__import__("json").loads((d / "meta.json").read_text())["leaves"]
              for d in (ours, theirs))
    assert la == lb
    assert {g.key for g in plan.groups} == {n.split("__")[2] for n in a if "__groups__" in n}
    # nothing left to do on the new grouping
    assert not el.reshard_grouped_checkpoint(CheckpointManager(tmp_path / "ours", keep=0), plan)


@pytest.mark.parametrize("split_first", [True, False], ids=["split-to-unsplit", "unsplit-to-split"])
def test_reshard_between_expert_split_and_unsplit_plans_refuses_as_jax(tmp_path, split_first):
    """An expert-split grouped checkpoint and an unsplit one of the same MoE
    model do not reshard into each other (another group program: resume
    with the original ``--expert-stream``): both packages refuse with the
    same message and leave the files as they were; an expert-split
    checkpoint is already its own plan's partition."""
    import shutil

    from repro.checkpoint.manager import CheckpointManager as JaxCkpt
    from repro_torch.checkpoint import CheckpointManager

    _grouped_checkpoint(tmp_path / "orig", "mixtral-8x7b", {}, 1, expert_stream=split_first)
    shutil.copytree(tmp_path / "orig", tmp_path / "ours")
    shutil.copytree(tmp_path / "orig", tmp_path / "theirs")
    _, plan, jplan = _ws_plans("mixtral-8x7b", {}, 1, expert_stream=not split_first)
    with pytest.raises(ValueError) as ours:
        el.reshard_grouped_checkpoint(CheckpointManager(tmp_path / "ours", keep=0), plan)
    with pytest.raises(ValueError) as theirs:
        jax_el.reshard_grouped_checkpoint(JaxCkpt(tmp_path / "theirs", keep=0), jplan)
    assert str(ours.value) == str(theirs.value)
    assert "toggling --expert-stream" in str(ours.value)
    orig = _files(tmp_path / "orig" / "step_00000003")
    assert _files(tmp_path / "ours" / "step_00000003") == orig
    _, same, jsame = _ws_plans("mixtral-8x7b", {}, 1, expert_stream=split_first)
    assert not el.reshard_grouped_checkpoint(CheckpointManager(tmp_path / "ours", keep=0), same)
    assert not jax_el.reshard_grouped_checkpoint(JaxCkpt(tmp_path / "theirs", keep=0), jsame)


def test_resharded_checkpoint_restores_the_state_regrouped(tmp_path):
    """The restore template of the new grouping reads the resharded files:
    assembled, the parameters and moments are the saved ones."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim.adamw import is_state_leaf

    arch, over, before, after = RESHARDS["uniform-split"]
    saved = _grouped_checkpoint(tmp_path, arch, over, before)
    cfg, plan_a, _ = _ws_plans(arch, over, before)
    _, plan_b, _ = _ws_plans(arch, over, after)
    assert el.ensure_plan_matches_checkpoint(tmp_path, plan_b, run_meta={"k": 2})
    assert not el.ensure_plan_matches_checkpoint(tmp_path, plan_b)
    assert not el.ensure_plan_matches_checkpoint(tmp_path / "none", plan_b)
    ckpt = CheckpointManager(tmp_path, keep=0)
    assert ckpt.load_meta(3)["extra"] == {"k": 2}
    step, got = ckpt.restore(st.abstract_weight_streamed_state(cfg, plan_b))
    assert step == 3 and int(got["opt"]["step"]) == 1

    def fields(plan, groups, field):
        out = {}
        for k, tree in groups.items():
            flat, td = tr.flatten(tree, is_leaf=is_state_leaf)
            out[k] = tr.unflatten(td, [x[field] if field else x for x in flat])
        return tr.leaves(plan.assemble({"groups": out}))

    for field in (None, "master", "m", "v"):
        part = "params" if field is None else "opt"
        for x, y in zip(fields(plan_a, saved[part]["groups"], field),
                        fields(plan_b, got[part]["groups"], field), strict=True):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_grouped_state_saves_under_the_jax_leaf_names(tmp_path):
    """A weight-streamed state saves as the JAX package's does:
    ``{params|opt}__groups__<gkey>__<subpath>``, the same files."""
    import jax

    from repro.checkpoint.manager import CheckpointManager as JaxCkpt
    from repro.train import steps as jax_steps
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import weight_streamed_state_from_numpy

    _, plan, jplan = _ws_plans("smollm-360m", {"n_layers": 4}, 2)
    jstate = jax_steps.init_weight_streamed_state(jax.random.PRNGKey(0), jplan.cfg, jplan)
    JaxCkpt(tmp_path / "theirs").save(0, jstate, blocking=True)
    CheckpointManager(tmp_path / "ours").save(
        0, weight_streamed_state_from_numpy(jax.tree.map(np.asarray, jstate)), blocking=True)
    a, b = (_files(tmp_path / d / "step_00000000") for d in ("ours", "theirs"))
    assert sorted(a) == sorted(b)
    assert all(a[k] == b[k] for k in a)
    assert "opt__groups__g001_layers_000_002__attn__wq__master.npy" in a


def test_prune_stale_spill_matches_jax(tmp_path):
    from repro.core.spillstore import SpillStore as JaxStore
    from repro_torch.core.spillstore import SpillStore

    _, plan_a, _ = _ws_plans("smollm-360m", {"n_layers": 4}, 2)
    _, plan_b, jplan_b = _ws_plans("smollm-360m", {"n_layers": 4}, 1)
    kept = {}
    for name, cls, pb in (("ours", SpillStore, plan_b), ("theirs", JaxStore, jplan_b)):
        store = cls(tmp_path / name)
        for g in plan_a.groups:
            store.put(plan_a.spill_key(g), {"w": np.zeros(3, np.float32)})
            store.put(f"wopt/{g.key}", {"w": np.zeros(3, np.float32)})
        store.put(pb.spill_key(pb.groups[1]), {"w": np.ones(2, np.float32)})
        store.put("opt_g0000", {"w": np.ones(2, np.float32)})
        n = (el if name == "ours" else jax_el).prune_stale_spill(store, pb)
        kept[name] = (n, sorted(store.keys()))
        store.close()
    assert kept["ours"] == kept["theirs"]
    assert kept["ours"][0] == 6  # wp/ and wopt/ of the old layer groups and head


# ---------------------------------------------------------------------------
# chaos: kill a disk-homed streamed-weight run at each pipeline phase
# ---------------------------------------------------------------------------


def _ws_driver(root, *, steps=6, every=2, fail_at=None):
    from repro_torch.launch.train import build_trainer

    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), n_layers=2)
    return build_trainer(
        cfg, global_batch=2, seq_len=16,
        opt_cfg=AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps),
        driver_cfg=DriverConfig(total_steps=steps, checkpoint_every=every,
                                checkpoint_dir=str(root), log_every=0, max_restarts=3),
        fail_at=fail_at, param_kind="disk_host", param_layers_per_group=1,
        transfer_retries=1, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("phase", ["forward_fetch", "d2h_drain", "ckpt_commit"])
def test_chaos_phase_kill_recovers_bitwise(tmp_path, monkeypatch, phase, sanitize):
    """Kill a disk-homed streamed-weight run mid-step at one pipeline phase:
    the restarted run's losses are bitwise the unfailed run's.  Sanitized, a
    kill mid-drain leaves writebacks pending, and the restart must discard
    them before re-fetching the same groups."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.hoststream import HostStreamExecutor

    if sanitize:
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    ref = _ws_driver(tmp_path / "ref")
    ref.run()
    ref_losses = {h["step"]: h["loss"] for h in ref.history}
    armed = {"at": 5, "n": 0}  # the 5th call: step 4, not a checkpoint step
    cls, name, nth = {"forward_fetch": (HostStreamExecutor, "run", None),
                      "d2h_drain": (TransferEngine, "drain_writebacks", None),
                      "ckpt_commit": (CheckpointManager, "save", 2)}[phase]
    real = getattr(cls, name)

    def chaos(self, *a, **kw):
        if armed["at"] is not None:
            armed["n"] += 1
            if armed["n"] == (nth or armed["at"]):  # ckpt: the second periodic save
                armed["at"] = None
                raise RuntimeError(f"injected {phase} kill")
        return real(self, *a, **kw)

    monkeypatch.setattr(cls, name, chaos)
    d = _ws_driver(tmp_path / "chaos")
    d.run()
    assert armed["at"] is None, "the chaos fault never fired"
    assert d.restarts == 1
    got = {h["step"]: h["loss"] for h in d.history}  # replayed steps overwrite
    assert got == ref_losses


# ---------------------------------------------------------------------------
# the recovery benchmark and the port's imports
# ---------------------------------------------------------------------------


def test_recovery_benchmark_gates_pass_on_cpu(monkeypatch, tmp_path):
    from repro_torch.benchmarks import common as C
    from repro_torch.benchmarks import recovery

    monkeypatch.setattr(C, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(recovery, "N_GROUPS", 8)
    assert recovery.main("cpu") == 0
    rows = {r["case"]: r for r in __import__("json").loads(
        (tmp_path / "BENCH_recovery.json").read_text())}
    assert len(rows) == 6 and rows["driver_restart"]["restarts"] == 1
    # the clean-overhead gate reads each side's minimum over the module's
    # own repeats, never a two-sample median
    assert rows["clean_overhead"]["repeats"] == recovery.REPEATS >= 20


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_port_sources_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 60
    bad = {str(f.relative_to(ROOT)): sorted(_imports(f) & {"jax", "jaxlib", "repro", "ml_dtypes",
                                                             "benchmarks"})
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}
