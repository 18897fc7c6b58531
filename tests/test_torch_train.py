"""The port's training path held against the JAX package's.

Both packages train the same smoke configs in f32 from the JAX package's
initialized parameters and its own synthetic batches, as numpy: the loss,
its gradients, the AdamW updates and three train steps agree within the
reference tests' f32 tolerance (rtol 2e-4 / atol 2e-3); the streamed
optimizer's request, byte and disk counters and its spill keys are equal.
Inside the port, the bulk host, streamed and spilled optimizer routes give
the device step's bits.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.hoststream import StreamStats as JaxStats
from repro.core.spillstore import SpillStore as JaxSpillStore
from repro.data.synthetic import SyntheticConfig as JaxSC
from repro.data.synthetic import synthetic_batch as jax_batch
from repro.models import transformer as jax_tf
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_state_from_numpy, tensor_from_numpy, tree_to_numpy
from repro_torch.core import memkind as mk
from repro_torch.core import tree as tr
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.spillstore import SpillStore, is_disk_leaf
from repro_torch.launch import train as launch
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.driver import DriverConfig
from repro_torch.train import steps as st

ARCHS = ("smollm-360m", "recurrentgemma-2b", "mixtral-8x7b", "qwen3-moe-235b-a22b")
TOL = dict(rtol=2e-4, atol=2e-3)
OPT = dict(peak_lr=1e-2, warmup_steps=1, total_steps=6)


def _cfgs(arch, **kw):
    """(port config, JAX config): the smoke config in f32."""
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The JAX package's (params, opt_state) for the f32 smoke config, numpy."""
    _, jc = _cfgs(arch)
    p, o = jax_steps.init_train_state(jax.random.PRNGKey(0), jc)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)


def _batch(arch, step, seq=32, batch=2):
    _, jc = _cfgs(arch)
    b = jax_batch(jc, JaxSC(jc.vocab_size, seq, batch, seed=1), step)
    return {k: np.asarray(v) for k, v in b.items()}


def _t(tree):
    return tr.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


def _close(port, ref, tol=TOL):
    ours, theirs = tr.leaves(tree_to_numpy(port)), jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _equal(a, b):
    """Two port trees, bit for bit."""
    la, lb = tr.leaves(tree_to_numpy(a)), tr.leaves(tree_to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# loss, gradients and train steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, chunk):
    pc, jc = _cfgs(arch, loss_chunk=chunk)
    p, _ = _jax_init(arch)
    b = _batch(arch, 0)
    fn = jax.jit(jax.value_and_grad(lambda q, bb: jax_tf.lm_loss(jc, q, bb), has_aux=True))
    (loss, aux), grads = fn(jax.tree.map(jnp.asarray, p), b)
    ours_loss, ours_aux, ours_grads = st.make_grad_step(pc)(_t(p), _t(b))
    np.testing.assert_allclose(float(ours_loss), float(loss), **TOL)
    np.testing.assert_allclose(float(ours_aux["ce"]), float(aux["ce"]), **TOL)
    assert int(ours_aux["n_tokens"]) == int(aux["n_tokens"])
    _close(ours_grads, grads)


def test_cross_entropy_ignores_targets_like_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 6)).astype(np.int32)
    targets[0, :3] = transformer.IGNORE_INDEX
    assert transformer.IGNORE_INDEX == jax_tf.IGNORE_INDEX
    for ours_fn, theirs_fn in ((transformer.cross_entropy, jax_tf.cross_entropy),
                               (transformer.cross_entropy_sum, jax_tf.cross_entropy_sum)):
        ours = ours_fn(torch.from_numpy(logits), torch.from_numpy(targets))
        theirs = theirs_fn(jnp.asarray(logits), jnp.asarray(targets))
        np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=1e-6)
        assert int(ours[1]) == int(theirs[1]) == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_jax(arch):
    pc, jc = _cfgs(arch)
    p, _ = _jax_init(arch)
    b = _batch(arch, 1)
    logits, aux = jax.jit(lambda q, bb: jax_tf.forward_train(jc, q, bb))(
        jax.tree.map(jnp.asarray, p), b)
    with torch.no_grad():
        ours, ours_aux = transformer.forward_train(pc, _t(p), _t(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(float(ours_aux), float(aux), **TOL)
    assert (float(aux) > 0) == bool(pc.n_experts)  # the MoE layers' router losses


#: AdamW's first update of a leaf is lr * sign(g): a gradient within rounding
#: of zero may take either sign in the two frameworks and move the parameter
#: by 2 * lr, so parameters are compared at a learning rate whose three
#: steps stay inside atol; losses, norms and moments do not depend on it
PARITY_OPT = dict(peak_lr=2e-4, warmup_steps=1, total_steps=6)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    pc, jc = _cfgs(arch, loss_chunk=8)
    p, o = _jax_init(arch)
    jstep = jax.jit(jax_steps.make_train_step(jc, JaxAdamW(**PARITY_OPT)))
    ours_step = st.make_train_step(pc, AdamWConfig(**PARITY_OPT))
    jp, jo = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, o)
    tp, to = _t(p), opt_state_from_numpy(o, "cpu")
    for step in range(3):
        b = _batch(arch, step)
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = ours_step(tp, to, _t(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close(tp, jp)
    _close(to, jo)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_layout_matches_jax(arch):
    """Names (in checkpoint leaf order), shapes and dtypes of (params,
    opt_state) equal the JAX package's, in bf16 as the full configs train."""
    from repro_torch.checkpoint.manager import _flatten

    pc, jc = get_smoke_config(arch), jax_smoke(arch)
    ours = st.abstract_train_state(pc)
    theirs = jax_steps.abstract_train_state(jc)
    ours_flat = [(n, tuple(x.shape), str(x.dtype).removeprefix("torch."))
                 for n, x in _flatten({"params": ours[0], "opt": ours[1]})]
    theirs_flat = []
    for path, x in jax.tree_util.tree_flatten_with_path({"params": theirs[0],
                                                         "opt": theirs[1]})[0]:
        name = "__".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        theirs_flat.append((name, tuple(x.shape), str(x.dtype)))
    assert ours_flat == theirs_flat
    assert all(x.is_meta for x in tr.leaves(ours))


# ---------------------------------------------------------------------------
# the training forward's options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_bits(arch):
    """``remat`` changes what the backward recomputes, never a value."""
    p, _ = _jax_init(arch)
    b = _t(_batch(arch, 2))
    outs = []
    for remat in ("none", "full", "dots"):
        pc, _ = _cfgs(arch, remat=remat, loss_chunk=8)
        outs.append(st.make_grad_step(pc)(_t(p), b))
    for loss, aux, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        _equal(grads, outs[0][2])


def test_pallas_forward_without_grad_matches_xla_and_refuses_grad():
    """``attn_impl="pallas"`` runs the forward-only flash kernel (its plain
    version on the CPU); with gradients on the step raises.  The chunked
    path differentiates: its loss within 1e-4 of the plain path's (the JAX
    package's ``test_chunked_attention_equals_xla`` bound), its gradients
    within the f32 tolerance."""
    p, _ = _jax_init("smollm-360m")
    b = _t(_batch("smollm-360m", 0))
    xla, _ = _cfgs("smollm-360m")
    pallas, _ = _cfgs("smollm-360m", attn_impl="pallas")
    with torch.no_grad():
        ref, _ = transformer.forward_train(xla, _t(p), b)
        out, _ = transformer.forward_train(pallas, _t(p), b)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=2e-4)
    with pytest.raises(NotImplementedError, match="forward-only flash kernel"):
        st.make_grad_step(pallas)(_t(p), b)
    chunked, _ = _cfgs("smollm-360m", attn_impl="chunked", attn_chunk_q=8)
    loss, _, grads = st.make_grad_step(chunked)(_t(p), b)
    ref_loss, _, ref_grads = st.make_grad_step(xla)(_t(p), b)
    assert abs(float(loss) - float(ref_loss)) < 1e-4
    _close(grads, tree_to_numpy(ref_grads))


def test_grad_step_leaves_the_callers_tensors_alone():
    pc, _ = _cfgs("smollm-360m")
    p, _ = _jax_init("smollm-360m")
    params = _t(p)
    _, _, grads = st.make_grad_step(pc)(params, _t(_batch("smollm-360m", 0)))
    assert not any(x.requires_grad or x.grad is not None for x in tr.leaves(params))
    assert not any(g.requires_grad for g in tr.leaves(grads))


# ---------------------------------------------------------------------------
# the streamed optimizer against the JAX package's
# ---------------------------------------------------------------------------


def _grads(arch):
    pc, _ = _cfgs(arch)
    p, _ = _jax_init(arch)
    return st.make_grad_step(pc)(_t(p), _t(_batch(arch, 0)))[2]


_INTS = ("n_transfers", "bytes_h2d", "bytes_d2h", "h2d_requests", "d2h_requests", "n_groups",
         "n_runs", "disk_requests", "bytes_disk", "unique_group_fetches", "cache_hits",
         "cache_misses", "peak_inflight_bytes", "retries", "give_ups")


@pytest.mark.parametrize("n_groups, budget_groups", [(4, None), (3, None), (4, 0), (4, 2), (1, 0)],
                         ids=["host4", "host3", "disk_all", "disk_half", "disk_one_group"])
def test_streamed_updater_counts_and_values_match_jax(tmp_path, n_groups, budget_groups):
    """Two streamed updates: the ``StreamStats`` integers, the spill keys
    and the updated values equal the JAX package's; either package reads
    the other's spill chunks."""
    arch = "smollm-360m"
    _, jo = _jax_init(arch)
    grads = _grads(arch)
    jgrads = jax.tree.map(jnp.asarray, tree_to_numpy(grads))
    host = jax.tree.map(np.asarray, jax_steps.host_opt_state(jax.tree.map(jnp.asarray, _jax_init(
        arch)[0])))
    ours_state = opt_state_from_numpy(host, host=True)
    theirs_state = host
    stores = (None, None)
    if budget_groups is not None:
        flat = jax.tree.leaves(host["leaves"])
        group_bytes = sum(a.nbytes for a in flat) // n_groups
        budget = budget_groups * group_bytes
        stores = (SpillStore(tmp_path / "ours"), JaxSpillStore(tmp_path / "theirs"))
        ours_state = st.spill_opt_state(ours_state, stores[0], n_groups=n_groups,
                                        host_budget_bytes=budget)
        theirs_state = jax_steps.spill_opt_state(theirs_state, stores[1], n_groups=n_groups,
                                                 host_budget_bytes=budget)
        assert list(stores[0].keys()) == sorted(stores[1]._manifest)
    ours_up = st.make_streamed_opt_updater(AdamWConfig(**OPT), compute_dtype=torch.float32,
                                           n_groups=n_groups, spill_store=stores[0], device="cpu")
    theirs_up = jax_steps.make_streamed_opt_updater(JaxAdamW(**OPT), compute_dtype=jnp.float32,
                                                    n_groups=n_groups, spill_store=stores[1])
    ours_st, theirs_st = StreamStats(), JaxStats()
    try:
        for _ in range(2):
            ours_p, ours_state, om = ours_up(grads, ours_state, stats=ours_st)
            theirs_p, theirs_state, tm = theirs_up(jgrads, theirs_state, stats=theirs_st)
    finally:
        ours_up.close()
        theirs_up.close()
    assert {k: getattr(ours_st, k) for k in _INTS} == {k: getattr(theirs_st, k) for k in _INTS}
    assert ours_st.h2d_requests == 2 * n_groups
    _close(ours_p, theirs_p)
    _close(ours_state["leaves"], theirs_state["leaves"])
    assert int(ours_state["step"]) == int(theirs_state["step"]) == 2
    np.testing.assert_allclose(float(om["grad_norm"]), float(tm["grad_norm"]), rtol=1e-6)
    if budget_groups is not None:
        ours_store, theirs_store = stores
        assert list(ours_store.keys()) == sorted(theirs_store._manifest)
        for key in ours_store.keys():
            template = ours_store.get(key)
            crossed = JaxSpillStore(ours_store.dir).get(key, template=template)
            for a, b in zip(tr.leaves(template), jax.tree.leaves(crossed)):
                assert np.array_equal(np.asarray(a), np.asarray(b))
            back = SpillStore(theirs_store.dir).get(key, template=template)
            for a, b in zip(tr.leaves(back), jax.tree.leaves(theirs_store.get(key))):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        # the written-back state is home again: the spilled groups as views
        spilled = sum(len(tr.leaves(ours_store.get(k))) for k in ours_store.keys())
        assert sum(is_disk_leaf(x) for x in tr.leaves(ours_state["leaves"])) == spilled > 0


def test_spill_opt_state_passes_templates_and_keeps_budgeted_groups(tmp_path):
    host = opt_state_from_numpy(_jax_init("smollm-360m")[1], host=True)
    store = SpillStore(tmp_path / "s")
    meta = {"leaves": tr.tree_map(lambda a: torch.empty(a.shape, device="meta"), host["leaves"]),
            "step": host["step"]}
    assert st.spill_opt_state(meta, store) is meta
    total = sum(a.nbytes for a in tr.leaves(host["leaves"]))
    kept = st.spill_opt_state(host, store, n_groups=4, host_budget_bytes=total)
    assert not any(is_disk_leaf(x) for x in tr.leaves(kept)) and not list(store.keys())
    spilled = st.spill_opt_state(host, store, n_groups=4)
    assert list(store.keys()) == [f"opt_g{i:04d}" for i in range(4)]
    assert all(is_disk_leaf(x) for x in tr.leaves(spilled["leaves"]))


# ---------------------------------------------------------------------------
# inside the port: every optimizer route gives the device step's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["host", "disk_all", "disk_half"])
def test_streamed_step_gives_the_device_steps_bits(tmp_path, route):
    pc, _ = _cfgs("smollm-360m", dtype="bfloat16")
    params, opt = st.init_train_state(pc, 0, "cpu")
    ref_step = st.make_train_step(pc, AdamWConfig(**OPT))
    host_params, host_opt = st.init_train_state(pc, 0, "cpu", host_opt=True)
    _equal(host_params, params)
    _equal(host_opt, opt)
    store = None
    if route != "host":
        store = SpillStore(tmp_path / "spill")
        budget = 0 if route == "disk_all" else sum(a.nbytes for a in tr.leaves(host_opt)) // 2
        host_opt = st.spill_opt_state(host_opt, store, host_budget_bytes=budget)
    stats = StreamStats()
    step = st.make_streamed_train_step(pc, AdamWConfig(**OPT), stats=stats, spill_store=store,
                                       device="cpu")
    state = {"params": host_params, "opt": host_opt}
    try:
        for i in range(3):
            b = _t(_batch("smollm-360m", i))
            params, opt, m = ref_step(params, opt, b)
            state, sm = step(state, b)
            assert torch.equal(sm["loss"], m["loss"])
            _equal(state["params"], params)
            _equal(state["opt"], opt)
    finally:
        step.close()
    assert stats.h2d_requests == 3 * 4 and stats.n_groups == 12
    assert (stats.disk_requests > 0) == (route != "host")


def _train(tmp_path, name, steps=4, fail_at=None, **kw):
    pc, _ = _cfgs("smollm-360m", dtype="bfloat16")
    dcfg = DriverConfig(total_steps=steps, checkpoint_every=2, checkpoint_dir=str(tmp_path / name),
                        log_every=0)
    driver = launch.build_trainer(pc, global_batch=2, seq_len=16, opt_cfg=AdamWConfig(**OPT),
                                  driver_cfg=dcfg, device="cpu", fail_at=fail_at, **kw)
    driver.run()
    return driver


@pytest.mark.parametrize("policy, kw", [
    (mk.HOST_OPT, {}),
    (mk.HOST_OPT, dict(stream_opt=True)),
    (mk.DISK_OPT, dict(stream_opt=True, host_budget_mb=0.1)),
    (mk.DISK_OPT, dict(stream_opt=True, opt_stream_groups=3)),
], ids=["bulk_host_opt", "stream_host_opt", "stream_disk_opt_budget", "stream_disk_opt_all"])
def test_launcher_routes_give_the_device_runs_bits(tmp_path, policy, kw):
    """Through the launcher: each placement's losses and its final
    checkpoint equal the device run's bit for bit."""
    from repro_torch.checkpoint import CheckpointManager

    ref = _train(tmp_path, "device")
    run = _train(tmp_path, "route", policy=policy, **kw)
    assert [h["loss"] for h in run.history] == [h["loss"] for h in ref.history]
    template = {"params": st.abstract_train_state(_cfgs("smollm-360m", dtype="bfloat16")[0])[0],
                "opt": st.abstract_train_state(_cfgs("smollm-360m", dtype="bfloat16")[0])[1]}
    _, a = CheckpointManager(tmp_path / "device").restore(template)
    _, b = CheckpointManager(tmp_path / "route").restore(template)
    _equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _main(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    return launch.main()


@pytest.mark.parametrize("flag", [["--model-parallel", "2"]])
def test_cli_refuses_what_is_not_ported(monkeypatch, capsys, caplog, tmp_path, flag):
    """``--model-parallel 2`` on one rank degrades the model axis with the
    JAX package's warning and trains on the one-rank mesh (``train`` has
    nothing left to refuse; serving exits 2)."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("this process holds a group")
    rc = _main(monkeypatch, "--arch", "smollm-360m", "--smoke", "--device", "cpu", "--steps", "2",
               "--batch", "2", "--seq", "8", "--checkpoint-dir", str(tmp_path / "ck"), *flag)
    assert rc == 0 and not dist.is_initialized()
    assert "model axis 2 does not fit 1 device(s); degraded to 1" in caplog.text
    assert "mesh {'data': 1, 'model': 1}" in capsys.readouterr().out


def test_cli_verify_schedule_needs_streamed_weights(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        _main(monkeypatch, "--arch", "smollm-360m", "--smoke", "--device", "cpu",
              "--verify-schedule")
    assert e.value.code == 2
    assert "streamed --param-kind" in capsys.readouterr().err


#: streamed-weight flags the CLI trains through; each run's losses must be
#: the device run's bits
STREAMED_FLAGS = {
    "pinned_host": ["--param-kind", "pinned_host"],
    "disk_host": ["--param-kind", "disk_host"],
    "device-budget-mb": ["--param-kind", "pinned_host", "--device-budget-mb", "0.2"],
    "param-layers-per-group": ["--param-kind", "disk_host", "--param-layers-per-group", "1"],
    "verify-schedule": ["--param-kind", "pinned_host", "--verify-schedule"],
}


@pytest.mark.parametrize("name", sorted(STREAMED_FLAGS))
def test_cli_trains_through_streamed_weight_flags(monkeypatch, capsys, tmp_path, name):
    import json

    base = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--steps", "3", "--batch",
            "2", "--seq", "16", "--checkpoint-every", "2"]
    hist = {}
    for run, extra in (("device", []), ("streamed", STREAMED_FLAGS[name])):
        hist[run] = tmp_path / f"{run}.json"
        assert _main(monkeypatch, *base, "--checkpoint-dir", str(tmp_path / run),
                     "--history-out", str(hist[run]), *extra) == 0
    out = capsys.readouterr().out
    losses = {run: [h["loss"] for h in json.loads(p.read_text())] for run, p in hist.items()}
    assert losses["streamed"] == losses["device"] and len(losses["device"]) == 3
    assert ("OK: occupancy, hazards, pins verified" in out) == (name == "verify-schedule")


def test_cli_streamed_weights_checkpoint_resume_and_regroup(monkeypatch, capsys, tmp_path):
    """Disk-homed weights under a budget with the schedule printed: one
    failure recovered from step 1's checkpoint; a second run with more steps
    resumes from the last checkpoint, one layer a group (the checkpoint
    resharded first), and re-homes the restored state on disk."""
    import json

    from repro_torch.checkpoint import CheckpointManager

    ck, hist = tmp_path / "ck", tmp_path / "h.json"
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", str(ck), "--checkpoint-every", "2", "--param-kind", "disk_host",
            "--history-out", str(hist)]
    assert _main(monkeypatch, *args, "--steps", "6", "--fail-at", "3", "--device-budget-mb",
                 "0.3", "--verify-schedule") == 0
    out = capsys.readouterr().out
    assert "schedule[train] smollm-360m" in out and "1 restarts" in out
    assert [h["step"] for h in json.loads(hist.read_text())] == [0, 1, 2, 2, 3, 4, 5]
    failed = {h["step"]: h["loss"] for h in json.loads(hist.read_text())}
    # the unfailed run gives the same losses
    unfailed = tmp_path / "u.json"
    assert _main(monkeypatch, *args[:9], "--checkpoint-dir", str(tmp_path / "u"),
                 "--checkpoint-every", "2", "--param-kind", "disk_host", "--history-out",
                 str(unfailed), "--steps", "6", "--device-budget-mb", "0.3") == 0
    assert {h["step"]: h["loss"] for h in json.loads(unfailed.read_text())} == failed
    assert _main(monkeypatch, *args, "--steps", "8", "--param-layers-per-group", "1") == 0
    resumed = json.loads(hist.read_text())
    assert [h["step"] for h in resumed] == [6, 7] and all(np.isfinite(h["loss"]) for h in resumed)
    meta = CheckpointManager(ck).load_meta()
    assert meta["step"] == 7 and meta["extra"]["weight_groups"][1]["key"] == "g001_layers_000_001"


def test_cli_trains_checkpoints_and_resumes_through_a_failure(monkeypatch, capsys, tmp_path):
    ck = tmp_path / "ck"
    hist = tmp_path / "h.json"
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--steps", "6", "--batch",
            "2", "--seq", "16", "--checkpoint-dir", str(ck), "--checkpoint-every", "2"]
    assert _main(monkeypatch, *args, "--fail-at", "3", "--policy", "host_opt", "--stream-opt",
                 "--history-out", str(hist)) == 0
    out = capsys.readouterr().out
    assert "6 steps" not in out and "1 restarts" in out
    import json

    steps = [h["step"] for h in json.loads(hist.read_text())]
    assert steps == [0, 1, 2, 2, 3, 4, 5]  # restored step 1's checkpoint, replayed from 2
    from repro_torch.checkpoint import CheckpointManager

    assert CheckpointManager(ck).latest_step() == 5
    assert _main(monkeypatch, *args[:6], "8", *args[7:]) == 0  # resume to step 8
    assert "2 steps" in capsys.readouterr().out


def test_cli_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(monkeypatch, "--arch", "smollm-360m", "--smoke", "--steps", "1",
              "--checkpoint-dir", str(tmp_path))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the training step's determinism and the flash kernel "
                    "are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_and_streamed_steps_repeat_bitwise_on_card(cuda):
    pc, _ = _cfgs("smollm-360m", dtype="bfloat16")
    runs = []
    for stream in (False, False, True):
        params, opt = st.init_train_state(pc, 0, cuda, host_opt=stream)
        step = (st.make_streamed_train_step(pc, AdamWConfig(**OPT)) if stream
                else st.make_train_step(pc, AdamWConfig(**OPT)))
        state, losses = {"params": params, "opt": opt}, []
        for i in range(3):
            b = _t(_batch("smollm-360m", i, seq=64, batch=4))
            b = {k: v.to(cuda) for k, v in b.items()}
            if stream:
                state, m = step(state, b)
            else:
                p, o, m = step(state["params"], state["opt"], b)
                state = {"params": p, "opt": o}
            losses.append(m["loss"].cpu())
        if stream:
            step.close()
        runs.append((losses, state["params"]))
    for losses, params in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(losses, runs[0][0]))
        _equal(params, runs[0][1])


@pytest.mark.cuda
def test_pallas_forward_launches_flash_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    pc, _ = _cfgs("smollm-360m", dtype="bfloat16", attn_impl="pallas")
    pc = dataclasses.replace(pc, n_heads=4, n_kv_heads=2, head_dim=64, d_model=64)
    params, _ = st.init_train_state(pc, 0, cuda)
    b = {k: v.to(cuda) for k, v in _t(_batch("smollm-360m", 0, seq=64)).items()}
    before = flash_attention.launches
    with torch.no_grad():
        logits, _ = transformer.forward_train(pc, params, b)
    assert flash_attention.launches == before + pc.n_layers
    ref, _ = transformer.forward_train(dataclasses.replace(pc, attn_impl="xla"), params, b)
    err = (logits.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(err) < 5e-2
