"""MoE training with the experts streamed, held against itself and the JAX
package's, on the CPU.

The streamed-weight train step over an expert-split plan
(``expert_stream=True``: a layer's non-expert group, then one group per
expert, merged on the card before the layer runs): the JAX package's
``tests/test_weightstream.py::test_expert_stream_train_bitwise_across_kinds``
on the port, with the disk home added.  Inside the port, bitwise: losses
and every parameter and moment group across the device, pinned-host and
disk homes and the prefetch distances; one H2D request a fetched group;
the losses within rtol 2e-4 of the unsplit plan's and the monolithic
step's.  Against the JAX package, from its own initialized state and its
batches: the losses within the f32 model tolerance (rtol 2e-4, atol 2e-3)
and the stream counters equal.  The launcher's ``--expert-stream`` trains,
restarts and refuses a device weight home as the JAX package does.
"""
import dataclasses
import json
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.refspec import PrefetchSpec as JaxPrefetch
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.data.synthetic import SyntheticConfig as JaxSC
from repro.data.synthetic import synthetic_batch as jax_batch
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy, weight_streamed_state_from_numpy
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.spillstore import SpillStore
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch
from repro_torch.launch import train as launch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.driver import DriverConfig
from repro_torch.train import steps as st

F32_TOL = dict(rtol=2e-4, atol=2e-3)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=32)
ARCH = "mixtral-8x7b"
#: the JAX package's stream counters a run must reproduce
COUNTERS = ("h2d_requests", "bytes_h2d", "unique_group_fetches", "cache_hits", "n_groups",
            "peak_inflight_bytes", "d2h_requests", "bytes_d2h")


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def plan(cfg):
    p = WeightStreamPlan(cfg, st.abstract_params(cfg), expert_stream=True)
    assert p.expert_groups and p.layers_per_group == 1
    assert [u.kind for u in p.units] == ["moe"] * cfg.n_layers
    return p


def _batch(cfg, k):
    return synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 16, 2, seed=0), k)


def _bits(x) -> bytes:
    return host_tensor(x).detach().contiguous().view(torch.uint8).numpy().tobytes()


def _run(cfg, plan, kind, *, n=2, distance="auto", residency=None, state=None, batches=None):
    """``n`` streamed steps at ``kind``; returns (losses, the state's groups
    as bytes, param stats, opt stats)."""
    with tempfile.TemporaryDirectory() as d:
        store = SpillStore(d, ephemeral=True) if kind == "disk_host" else None
        step = st.make_weight_streamed_train_step(
            cfg, AdamWConfig(**OPT), plan=plan, param_kind=kind, spill_store=store,
            prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=distance),
            residency=residency, device="cpu")
        s = state if state is not None else st.init_weight_streamed_state(cfg, plan, 0, "cpu")
        if kind == "device":
            s = st.device_weight_streamed_state(plan, s, "cpu")
        elif kind == "disk_host":
            s = st.spill_weight_streamed_state(plan, s, store)
        losses = []
        try:
            for k in range(n):
                s, m = step(s, batches[k] if batches else _batch(cfg, k))
                losses.append(float(m["loss"]))
            bits = {part: {key: [_bits(x) for x in tr.leaves(t)]
                           for key, t in s[part]["groups"].items()} for part in ("params", "opt")}
        finally:
            step.close()
            if store is not None:
                store.close()
    return losses, bits, step.param_stats, step.opt_stats


@pytest.fixture(scope="module")
def device_run(cfg, plan):
    return _run(cfg, plan, "device")


@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_expert_stream_train_bitwise_across_kinds(cfg, plan, device_run, kind):
    """Every home gives the device home's losses, parameters and moments, one
    H2D request a fetched group; the expert groups move their own bytes."""
    losses, bits, stats, _ = _run(cfg, plan, kind)
    assert losses == device_run[0]
    assert bits == device_run[1]
    h2d = stats.per_tier()["h2d"]
    assert h2d["requests_per_fetched_device_group"] == 1.0
    assert stats.h2d_requests == stats.unique_group_fetches > 0
    if kind == "disk_host":
        assert stats.disk_requests > 0


@pytest.mark.parametrize("distance", [0, 1])
def test_expert_stream_train_static_distances_bitwise(cfg, plan, device_run, distance):
    losses, bits, _, _ = _run(cfg, plan, "pinned_host", distance=distance)
    assert losses == device_run[0] and bits == device_run[1]


def test_uncached_expert_traffic_is_the_plans(cfg, plan, device_run):
    """With the cache off every group is fetched in both passes: the
    forward's and the backward's bytes, group by group the plan's."""
    losses, bits, stats, opt = _run(cfg, plan, "pinned_host", residency=ResidencyCache(0))
    assert losses == device_run[0] and bits == device_run[1]
    bwd = list(reversed(plan.groups[1:-1])) + [plan.groups[0]]
    per_step = sum(plan.group_bytes(g) for g in plan.groups) + sum(plan.group_bytes(g) for g in bwd)
    assert stats.bytes_h2d == 2 * per_step
    assert stats.h2d_requests == 2 * (2 * plan.n_groups - 1) and stats.cache_hits == 0
    assert opt.h2d_requests == 2 * plan.n_groups


def test_expert_stream_train_near_the_unsplit_and_monolithic_steps(cfg, plan, device_run):
    """The same math as the unsplit plan (one group a layer, experts
    inside) and as the monolithic step on the whole tree: the losses within
    rtol 2e-4.  The second step's loss moves with the first step's router
    gradient, which needs the aux loss's cotangent of 1."""
    unsplit = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=1)
    u_losses, *_ = _run(cfg, unsplit, "device")
    np.testing.assert_allclose(device_run[0], u_losses, rtol=2e-4)
    params, opt = st.init_train_state(cfg, 0, "cpu")
    step = st.make_train_step(cfg, AdamWConfig(**OPT))
    mono = []
    for k in range(2):
        params, opt, m = step(params, opt, _batch(cfg, k))
        mono.append(float(m["loss"]))
    np.testing.assert_allclose(device_run[0], mono, rtol=2e-4)


def test_aux_cotangent_reaches_the_router(cfg):
    """A MoE stage pulled back with the aux loss's cotangent gives the whole
    loss's router gradient; the hidden state's cotangent alone does not."""
    params = st.init_params(cfg, 0, "cpu").as_dict()
    batch = _batch(cfg, 0)
    _, _, grads = st.make_grad_step(cfg)(params, batch)
    from repro_torch.models import transformer

    x0 = transformer.embed_stage(cfg, {"embed": params["embed"]}, batch)
    ang = transformer.stage_angles(cfg, batch, x0.shape[1])
    zero = torch.zeros(())
    head = {k: params[k] for k in ("head", "ln_f")}
    with torch.enable_grad():
        xin = x0.detach().requires_grad_(True)
        x, aux = transformer.block_group_train(cfg, params["blocks"], xin, zero, ang)
        loss, _ = transformer.head_stage_loss(cfg, head, x, aux, batch)
        (ct,) = torch.autograd.grad(loss, [x])
    stage = lambda p, xx: transformer.block_group_train(cfg, p, xx, zero, ang)  # noqa: E731
    _, with_aux, _ = st._vjp(stage, params["blocks"], (x0,), ct, aux_ct=True)
    _, without, _ = st._vjp(stage, params["blocks"], (x0,), ct)
    want = grads["blocks"]["moe"]["router"]
    np.testing.assert_allclose(with_aux["moe"]["router"].numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert not np.allclose(without["moe"]["router"].numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def _jax_run(jc, jplan, n):
    """The JAX package's streamed steps at pinned host from its own init:
    (its initial state and batches as numpy, losses, param and opt stats)."""
    step = jax_steps.make_weight_streamed_train_step(
        jc, JaxAdamW(**OPT), plan=jplan, param_kind="pinned_host",
        prefetch=JaxPrefetch(buffer_size=jplan.n_groups + 2, distance=1))
    s = jax_steps.init_weight_streamed_state(jax.random.PRNGKey(0), jc, jplan)
    init = jax.tree.map(np.asarray, s)
    batches = [{k: np.asarray(v) for k, v in
                jax_batch(jc, JaxSC(jc.vocab_size, 16, 2, seed=0), k).items()} for k in range(n)]
    losses = []
    try:
        for b in batches:
            s, m = step(s, b)
            losses.append(float(m["loss"]))
    finally:
        step.close()
    return init, batches, losses, step.param_stats, step.opt_stats


@pytest.mark.parametrize("budgeted", [False, True], ids=["free", "budget"])
def test_expert_stream_train_equals_jax(cfg, budgeted):
    """From the JAX package's initialized state and batches, at pinned host
    and distance 1: its losses within the f32 model tolerance, and every
    stream counter of the weight passes and the optimizer pass equal."""
    jc = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    kw = dict(expert_stream=True)
    if budgeted:
        free = WeightStreamPlan(cfg, st.abstract_params(cfg), **kw)
        kw["device_budget_mb"] = free.peak_device_bytes(1) / 1e6
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), **kw)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), **kw)
    assert [g.key for g in plan.groups] == [g.key for g in jplan.groups]
    init, batches, j_losses, j_stats, j_opt = _jax_run(jc, jplan, 2)
    state = weight_streamed_state_from_numpy(init)
    batches = [{k: tensor_from_numpy(v) for k, v in b.items()} for b in batches]
    losses, _, stats, opt = _run(cfg, plan, "pinned_host", distance=1, state=state,
                                 batches=batches)
    np.testing.assert_allclose(losses, j_losses, **F32_TOL)
    for ours, theirs in ((stats, j_stats), (opt, j_opt)):
        assert {c: getattr(ours, c) for c in COUNTERS} == {c: getattr(theirs, c) for c in COUNTERS}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _main(monkeypatch, tmp_path, name, *argv) -> dict:
    """Losses by step (a replayed step's last)."""
    out = tmp_path / f"{name}.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "16", "--checkpoint-dir", str(tmp_path / f"ck-{name}"), "--checkpoint-every",
        "2", "--history-out", str(out), *argv])
    assert launch.main() == 0
    return {h["step"]: h["loss"] for h in json.loads(out.read_text()) if "loss" in h}


def test_cli_trains_expert_streamed_at_every_home(monkeypatch, tmp_path):
    """``--expert-stream`` trains at pinned host and on disk (through a
    failure and its restart) with the same losses, step for step."""
    pinned = _main(monkeypatch, tmp_path, "pinned", "--param-kind", "pinned_host",
                   "--expert-stream", "--verify-schedule")
    disk = _main(monkeypatch, tmp_path, "disk", "--param-kind", "disk_host", "--expert-stream",
                 "--fail-at", "3")
    assert sorted(pinned) == [0, 1, 2, 3] and all(np.isfinite(list(pinned.values())))
    assert disk == pinned


def test_cli_expert_stream_needs_a_weight_home(monkeypatch, capsys):
    """``--expert-stream`` with the weights on the card is a usage error
    (exit 2), with the JAX package's message; ``build_trainer`` raises it."""
    from repro.launch import train as jax_launch

    monkeypatch.setattr(sys, "argv", ["train", "--arch", ARCH, "--smoke", "--device", "cpu",
                                      "--expert-stream"])
    with pytest.raises(SystemExit) as e:
        launch.main()
    assert e.value.code == 2
    err = capsys.readouterr().err.strip()
    with pytest.raises(ValueError) as theirs:
        jax_launch.build_trainer(
            jax_smoke(ARCH), __import__("repro.launch.mesh", fromlist=["x"]).make_local_mesh(),
            global_batch=2, seq_len=16, opt_cfg=JaxAdamW(),
            driver_cfg=__import__("repro.runtime.driver", fromlist=["x"]).DriverConfig(
                total_steps=1), expert_stream=True)
    assert err == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        launch.build_trainer(get_smoke_config(ARCH), global_batch=2, seq_len=16,
                             opt_cfg=AdamWConfig(), driver_cfg=DriverConfig(total_steps=1),
                             expert_stream=True, device="cpu")
    assert str(ours.value) == err
