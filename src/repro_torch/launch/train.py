"""End-to-end training launcher.

Wires the port's layers together: config -> train step -> prefetching
loader -> fault-tolerant driver with checkpointing, on one card (the JAX
package's ``launch/train.py``; its mesh reduces to one device)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --device cpu --steps 6 --batch 2 --seq 16 --checkpoint-dir /tmp/ckpt \\
      [--policy host_opt --stream-opt | --policy disk_opt --stream-opt --host-budget-mb 0.1] \\
      [--fail-at 3]

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --device cpu --steps 6 --batch 2 --seq 16 --checkpoint-dir /tmp/ckpt-w \\
      --param-kind disk_host --device-budget-mb 0.3 --verify-schedule [--fail-at 3]

The AdamW state lives on the card (``all_device``), at pinned host between
steps (``host_opt``: copied in bulk at the step's edges, or with
``--stream-opt`` streamed group by group through the transfer engine), or
spilled to the disk tier past ``--host-budget-mb`` (``disk_opt``).  With
``--param-kind pinned_host`` or ``disk_host`` the weights themselves, their
gradients and their moments are homed off the card and streamed group by
group under ``--device-budget-mb`` (the streamed-weight train step;
``--param-layers-per-group`` sizes the groups, ``--verify-schedule`` prints
the static schedule analysis first).  Every placement gives the device
run's bits.  ``--expert-stream`` exits 2 (ROADMAP.md queue 1 item 7: the
MoE layers); ``--model-parallel`` above 1 exits 2 (item 5).
"""
from __future__ import annotations

import argparse
import logging
import tempfile
import time
from typing import Optional

from repro_torch.configs import ARCHS, ModelConfig, get_config, get_smoke_config
from repro_torch.core import memkind as mk
from repro_torch.core import schedcheck
from repro_torch.core import tree as tr
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.spillstore import SpillStore, is_disk_leaf
from repro_torch.core.weightstream import PARAM_KINDS, WeightStreamPlan, weight_stream_support
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import elastic as el
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.train import steps as st

log = logging.getLogger("repro_torch.train")

_MODEL_PARALLEL = "model parallelism (ROADMAP.md, queue 1 item 5: multi-device and tooling)"
_EXPERTS = "the MoE layers (ROADMAP.md, queue 1 item 7: the other model families)"


def build_trainer(
    cfg: ModelConfig,
    *,
    global_batch: int,
    seq_len: int,
    opt_cfg: AdamWConfig,
    driver_cfg: DriverConfig,
    seed: int = 0,
    fail_at=None,
    prefetch_distance: int = 2,
    policy: Optional[mk.PlacementPolicy] = None,
    stream_opt: bool = False,
    opt_stream_groups: int = 4,
    spill_dir=None,
    host_budget_mb: Optional[float] = None,
    param_kind: str = "device",
    device_budget_mb: Optional[float] = None,
    param_layers_per_group: Optional[int] = None,
    verify_schedule: bool = False,
    transfer_retries: int = 1,
    device: DeviceLike = None,
) -> TrainDriver:
    """Assemble the :class:`TrainDriver` for ``cfg`` on ``device`` (the card
    unless ``"cpu"``).

    ``policy`` chooses the memory kind of each state group — the paper's
    one-line placement change.  With ``HOST_OPT`` the AdamW state lives at
    pinned host between steps and is copied in bulk to the card for the
    update and back.  ``stream_opt`` upgrades a host-kind optimizer policy
    to the transfer-engine streamed update: the moments live on the host as
    numpy groups and stream through the engine (coalesced, pipelined
    writeback, ``distance="auto"``) during the update itself.  With a
    ``DISK_OPT`` policy (or an explicit ``spill_dir`` and
    ``host_budget_mb``), groups that do not fit ``host_budget_mb`` spill to
    a ``DiskHost`` :class:`~repro_torch.core.spillstore.SpillStore` and
    stream disk -> host -> device.  ``transfer_retries`` is the engine's
    transient-fault budget (``EngineConfig.max_attempts``).

    ``param_kind`` ``"pinned_host"`` or ``"disk_host"`` homes the weights,
    their gradients and their moments off the card and trains through the
    streamed-weight step (:func:`_build_weight_streamed`, which the policy's
    optimizer placement and ``stream_opt`` give way to).

    Each placement starts from the same f32 master, so every route gives
    the device run's bits."""
    dev = resolve_device(device)
    policy = policy or mk.ALL_DEVICE
    sc = SyntheticConfig(cfg.vocab_size, seq_len, global_batch, seed=seed)
    loader = PrefetchLoader(lambda step: synthetic_batch(cfg, sc, step), device=dev,
                            distance=prefetch_distance)
    if param_kind not in PARAM_KINDS:
        raise ValueError(f"unknown --param-kind {param_kind!r}; expected one of {PARAM_KINDS}")
    if param_kind != "device":
        if stream_opt:
            log.warning("--stream-opt is subsumed by --param-kind %s: the AdamW moments are "
                        "homed with the weights and stream through the same groups", param_kind)
        return _build_weight_streamed(
            cfg, opt_cfg=opt_cfg, driver_cfg=driver_cfg, loader=loader, seed=seed,
            fail_at=fail_at, spill_dir=spill_dir, param_kind=param_kind,
            device_budget_mb=device_budget_mb, param_layers_per_group=param_layers_per_group,
            verify_schedule=verify_schedule, transfer_retries=transfer_retries, device=dev)
    run_meta = {"mesh": el.mesh_fingerprint(), "param_kind": param_kind}
    p_abs, o_abs = st.abstract_train_state(cfg)

    def template():
        return {"params": p_abs, "opt": o_abs}

    def on_device(tree):
        # a restore hands back host numpy: place it (a no-op for device leaves)
        return mk.place(tree, mk.DEVICE, dev)

    if stream_opt and policy.opt_state.jax_kind == "device":
        log.warning("--stream-opt ignored: policy %r keeps optimizer state on device; use "
                    "--policy host_opt (or host_all) to stream it", policy.name)
    if not policy.params.jax_addressable or not policy.kv_cache.jax_addressable:
        log.warning("policy %r places params/kv at the DiskHost tier, but the trainer has no "
                    "disk-params streaming path: they stay on the device", policy.name)
    if not stream_opt and not policy.opt_state.jax_addressable:
        log.warning("policy %r without --stream-opt never touches disk: the DiskHost kind "
                    "resolves to its host staging kind for bulk step-boundary copies; pass "
                    "--stream-opt to stream the moments through the spill store", policy.name)

    if stream_opt and policy.opt_state.jax_kind != "device":
        # engine-streamed optimizer: moments stay host numpy between steps;
        # groups beyond the host budget live on disk and stream
        # disk -> host -> device
        engine = TransferEngine(EngineConfig(max_attempts=transfer_retries), device=dev)
        stream_stats = StreamStats()
        spill_store = None
        use_spill = not policy.opt_state.jax_addressable or (
            spill_dir is not None and host_budget_mb is not None
        )
        if spill_dir is not None and host_budget_mb is None and not use_spill:
            log.warning("--spill-dir ignored: policy %r is host-resident and no "
                        "--host-budget-mb overflow threshold was given", policy.name)
        if use_spill:
            ephemeral = spill_dir is None
            if ephemeral:
                spill_dir = tempfile.mkdtemp(prefix="repro-torch-spill-opt-")
            # a run-private store is ephemeral: no per-put fsync on the hot
            # path, deleted by the driver's close()
            spill_store = SpillStore(spill_dir, ephemeral=ephemeral)
        streamed = st.make_streamed_train_step(
            cfg, opt_cfg, n_groups=opt_stream_groups,
            prefetch=PrefetchSpec(buffer_size=opt_stream_groups + 1, distance=AUTO),
            engine=engine, stats=stream_stats, spill_store=spill_store,
        )
        budget_bytes = int(host_budget_mb * 1e6) if host_budget_mb else 0

        def spilled(opt):
            return st.spill_opt_state(opt, spill_store, n_groups=opt_stream_groups,
                                      host_budget_bytes=budget_bytes)

        def init_state_streamed():
            params, opt = st.init_train_state(cfg, seed, dev, host_opt=True)
            return {"params": params, "opt": spilled(opt) if spill_store is not None else opt}

        def wrapped_step_streamed(state, batch):
            opt = state["opt"]
            if spill_store is not None and not any(is_disk_leaf(x) for x in tr.leaves(opt)):
                # a restore hands back plain host arrays: re-impose the
                # budget, or the whole state sits in RAM
                opt = spilled(opt)
            return streamed({"params": on_device(state["params"]), "opt": opt}, batch)

        return TrainDriver(driver_cfg, wrapped_step_streamed, loader, init_state_streamed,
                           fail_at=fail_at, engine=engine, stream_stats=stream_stats,
                           spill_store=spill_store, run_meta=run_meta, template=template)

    step_fn = st.make_train_step(cfg, opt_cfg)

    def opt_home(opt):
        """The optimizer state at its policy kind (host offload)."""
        return opt if policy.opt_state.jax_kind == "device" else mk.place(opt, policy.opt_state, dev)

    def init_state():
        params, opt = st.init_train_state(cfg, seed, dev)
        return {"params": params, "opt": opt_home(opt)}

    def wrapped_step(state, batch):
        # stream in from the home kind, update, stream back (paper 'rw')
        params, opt, metrics = step_fn(on_device(state["params"]), on_device(state["opt"]), batch)
        return {"params": params, "opt": opt_home(opt)}, metrics

    return TrainDriver(driver_cfg, wrapped_step, loader, init_state, fail_at=fail_at,
                       run_meta=run_meta, template=template)


def _build_weight_streamed(cfg: ModelConfig, *, opt_cfg: AdamWConfig, driver_cfg: DriverConfig,
                           loader, seed: int, fail_at, spill_dir, param_kind: str,
                           device_budget_mb: Optional[float],
                           param_layers_per_group: Optional[int], verify_schedule: bool,
                           transfer_retries: int, device) -> TrainDriver:
    """:func:`build_trainer`'s streamed-weight route (the JAX package's
    ``build_trainer`` streamed branch): the plan, the residency cache sized
    to the budget's slack, the schedule analysis, the grouped checkpoint
    resharded to the plan and the stale spill chunks pruned before the
    restore, the group-wise initial state, and the disk home re-imposed
    after a restore."""
    support = weight_stream_support(cfg)
    if not support:
        raise ValueError(f"--param-kind {param_kind}: {support.reason}")
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=param_layers_per_group,
                            device_budget_mb=device_budget_mb)
    log.info("weight streaming: %s program, %d groups (%d layers/group), total %.1f MB, "
             "peak(d=1) %.1f MB, max distance %d", plan.layout, plan.n_groups,
             plan.layers_per_group, plan.total_param_bytes / 1e6, plan.peak_device_bytes(1) / 1e6,
             plan.max_distance_for_budget())
    # the budget's slack above the prefetch window keeps fetched groups on
    # the card (window + cache never exceed the budget)
    residency = ResidencyCache(plan.residency_capacity_bytes())
    log.info("weight residency cache: %s capacity", "unbounded"
             if residency.capacity_bytes is None else f"{residency.capacity_bytes / 1e6:.1f} MB")
    if verify_schedule:
        # the step re-runs the analysis at construction and fails fast
        # regardless; this prints it
        report = schedcheck.analyze_train_schedule(
            plan, distance=plan.max_distance_for_budget(),
            cache_capacity=residency.capacity_bytes, spill=param_kind == "disk_host")
        print(report)
        schedcheck.verify_schedule(report)
    engine = TransferEngine(EngineConfig(max_distance=plan.max_distance_for_budget(),
                                         max_attempts=transfer_retries), device=device)
    param_stats = StreamStats()
    store = None
    try:
        if param_kind == "disk_host":
            ephemeral = spill_dir is None
            if ephemeral:
                spill_dir = tempfile.mkdtemp(prefix="repro-torch-spill-wp-")
            store = SpillStore(spill_dir, ephemeral=ephemeral)
        run_meta = {"mesh": el.mesh_fingerprint(), "param_kind": param_kind,
                    "weight_groups": plan.grouping()}
        # a checkpoint written under another grouping is repartitioned in
        # place before the driver restores it
        if el.ensure_plan_matches_checkpoint(driver_cfg.checkpoint_dir, plan,
                                             run_meta=run_meta) and store is not None:
            el.prune_stale_spill(store, plan)
        step = st.make_weight_streamed_train_step(
            cfg, opt_cfg, plan=plan, engine=engine, stats=param_stats, spill_store=store,
            param_kind=param_kind, residency=residency)
    except BaseException:
        engine.close()
        if store is not None:
            store.close()
        raise

    def init_state():
        state = st.init_weight_streamed_state(cfg, plan, seed, device)
        return st.spill_weight_streamed_state(plan, state, store) if store is not None else state

    def wrapped_step(state, batch):
        if store is not None and not plan.is_spilled(state["params"]):
            # a restore hands back plain host arrays: re-impose the disk home,
            # or the weights sit in RAM
            state = st.spill_weight_streamed_state(plan, state, store)
        return step(state, batch)

    def on_restart(_n):
        # the restart restores an older state (or re-inits): cached device
        # copies no longer match the home, and a failure outside the step
        # (a checkpoint commit, the watchdog) skips the step's own clear
        residency.clear()
        # a kill mid-drain can leave writebacks pending; the replay must
        # neither drain them nor re-fetch their groups behind them
        engine.discard_writebacks()

    return TrainDriver(driver_cfg, wrapped_step, loader, init_state, fail_at=fail_at,
                       engine=engine, stream_stats=param_stats, spill_store=store,
                       run_meta=run_meta, on_restart=on_restart,
                       template=lambda: st.abstract_weight_streamed_state(cfg, plan))


#: flags of the JAX entry point whose port is queued, and where; any value
#: but the default exits 2
_NOT_PORTED = {
    "expert_stream": _EXPERTS,
    "model_parallel": _MODEL_PARALLEL,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="all_device", choices=sorted(mk.POLICIES),
                    help="memory-kind placement policy (paper memory kinds; disk_* spill to the "
                    "DiskHost tier)")
    ap.add_argument("--stream-opt", action="store_true",
                    help="stream host-kind optimizer state through the transfer engine "
                    "(coalesced + pipelined write-back + adaptive prefetch distance)")
    ap.add_argument("--spill-dir", default=None,
                    help="directory for the DiskHost spill store (default: a temp dir when a "
                    "disk policy is active)")
    ap.add_argument("--host-budget-mb", type=float, default=None,
                    help="host-RAM budget for streamed optimizer state; moment groups beyond it "
                    "spill to the DiskHost tier (0/unset with a disk policy: spill everything)")
    ap.add_argument("--param-kind", default="device", choices=PARAM_KINDS,
                    help="home of the weights: host and disk kinds stream the weights (and "
                    "their moments) group by group for the forward, the reverse-order backward "
                    "and the update")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="device budget for streamed weights: sizes the groups and caps the "
                    "prefetch window and the residency cache")
    ap.add_argument("--param-layers-per-group", type=int, default=None,
                    help="layers a weight group (default: the most that fit the budget)")
    ap.add_argument("--expert-stream", action="store_true",
                    help="expert groups of MoE layers (not ported: queue 1 item 7)")
    ap.add_argument("--verify-schedule", action="store_true",
                    help="print the streamed-weight schedule's static analysis first and fail "
                    "on a violation (needs a streamed --param-kind)")
    ap.add_argument("--fail-at", default=None,
                    help="comma-separated step numbers at which to inject one failure each "
                    "(chaos testing: exercises restart + restore)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget; the budget resets after checkpoint-every consecutive "
                    "healthy steps")
    ap.add_argument("--transfer-retries", type=int, default=3,
                    help="transfer-engine attempt budget for transient H2D/D2H/disk faults")
    ap.add_argument("--history-out", default=None,
                    help="write the per-step metric history as JSON to this path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args()

    for dest, where in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            ap.exit(2, f"--{dest.replace('_', '-')} is not ported yet: it needs {where}\n")
    if args.verify_schedule and args.param_kind == "device":
        ap.error("--verify-schedule requires a streamed --param-kind (pinned_host or disk_host)")

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    driver_cfg = DriverConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                              checkpoint_dir=args.checkpoint_dir, max_restarts=args.max_restarts)
    fail_at = {int(s) for s in args.fail_at.split(",") if s.strip()} if args.fail_at else None
    driver = build_trainer(
        cfg, global_batch=args.batch, seq_len=args.seq, opt_cfg=opt_cfg, driver_cfg=driver_cfg,
        seed=args.seed, fail_at=fail_at, policy=mk.get_policy(args.policy),
        stream_opt=args.stream_opt, spill_dir=args.spill_dir, host_budget_mb=args.host_budget_mb,
        param_kind=args.param_kind, device_budget_mb=args.device_budget_mb,
        param_layers_per_group=args.param_layers_per_group, verify_schedule=args.verify_schedule,
        transfer_retries=args.transfer_retries, device=args.device,
    )
    t0 = time.time()
    driver.run()
    dt = time.time() - t0
    if args.history_out:
        import json

        with open(args.history_out, "w") as f:
            json.dump(driver.history, f)
    losses = [h["loss"] for h in driver.history if "loss" in h]
    span = f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses else "no new steps"
    print(f"trained {args.arch} ({'smoke' if args.smoke else 'full'}) {len(driver.history)} steps "
          f"in {dt:.1f}s on {args.device}, {driver.restarts} restarts; {span}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
