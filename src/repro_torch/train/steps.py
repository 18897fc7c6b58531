"""Step builders: train, prefill and decode, plus parameter, state and cache
setup.

Counterparts of the JAX package's ``repro/train/steps.py``.  PyTorch runs
eagerly, so a "step" is a plain closure; there is nothing to trace or
compile.

The streamed-optimizer path (``make_streamed_opt_updater`` /
``make_streamed_train_step``) is the paper's flagship pattern applied to the
largest state group of training: the AdamW moments and f32 master live at
the host kind (numpy) between steps, or past a host budget as spill-store
chunks at the disk tier, and stream through the
:class:`~repro_torch.core.engine.TransferEngine` group by group during the
update: one coalesced H2D request a group, the ``rw`` writeback pipelined
off the compute path, the prefetch distance adaptive under
``PrefetchSpec(distance="auto")``.  Every leaf runs the same eager update as
the device-resident step, so the two give the same bits.

The streamed-weight *training* step and the group-wise parameter init
follow (ROADMAP.md, queue 1 item 6).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_array
from repro_torch.core.engine import TransferEngine
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.kvpager import assemble_view, paged_cache_supported  # noqa: F401 (re-exported)
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.device import generator as make_generator
from repro_torch.models import transformer
from repro_torch.models.layers import ParamTree
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_globals,
    adamw_init,
    adamw_leaf_update,
    adamw_update,
    is_state_leaf,
)

Pytree = Any


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _value_and_grad(cfg: ModelConfig, params: Pytree, batch: dict):
    """``(loss, aux, grads)`` of ``transformer.lm_loss`` at ``params`` (the
    JAX package's ``jax.value_and_grad(lm_loss, argnums=1, has_aux=True)``):
    the leaves are detached and differentiated as fresh leaves, so the
    caller's tensors never carry autograd state."""
    flat, treedef = tr.flatten(params.as_dict() if isinstance(params, ParamTree) else params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, aux = transformer.lm_loss(cfg, tr.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tr.unflatten(treedef, list(grads))


def make_grad_step(cfg: ModelConfig) -> Callable[[Pytree, dict], tuple[torch.Tensor, dict, Pytree]]:
    """``(params, batch) -> (loss, aux, grads)`` — the forward/backward half
    of the train step, split out so the optimizer half can run through the
    host-streaming engine."""

    def grad_step(params, batch):
        return _value_and_grad(cfg, params, batch)

    return grad_step


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig
) -> Callable[[Pytree, dict, dict], tuple[Pytree, dict, dict]]:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    grad_step = make_grad_step(cfg)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_step(params, batch)
        new_params, new_opt, om = adamw_update(
            opt_cfg, grads, opt_state, compute_dtype=cfg.compute_dtype
        )
        return new_params, new_opt, {"loss": loss, **aux, **om}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None, *,
                     host_opt: bool = False) -> tuple[dict, dict]:
    """(compute-dtype params, AdamW state with the f32 master) for a fresh
    run, drawn from ``seed`` on ``device`` (the card unless ``"cpu"``;
    ``"meta"`` gives shapes only).  Plain nested dicts of tensors; with
    ``host_opt`` the state is :func:`host_opt_state`'s numpy home of the
    same f32 parameters."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = make_generator(seed, dev if dev.type != "meta" else None)
    params_f32 = transformer.init_model(cfg, gen, dev).as_dict()
    opt_state = host_opt_state(params_f32) if host_opt else adamw_init(params_f32)
    params = tr.tree_map(lambda p: p.to(cfg.compute_dtype), params_f32)
    return params, opt_state


def abstract_train_state(cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, opt_state) on the meta device: shapes and dtypes, no
    allocation."""
    return init_train_state(cfg, 0, "meta")


# ---------------------------------------------------------------------------
# streamed optimizer update (host-resident AdamW state, paper 'rw' streaming)
# ---------------------------------------------------------------------------


def _to_host(x):
    """A numpy copy of a concrete tensor (a meta tensor, a restore template,
    passes through)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_meta else host_array(x.detach().cpu().clone())
    return x


def host_opt_state(params: Pytree) -> dict:
    """Fresh AdamW state resident at the host kind (numpy leaves): the home
    representation the streamed updater maintains, so the moments never
    hold device memory between steps.  Built from the f32 parameters, its
    master is the device-resident state's."""
    dev = adamw_init(params)
    return {"leaves": tr.tree_map(_to_host, dev["leaves"]), "step": _to_host(dev["step"])}


def _group_bounds(n: int, n_groups: int) -> np.ndarray:
    """Contiguous leaf-group boundaries — shared by the streamed updater and
    the spill partitioner so both see the same groups."""
    return np.linspace(0, n, min(n_groups, n) + 1).astype(int)


def _opt_group_key(i: int) -> str:
    """The spill key of optimizer group ``i`` (the JAX package's, so either
    package reads the other's chunks)."""
    return f"opt_g{i:04d}"


def spill_opt_state(
    host_state: dict,
    store,
    *,
    n_groups: int = 4,
    host_budget_bytes: Optional[int] = None,
) -> dict:
    """Move trailing moment groups to the ``DiskHost`` tier under a host-RAM
    budget.

    Groups (the same contiguous leaf groups the streamed updater transfers)
    are kept in host RAM front to back while they fit ``host_budget_bytes``;
    the rest are written to ``store`` (one chunk per group — one disk
    request per group when streamed) and replaced by memory-mapped views.
    ``host_budget_bytes=None`` or 0 spills everything.  A state whose leaves
    are not all numpy (a meta template) passes through untouched."""
    flat_s, treedef = tr.flatten(host_state["leaves"], is_leaf=is_state_leaf)
    if not all(isinstance(v, np.ndarray) for s in flat_s for v in tr.leaves(s)):
        return host_state
    bounds = _group_bounds(len(flat_s), n_groups)
    budget = host_budget_bytes or 0
    used = 0
    out: list = []
    for i in range(len(bounds) - 1):
        chunk = tuple(flat_s[bounds[i] : bounds[i + 1]])
        nbytes = sum(v.nbytes for s in chunk for v in tr.leaves(s))
        if used + nbytes <= budget:
            used += nbytes
            out.extend(chunk)
        else:
            store.put(_opt_group_key(i), chunk)
            out.extend(store.get(_opt_group_key(i)))
    return {"leaves": tr.unflatten(treedef, out), "step": host_state["step"]}


def make_streamed_opt_updater(
    opt_cfg: AdamWConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    n_groups: int = 4,
    prefetch: Optional[PrefetchSpec] = None,
    mode: str = "prefetch",
    engine: Optional[TransferEngine] = None,
    spill_store=None,
    device: DeviceLike = None,
) -> Callable[..., tuple[Pytree, dict, dict]]:
    """Build ``update(grads, host_state, stats=None) -> (new_params,
    new_host_state, metrics)`` with host-resident optimizer state.

    Parameter leaves are partitioned into ``n_groups`` contiguous groups.
    Per group, the state leaves stream H2D through the engine (coalesced:
    one request per group) while the previous group's update computes; the
    gradients are already on the device and pass through by reference.  The
    new moments stream back D2H (``rw`` writeback, keys ``opt/<i>``) and
    come home as numpy; the new master-derived params stay on the device.
    The math is :func:`repro_torch.optim.adamw.adamw_update`'s (the same
    leaf function and globals), so the result is its bits.

    Groups whose ``host_state`` leaves live at the ``DiskHost`` tier
    (memory-mapped spill-store chunks, :func:`spill_opt_state`) stream in
    through the engine's two-stage disk -> host -> device pipeline, and
    their updated moments are written back to ``spill_store`` after the
    drain.  The engine stages onto ``device`` (the card unless ``"cpu"``)
    unless one is passed.
    """
    prefetch = prefetch or PrefetchSpec(buffer_size=n_groups, distance=1)
    executor_box: list = []  # built at the first update
    new_params_box: list = []

    def apply(glob, group):
        out = [adamw_leaf_update(opt_cfg, glob, g, s) for g, s in zip(group["g"], group["s"])]
        new_params_box.append(tuple(p.to(compute_dtype) for p, _ in out))
        return glob, tuple(s for _, s in out)

    def executor() -> HostStreamExecutor:
        if not executor_box:
            executor_box.append(HostStreamExecutor(apply, writeback=True, engine=engine,
                                                   device=None if engine else device))
        return executor_box[0]

    def update(grads, host_state, stats: Optional[StreamStats] = None):
        from repro_torch.core.spillstore import is_disk_leaf

        ex = executor()
        new_params_box.clear()
        flat_g, treedef = tr.flatten(grads)
        step = torch.tensor(int(host_state["step"]) + 1, dtype=torch.int32,
                            device=flat_g[0].device)
        glob = adamw_globals(opt_cfg, grads, step)
        flat_s = tr.flatten(host_state["leaves"], is_leaf=is_state_leaf)[0]
        bounds = _group_bounds(len(flat_g), n_groups)
        groups = [
            {"g": tuple(flat_g[bounds[i] : bounds[i + 1]]),
             "s": tuple(flat_s[bounds[i] : bounds[i + 1]])}
            for i in range(len(bounds) - 1)
        ]
        _, state_outs = ex.run(
            glob, groups, mode=mode, prefetch=prefetch, stats=stats,
            group_keys=[f"opt/{i}" for i in range(len(groups))],
        )
        state_outs = [tr.tree_map(host_array, out) for out in state_outs]
        # disk-homed groups go back to their home tier: write the updated
        # moments to the spill store and keep only the memmap views
        for i, grp in enumerate(groups):
            if any(is_disk_leaf(v) for s in grp["s"] for v in tr.leaves(s)):
                if spill_store is None:
                    raise RuntimeError(
                        "optimizer state group streamed from the DiskHost tier but no "
                        "spill_store was given to write it back"
                    )
                spill_store.put(_opt_group_key(i), state_outs[i])
                state_outs[i] = spill_store.get(_opt_group_key(i))
        new_params = tr.unflatten(treedef, [p for chunk in new_params_box for p in chunk])
        new_state = {
            "leaves": tr.unflatten(treedef, [s for chunk in state_outs for s in chunk]),
            "step": np.asarray(int(step), np.int32),
        }
        new_params_box.clear()
        return new_params, new_state, {"grad_norm": glob["grad_norm"], "lr": glob["lr"]}

    update.close = lambda: executor_box and executor_box[0].close()  # type: ignore[attr-defined]
    return update


def make_streamed_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    n_groups: int = 4,
    prefetch: Optional[PrefetchSpec] = None,
    engine: Optional[TransferEngine] = None,
    stats: Optional[StreamStats] = None,
    spill_store=None,
    device: DeviceLike = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``(state, batch) -> (state, metrics)`` with a host-resident optimizer.

    ``state = {"params": device tree, "opt": host_opt_state(...)}``.  The
    forward/backward half runs on the device; the AdamW half streams the
    host-kind moments through the transfer engine
    (:func:`make_streamed_opt_updater`).  With ``spill_store``, moment
    groups spilled to the ``DiskHost`` tier (:func:`spill_opt_state`) stream
    disk -> host -> device and write back to disk."""
    grad_fn = make_grad_step(cfg)
    updater = make_streamed_opt_updater(
        opt_cfg, compute_dtype=cfg.compute_dtype, n_groups=n_groups, prefetch=prefetch,
        engine=engine, spill_store=spill_store, device=device,
    )

    def step_fn(state, batch):
        loss, aux, grads = grad_fn(state["params"], batch)
        new_params, new_opt, om = updater(grads, state["opt"], stats=stats)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **aux, **om}

    step_fn.close = updater.close  # type: ignore[attr-defined]
    return step_fn


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(
    cfg: ModelConfig, batch_size: int, seq_len: int
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, batch, last_pos=None) -> (logits, caches)``.

    Caches for a context of ``seq_len`` are created inside the step (zeros,
    on the tokens' device) and filled in place by the prefill."""

    @torch.no_grad()
    def prefill_step(params: ParamTree, batch: dict, last_pos: Optional[int] = None):
        caches = transformer.init_caches(
            cfg, batch_size, seq_len, cfg.compute_dtype, batch["tokens"].device
        )
        return transformer.prefill(cfg, params, batch, caches, last_pos=last_pos)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, caches, batch, pos) -> (logits, caches)`` — one new token
    against populated caches, which are updated in place."""

    @torch.no_grad()
    def decode_step(params: ParamTree, caches: dict, batch: dict, pos):
        return transformer.decode_step(cfg, params, batch, caches, pos)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, view, batch, pos) -> (logits, caches)`` over a paged KV
    cache (see :mod:`repro_torch.core.kvpager`).

    ``view`` is the pager's per-slot tuple of page trees; ``pos`` is the (B,)
    vector of per-slot context positions.  :func:`assemble_view` copies the
    pages into a fresh dense cache, then the step of :func:`make_decode_step`
    runs on it, so paged and unpaged decode run the same code on the same
    values.  The returned caches are that assembled view, updated in place.
    The assembly runs inside a ``record_function`` span, which a profiler
    reads."""
    decode_fn = make_decode_step(cfg)

    def paged_decode_step(params: ParamTree, view, batch: dict, pos):
        with record_function("assemble_view"):
            dense = assemble_view(view)
        return decode_fn(params, dense, batch, pos)

    return paged_decode_step


def init_params(cfg: ModelConfig, seed: int, device) -> ParamTree:
    """Serving parameters: f32 init from ``seed`` on ``device``, cast to the
    compute dtype (as the JAX package's ``init_train_state`` casts them)."""
    device = torch.device(device)
    params = transformer.init_model(cfg, make_generator(seed, device), device)
    return params.to(cfg.compute_dtype)


def abstract_caches(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Cache shapes and dtypes on the meta device — no allocation."""
    return transformer.init_caches(cfg, batch, seq_len, cfg.compute_dtype, "meta")


def clone_caches(caches: Mapping) -> dict:
    """A deep copy of a cache tree (the steps update caches in place)."""
    return {k: clone_caches(v) if isinstance(v, Mapping) else v.clone() for k, v in caches.items()}



def abstract_params(cfg: ModelConfig) -> dict:
    """The compute-dtype parameter tree on the meta device, as nested dicts:
    shapes and dtypes only (what a
    :class:`~repro_torch.core.weightstream.WeightStreamPlan` is built from)."""
    params = transformer.init_model(cfg, make_generator(0), "meta")
    return params.to(cfg.compute_dtype).as_dict()


# ---------------------------------------------------------------------------
# streamed weights: the parameters stream group by group from their home
# ---------------------------------------------------------------------------


def _stream_mode(plan: WeightStreamPlan, prefetch: Optional[PrefetchSpec]):
    """``(prefetch spec or None, executor mode)`` of a streamed step, and the
    check that the plan's layout serves (uniform stacked blocks)."""
    if not plan.support.serve_supported:
        raise ValueError(plan.support.serve_reason)
    prefetch = prefetch or PrefetchSpec(buffer_size=plan.n_groups + 2, distance=AUTO)
    mode = "on_demand" if prefetch.on_demand else "prefetch"
    return (None if mode == "on_demand" else prefetch), mode


def _cache_put(residency: Optional[ResidencyCache], plan: WeightStreamPlan, g, group) -> None:
    """Offer a landed group to the residency cache (serve parameters never
    change, so an entry is only ever evicted, never invalidated)."""
    if residency is not None:
        residency.put(g.key, plan.cache_home_tree(g, group), plan.group_bytes(g, fetch=False))


def _layer_view(caches: dict, lo: int, hi: int) -> dict:
    """Layers ``[lo:hi)`` of a dense stacked cache, as views."""
    return {k: v.narrow(0, lo, hi - lo) for k, v in caches.items()}


def make_weight_streamed_prefill_step(
    cfg: ModelConfig,
    plan: WeightStreamPlan,
    batch_size: int,
    seq_len: int,
    *,
    engine: TransferEngine,
    prefetch: Optional[PrefetchSpec] = None,
    stats: Optional[StreamStats] = None,
    residency: Optional[ResidencyCache] = None,
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(home, batch, last_pos=None) -> (logits, caches)`` with the
    parameters streamed group by group from ``home`` (a plan home) through
    ``engine``.  The dense caches are created at the embed stage and each
    layer group prefills into its ``narrow``ed layers, so no slice is
    concatenated afterwards.

    ``residency`` keeps landed groups on the device across calls: serve
    parameters never change, so a resident group passes through the engine
    at zero requests on every later prefill or decode step until the LRU
    evicts it.  The step has ``close`` (the executor's) and ``residency``."""
    pf, mode = _stream_mode(plan, prefetch)
    head_idx = plan.n_groups - 1
    box: dict = {}

    def apply(i, carry, group):
        g = plan.groups[i]
        _cache_put(residency, plan, g, group)
        if i == 0:
            x = transformer.embed_stage(cfg, group, box["batch"])
            box["x"] = x
            box["angles"] = transformer.stage_angles(cfg, box["batch"], x.shape[1])
            box["caches"] = transformer.init_caches(cfg, batch_size, seq_len, cfg.compute_dtype,
                                                    x.device)
            return None
        if i == head_idx:
            xl = transformer._last(box["x"], box["last_pos"])
            box["logits"] = transformer.head_stage_logits(cfg, group, xl)
            return None
        box["x"], _ = transformer.block_group_prefill(
            cfg, group, _layer_view(box["caches"], g.lo, g.hi), box["x"], box["angles"])
        return None

    ex = HostStreamExecutor(apply, indexed=True, engine=engine)

    @torch.no_grad()
    def prefill(home: dict, batch: dict, last_pos: Optional[int] = None):
        box.clear()
        box["batch"] = batch
        box["last_pos"] = last_pos
        groups = (plan.fetch_thunks_forward(home, residency) if residency is not None
                  else plan.fetch_groups_forward(home))
        try:
            ex.run(None, groups, mode=mode, prefetch=pf, stats=stats,
                   group_keys=[g.key for g in plan.groups])
            return box["logits"], box["caches"]
        finally:
            box.clear()  # keep no landed group alive between calls

    prefill.close = ex.close  # type: ignore[attr-defined]
    prefill.residency = residency  # type: ignore[attr-defined]
    return prefill


def make_weight_streamed_decode_step(
    cfg: ModelConfig,
    plan: WeightStreamPlan,
    *,
    engine: TransferEngine,
    prefetch: Optional[PrefetchSpec] = None,
    stats: Optional[StreamStats] = None,
    paged: bool = True,
    residency: Optional[ResidencyCache] = None,
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """Streamed-parameter decode step.

    ``paged=True``: ``(home, view, batch, pos) -> (logits, caches)`` over a
    pager view, assembled into a dense cache (:func:`assemble_view`, inside
    a ``record_function`` span) and then decoded by the dense step, which is
    the step's ``.dense`` attribute.  ``paged=False``: ``(home, caches,
    batch, pos)`` over a dense cache, updated in place.  Per step the fetch
    groups stream in forward order while each layer group decodes into its
    ``narrow``ed layers of the cache.

    The JAX package's routed-expert decode (``route_experts``,
    ``expert_stats``) needs the MoE layers (ROADMAP.md, queue 1 item 7):
    the plan refuses expert streaming, and ``.expert_stats`` is ``None``.
    Per-group shardings (``param_shardings``) need a mesh (item 5)."""
    pf, mode = _stream_mode(plan, prefetch)
    # one fetch group per stream unit without expert streaming
    prog = [plan.groups[0]] + [plan.groups[u.gidx[0]] for u in plan.units] + [plan.groups[-1]]
    head_pos = len(prog) - 1
    box: dict = {}

    def apply(i, carry, group):
        g = prog[i]
        _cache_put(residency, plan, g, group)
        if i == 0:
            box["x"] = transformer.embed_stage(cfg, group, box["batch"], pos=box["pos"])
            box["angles"] = transformer.stage_angles(cfg, box["batch"], 1, pos=box["pos"])
            return None
        if i == head_pos:
            box["logits"] = transformer.head_stage_logits(cfg, group, box["x"])
            return None
        box["x"], _ = transformer.block_group_decode(
            cfg, group, _layer_view(box["caches"], g.lo, g.hi), box["x"], box["angles"],
            box["pos"])
        return None

    ex = HostStreamExecutor(apply, indexed=True, engine=engine)

    @torch.no_grad()
    def decode(home: dict, caches: dict, batch: dict, pos):
        box.clear()
        box.update(batch=batch, pos=pos, caches=caches)
        if residency is not None:
            groups = [(lambda g=g: plan.fetch_group(home, g, residency)) for g in prog]
        else:
            groups = [plan.fetch_group(home, g) for g in prog]
        try:
            ex.run(None, groups, mode=mode, prefetch=pf, stats=stats,
                   group_keys=[g.key for g in prog])
            return box["logits"], caches
        finally:
            box.clear()  # keep no landed group alive between steps

    decode.close = ex.close  # type: ignore[attr-defined]
    decode.residency = residency  # type: ignore[attr-defined]
    decode.expert_stats = None  # type: ignore[attr-defined]
    if not paged:
        return decode

    def paged_decode(home: dict, view, batch: dict, pos):
        with record_function("assemble_view"):
            dense = assemble_view(view)
        return decode(home, dense, batch, pos)

    paged_decode.close = ex.close  # type: ignore[attr-defined]
    paged_decode.dense = decode  # type: ignore[attr-defined]
    paged_decode.residency = residency  # type: ignore[attr-defined]
    paged_decode.expert_stats = None  # type: ignore[attr-defined]
    return paged_decode
