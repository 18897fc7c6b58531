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

The streamed-weight train step (``make_weight_streamed_train_step``) homes
the weights themselves off the card too, with their gradients and moments:
the forward, the reverse-order backward and the update each stream the
plan's groups, and the state is initialized group by group
(``init_weight_streamed_state``), so the whole model is never on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_array, host_tensor
from repro_torch.core.engine import EngineConfig, TransferEngine
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.kvpager import assemble_view, paged_cache_supported  # noqa: F401 (re-exported)
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.schedcheck import analyze_train_schedule, verify_schedule
from repro_torch.core.weightstream import PARAM_KINDS, WeightStreamPlan, merge_expert_slice
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.device import generator as make_generator
from repro_torch.models import moe, transformer
from repro_torch.models.layers import ParamTree
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_globals,
    adamw_globals_from_norm,
    adamw_init,
    adamw_leaf_update,
    adamw_update,
    is_state_leaf,
)
from repro_torch.parallel import local

Pytree = Any


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _value_and_grad(cfg: ModelConfig, params: Pytree, batch: dict, mesh=None, sharder=None):
    """``(loss, aux, grads)`` of ``transformer.lm_loss`` at ``params`` (the
    JAX package's ``jax.value_and_grad(lm_loss, argnums=1, has_aux=True)``):
    the leaves are detached and differentiated as fresh leaves, so the
    caller's tensors never carry autograd state.  Under a mesh the leaves
    are DTensors and so are the gradients, at the leaves' placements."""
    flat, treedef = tr.flatten(params.as_dict() if isinstance(params, ParamTree) else params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, aux = transformer.lm_loss(cfg, tr.unflatten(treedef, leaves), batch, mesh, sharder)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    aux = {k: v.detach() for k, v in aux.items()}
    # under a mesh the gradients are pinned to the parameters' layouts (the
    # JAX package's ``Sharder.grads``)
    grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), aux, tr.unflatten(treedef, grads)


def _placed_like(x, like):
    """``x`` at DTensor ``like``'s placements (the identity off a mesh)."""
    if not local.is_dtensor(like) or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def make_grad_step(cfg: ModelConfig, mesh=None,
                   sharder=None) -> Callable[[Pytree, dict], tuple[torch.Tensor, dict, Pytree]]:
    """``(params, batch) -> (loss, aux, grads)`` — the forward/backward half
    of the train step, split out so the optimizer half can run through the
    host-streaming engine.  ``mesh`` and ``sharder``: the parameters are
    DTensors and the Sharder runs in the layer body
    (:func:`repro_torch.models.transformer.forward_hidden`)."""

    def grad_step(params, batch):
        return _value_and_grad(cfg, params, batch, mesh, sharder)

    return grad_step


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None, sharder=None
) -> Callable[[Pytree, dict, dict], tuple[Pytree, dict, dict]]:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``; under
    a mesh the parameters and the AdamW state are DTensors (the train plan's
    layouts) and every leaf's update runs on its local shard."""
    grad_step = make_grad_step(cfg, mesh, sharder)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_step(params, batch)
        new_params, new_opt, om = adamw_update(
            opt_cfg, grads, opt_state, compute_dtype=cfg.compute_dtype
        )
        if mesh is not None or sharder is not None:
            # the step's out-shardings: the state keeps its layouts
            new_params = tr.tree_map(_placed_like, new_params, params)
            new_opt = tr.tree_map(_placed_like, new_opt, opt_state)
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
        return x if x.is_meta else host_array(x.detach().to("cpu", copy=True))
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
    state_shardings: Optional[Pytree] = None,
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

    Under a mesh the gradients are DTensors (they pass through) and
    ``state_shardings`` (a tree of
    :class:`~repro_torch.core.memkind.Sharding` shaped as
    ``host_state["leaves"]``) stages each rank's shard of the moments at
    the train plan's layouts; the updated moments drain whole (gathered at
    the writeback) and the new parameters stay DTensors.
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
        group_sh = None
        if state_shardings is not None:
            from repro_torch.core.memkind import Sharding

            flat_sh = tr.flatten(state_shardings, is_leaf=lambda x: isinstance(x, Sharding))[0]
            per_leaf = [dict(zip(("m", "master", "v"), flat_sh[3 * j:3 * j + 3]))
                        for j in range(len(flat_g))]
            group_sh = [{"g": (None,) * (bounds[i + 1] - bounds[i]),
                         "s": tuple(per_leaf[bounds[i]:bounds[i + 1]])}
                        for i in range(len(bounds) - 1)]
        _, state_outs = ex.run(
            glob, groups, mode=mode, prefetch=prefetch, stats=stats, group_shardings=group_sh,
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
    mesh=None,
    sharder=None,
    state_shardings: Optional[Pytree] = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``(state, batch) -> (state, metrics)`` with a host-resident optimizer.

    ``state = {"params": device tree, "opt": host_opt_state(...)}``.  The
    forward/backward half runs on the device; the AdamW half streams the
    host-kind moments through the transfer engine
    (:func:`make_streamed_opt_updater`).  With ``spill_store``, moment
    groups spilled to the ``DiskHost`` tier (:func:`spill_opt_state`) stream
    disk -> host -> device and write back to disk.  Under a mesh the
    parameters are DTensors, the ``sharder`` runs in the layer body and
    ``state_shardings`` lays the moments out (:func:`make_streamed_opt_updater`)."""
    grad_fn = make_grad_step(cfg, mesh, sharder)
    updater = make_streamed_opt_updater(
        opt_cfg, compute_dtype=cfg.compute_dtype, n_groups=n_groups, prefetch=prefetch,
        engine=engine, spill_store=spill_store, device=device, state_shardings=state_shardings,
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
    cfg: ModelConfig, batch_size: int, seq_len: int, mesh=None, sharder=None
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, batch, last_pos=None) -> (logits, caches)``.

    Caches for a context of ``seq_len`` are created inside the step (zeros,
    on the batch's device) and filled in place by the prefill.  With a
    ``sharder`` they are DTensors at its plan's cache specs (each rank
    makes its own shard) and the Sharder runs in the layer body."""

    @torch.no_grad()
    def prefill_step(params: ParamTree, batch: dict, last_pos: Optional[int] = None):
        caches = transformer.init_caches(
            cfg, batch_size, seq_len, cfg.compute_dtype, transformer.batch_device(batch)
        )
        if sharder is not None:
            caches = place_caches(sharder.plan, caches, batch_size)
        return transformer.prefill(cfg, params, batch, caches, last_pos=last_pos, mesh=mesh,
                                   sharder=sharder)

    return prefill_step


def place_caches(plan, caches: dict, batch_size: int) -> dict:
    """Caches as DTensors at ``plan``'s cache specs, each rank cutting its
    own shard of the same values (no broadcast)."""
    from repro_torch.parallel import sharding as sh

    specs = sh.cache_specs_tree(plan, caches, batch_size)
    return sh.distribute_tree(caches, plan.mesh, specs, src_data_rank=None)


def make_decode_step(cfg: ModelConfig, mesh=None,
                     sharder=None) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, caches, batch, pos) -> (logits, caches)`` — one new token
    against populated caches, which are updated in place (DTensors, with a
    ``sharder`` in the layer body, under a mesh)."""

    @torch.no_grad()
    def decode_step(params: ParamTree, caches: dict, batch: dict, pos):
        return transformer.decode_step(cfg, params, batch, caches, pos, mesh=mesh, sharder=sharder)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig, mesh=None,
                           sharder=None) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, view, batch, pos) -> (logits, caches)`` over a paged KV
    cache (see :mod:`repro_torch.core.kvpager`).

    ``view`` is the pager's per-slot tuple of page trees; ``pos`` is the (B,)
    vector of per-slot context positions.  :func:`assemble_view` copies the
    pages into a fresh dense cache, then the step of :func:`make_decode_step`
    runs on it, so paged and unpaged decode run the same code on the same
    values.  The returned caches are that assembled view, updated in place.
    The assembly runs inside a ``record_function`` span, which a profiler
    reads.  Under a mesh the pages are DTensors at the pager's page
    shardings, and so is the assembled cache."""
    decode_fn = make_decode_step(cfg, mesh, sharder)

    def paged_decode_step(params: ParamTree, view, batch: dict, pos):
        with record_function("assemble_view"):
            dense = assemble_view(view)
        return decode_fn(params, dense, batch, pos)

    return paged_decode_step


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None) -> ParamTree:
    """Serving parameters in the compute dtype from ``seed`` on ``device``:
    bitwise ``transformer.init_model(cfg, generator(seed))`` cast to the
    compute dtype (as the JAX package's ``init_train_state`` casts them),
    built group by group so that a model near the card's size fits.

    The shell is drawn first, then each layer (a period unit of a
    period-scanned stack) in :func:`~repro_torch.models.transformer.init_model`'s
    draw order, each cast into leaves allocated once in the compute dtype:
    at most one layer's f32 slice is held beside the finished tree."""
    dev = resolve_device(device)
    dtype = cfg.compute_dtype
    gen = make_generator(seed, dev)
    shell = transformer.init_model_shell(cfg, gen, dev)
    tree = {k: tr.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, shell.pop(k))
            for k in list(shell)}
    blocks = tr.tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=dev),
                         abstract_params(cfg)["blocks"])

    def put(dst: dict, src: dict, i: Optional[int]) -> None:
        # copy_ casts as .to(dtype) does, without a second copy of the slice
        for k, v in src.items():
            if isinstance(v, Mapping):
                put(dst[k], v, i)
            else:
                (dst[k] if i is None else dst[k][i:i + 1]).copy_(v)

    if cfg.uniform_blocks and cfg.use_scan:
        for i in range(cfg.n_layers):
            put(blocks, transformer.init_model_slice(cfg, gen, dev, i, i + 1), i)
        lo = cfg.n_layers
    elif cfg.period_scan:
        lo = cfg.n_layers // cfg.scan_period
        for j in range(lo):
            put(blocks["periods"], transformer.init_model_period_slice(cfg, gen, dev, j, j + 1), j)
        lo *= cfg.scan_period
    else:
        lo = 0
    for i in range(lo, cfg.n_layers):  # named blocks: a period stack's tail, or unrolled
        put(blocks, transformer.init_model_slice(cfg, gen, dev, i, i + 1), None)
    tree["blocks"] = blocks
    return ParamTree(tree)


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
    mesh=None,
    sharder=None,
    param_shardings: Optional[Pytree] = None,
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(home, batch, last_pos=None) -> (logits, caches)`` with the
    parameters streamed group by group from ``home`` (a plan home) through
    ``engine``.  The dense caches are created at the embed stage and each
    layer group prefills into its ``narrow``ed layers, so no slice is
    concatenated afterwards.

    A ``moe`` unit (expert streaming) runs once all of its groups have
    landed: the non-expert group and every expert, merged
    (:func:`~repro_torch.core.weightstream.merge_expert_slice`) into the
    slice the un-split layer group would have carried.

    ``residency`` keeps landed groups on the device across calls: serve
    parameters never change, so a resident group passes through the engine
    at zero requests on every later prefill or decode step until the LRU
    evicts it.  The step has ``close`` (the executor's) and ``residency``.

    Under a mesh, ``param_shardings`` stages each group at its layout
    (:meth:`WeightStreamPlan.group_shardings`), the caches are DTensors at
    the ``sharder``'s plan's cache specs, and the Sharder runs in the layer
    body."""
    pf, mode = _stream_mode(plan, prefetch)
    head_idx = plan.n_groups - 1
    msh = dict(mesh=mesh, sharder=sharder)
    sh_fwd = plan.group_shardings(param_shardings)
    #: group index -> (its unit, whether it is the unit's last group)
    unit_of = {gi: (u, j == len(u.gidx) - 1) for u in plan.units for j, gi in enumerate(u.gidx)}
    box: dict = {}

    def apply(i, carry, group):
        g = plan.groups[i]
        _cache_put(residency, plan, g, group)
        if i == 0:
            x = transformer.embed_stage(cfg, group, box["batch"], **msh)
            box["x"] = x
            box["angles"] = transformer.stage_angles(cfg, box["batch"], x.shape[1])
            box["caches"] = transformer.init_caches(cfg, batch_size, seq_len, cfg.compute_dtype,
                                                    transformer.batch_device(box["batch"]))
            if sharder is not None:
                box["caches"] = place_caches(sharder.plan, box["caches"], batch_size)
            return None
        if i == head_idx:
            xl = transformer._last(box["x"], box["last_pos"])
            box["logits"] = transformer.head_stage_logits(cfg, group, xl)
            return None
        u, last = unit_of[i]
        box.setdefault("parts", []).append(group)
        if not last:
            return None
        parts = box.pop("parts")
        sl = parts[0] if u.kind != "moe" else merge_expert_slice(parts[0], parts[1:])
        box["x"], _ = transformer.block_group_prefill(
            cfg, sl, _layer_view(box["caches"], u.lo, u.hi), box["x"], box["angles"],
            sharder=sharder)
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
            ex.run(None, groups, mode=mode, prefetch=pf, stats=stats, group_shardings=sh_fwd,
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
    route_experts: bool = True,
    expert_stats: Optional[StreamStats] = None,
    mesh=None,
    sharder=None,
    param_shardings: Optional[Pytree] = None,
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """Streamed-parameter decode step.

    ``paged=True``: ``(home, view, batch, pos) -> (logits, caches)`` over a
    pager view, assembled into a dense cache (:func:`assemble_view`, inside
    a ``record_function`` span) and then decoded by the dense step, which is
    the step's ``.dense`` attribute.  ``paged=False``: ``(home, caches,
    batch, pos)`` over a dense cache, updated in place.  Per step the fetch
    groups stream in forward order while each layer group decodes into its
    ``narrow``ed layers of the cache.

    Route-aware expert streaming (``plan.expert_stream``): the pipeline
    fetches only each MoE layer's non-expert group; the stage runs the
    router first (:func:`transformer.block_decode_pre_moe`), then only the
    routed experts' groups are fetched through the engine (submit all, then
    wait in order), and resident experts (the expert-granular LRU in
    ``residency``) pass at zero link bytes.  ``route_experts=False`` fetches
    all E experts through the same path (the all-expert baseline).  Expert
    traffic is counted in ``expert_stats`` (the step's ``.expert_stats``;
    one coalesced request a fetched expert group).  The routed rows are
    gathered before any arithmetic (:func:`~repro_torch.models.moe.decode_apply`
    on the fetched subset, ``top_i`` remapped into it), so routed decode
    gives the all-expert and device-resident runs' bits.  The routed set is
    read on the host: one device sync a MoE layer.

    Under a mesh, ``param_shardings`` stages each pipeline group (and each
    routed expert group) at its layout, and the ``sharder`` runs in the
    layer body on the DTensor caches."""
    pf, mode = _stream_mode(plan, prefetch)
    msh = dict(mesh=mesh, sharder=sharder)
    sh_all = plan.group_shardings(param_shardings)
    if plan.expert_stream and expert_stats is None:
        expert_stats = StreamStats()
    # the pipeline program: each unit's first group (experts are fetched on
    # demand, after the router has run)
    prog = [plan.groups[0]] + [plan.groups[u.gidx[0]] for u in plan.units] + [plan.groups[-1]]
    head_pos = len(prog) - 1
    sh_prog = [sh_all[g.index] for g in prog] if sh_all is not None else None
    box: dict = {}

    def fetch_experts(home: dict, gs) -> list:
        """The routed expert groups through the engine: submit all, then
        wait in order, with the executor's accounting mirrored into
        ``expert_stats``; landed groups enter the residency LRU."""
        est = expert_stats
        futs = []
        live = 0
        for g in gs:
            tree = residency.lookup(g.key) if residency is not None else None
            if residency is not None and getattr(residency, "sanitize", False):
                residency.sanitize_home(g.key, home["groups"][g.key], hit=tree is not None)
            if tree is None:
                tree = home["groups"][g.key]
            fut = engine.submit_group(
                g.index, tree, key=g.key,
                device_shardings=sh_all[g.index] if sh_all is not None else None)
            est.n_transfers += 1
            est.n_groups += 1
            est.h2d_requests += fut.n_requests
            est.bytes_h2d += fut.nbytes
            est.disk_requests += fut.disk_requests
            est.bytes_disk += fut.disk_nbytes
            est.n_devices = max(est.n_devices, fut.n_devices)
            est.n_device_groups += fut.n_devices
            if fut.is_resident:
                est.cache_hits += 1
            else:
                est.cache_misses += 1
                est.unique_group_fetches += 1
                est.fetched_device_groups += fut.n_devices
            live += fut.nbytes
            est.peak_inflight_bytes = max(est.peak_inflight_bytes, live)
            futs.append((g, fut))
        parts = []
        for g, fut in futs:
            try:
                w = fut.wait()
            except BaseException:
                est.retries += fut.retries
                est.give_ups += 1
                raise
            est.retries += fut.retries
            est.transfer_wait_s += w
            est.wait_per_group.append(w)
            est.disk_wait_s += fut.disk_wait_s
            est.disk_wait_per_group.append(fut.disk_wait_s)
            landed = fut.group()
            if residency is not None:
                residency.put(g.key, landed, plan.group_bytes(g, fetch=False))
            parts.append(landed)
        return parts

    def moe_stage(u, group, cache_slice) -> torch.Tensor:
        """One MoE layer: attention and the router, the routed experts'
        fetch, then their FFN on the fetched subset."""
        x_attn, h2, top_w, top_i = transformer.block_decode_pre_moe(
            cfg, group, cache_slice, box["x"], box["angles"], box["pos"])
        with record_function("fetch_experts"):
            ids = (torch.unique(top_i) if route_experts
                   else torch.arange(cfg.n_experts, device=top_i.device))
            eg = plan.experts_for_layer(u.lo)
            parts = fetch_experts(box["home"], [eg[e] for e in ids.tolist()])
        stack = {n: torch.cat([t[n] for t in parts], dim=0) for n in plan.expert_names}
        local = torch.searchsorted(ids.to(top_i.dtype), top_i.contiguous())
        return x_attn + moe.decode_apply(cfg, stack, top_w, local, h2)

    def apply(i, carry, group):
        g = prog[i]
        _cache_put(residency, plan, g, group)
        if i == 0:
            box["x"] = transformer.embed_stage(cfg, group, box["batch"], pos=box["pos"], **msh)
            box["angles"] = transformer.stage_angles(cfg, box["batch"], 1, pos=box["pos"])
            return None
        if i == head_pos:
            box["logits"] = transformer.head_stage_logits(cfg, group, box["x"])
            return None
        u = plan.units[i - 1]
        if u.kind == "moe":
            box["x"] = moe_stage(u, group, _layer_view(box["caches"], g.lo, g.hi))
            return None
        box["x"], _ = transformer.block_group_decode(
            cfg, group, _layer_view(box["caches"], g.lo, g.hi), box["x"], box["angles"],
            box["pos"], sharder=sharder)
        return None

    ex = HostStreamExecutor(apply, indexed=True, engine=engine)

    @torch.no_grad()
    def decode(home: dict, caches: dict, batch: dict, pos):
        box.clear()
        box.update(batch=batch, pos=pos, caches=caches, home=home)
        if residency is not None:
            groups = [(lambda g=g: plan.fetch_group(home, g, residency)) for g in prog]
        else:
            groups = [plan.fetch_group(home, g) for g in prog]
        try:
            ex.run(None, groups, mode=mode, prefetch=pf, stats=stats, group_shardings=sh_prog,
                   group_keys=[g.key for g in prog])
            return box["logits"], caches
        finally:
            box.clear()  # keep no landed group alive between steps

    decode.close = ex.close  # type: ignore[attr-defined]
    decode.residency = residency  # type: ignore[attr-defined]
    decode.expert_stats = expert_stats  # type: ignore[attr-defined]
    if not paged:
        return decode

    def paged_decode(home: dict, view, batch: dict, pos):
        with record_function("assemble_view"):
            dense = assemble_view(view)
        return decode(home, dense, batch, pos)

    paged_decode.close = ex.close  # type: ignore[attr-defined]
    paged_decode.dense = decode  # type: ignore[attr-defined]
    paged_decode.residency = residency  # type: ignore[attr-defined]
    paged_decode.expert_stats = expert_stats  # type: ignore[attr-defined]
    return paged_decode


# ---------------------------------------------------------------------------
# streamed weights: training with the weights, gradients and moments homed
# off the card
# ---------------------------------------------------------------------------


def _groupwise_f32(cfg: ModelConfig, plan: WeightStreamPlan, seed: int, device: DeviceLike):
    """``(group, f32 tree)`` for each of ``plan``'s groups in order, drawn as
    :func:`init_train_state` draws them from ``seed`` on ``device``: the
    shell first (the untied head goes to the host at once and comes back
    with its group, last), then each middle group's layers in layer order.
    A layer group is drawn only when the caller asks for it, so with each
    group homed before the next at most one is on the device.

    An expert-split plan draws one layer's whole slice at its non-expert
    group, hands out the slice without its experts, then each expert group's
    rows of the same slice: at most one layer's f32 slice is on the device
    (a caller drops each group before asking for the next)."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    shell = transformer.init_model_shell(cfg, gen, dev)
    head = {k: tr.tree_map(lambda t: t.cpu(), shell.pop(k)) for k in plan.head_home_keys}
    drawn = 0  # layers drawn so far: the generator's position
    layer = None  # the expert-split layer's slice, while its experts go out
    for g in plan.groups:
        if g.kind == "embed":
            yield g, {k: shell.pop(k) for k in plan.embed_keys}
        elif g.kind == "head":
            yield g, head
        elif g.kind == "expert":
            yield g, {n: layer["moe"][n][:, g.expert] for n in plan.expert_names}
        else:
            layer = None
            if g.lo != drawn:
                raise ValueError(f"group {g.key} starts at layer {g.lo}, the draws at {drawn}")
            if g.kind == "period":
                p = cfg.scan_period
                tree = transformer.init_model_period_slice(cfg, gen, dev, g.lo // p, g.hi // p)
            else:
                tree = transformer.init_model_slice(cfg, gen, dev, g.lo, g.hi)
            drawn = g.hi
            if plan.expert_stream:
                layer = tree
                tree = plan._strip_experts(tree)
            yield g, tree


def init_weight_streamed_params(cfg: ModelConfig, plan: WeightStreamPlan, seed: int = 0,
                                device: DeviceLike = None) -> dict:
    """The parameter home (compute-dtype host numpy, bf16 as
    :class:`~repro_torch.core.arrays.BF16HostArray`) initialized group by
    group on ``device``: bitwise ``plan.init_home`` of
    :func:`init_params`'s parameters, with at most one group on the device
    at a time, so a model larger than the card initializes under the
    budget."""
    groups = {}
    for g, f32 in _groupwise_f32(cfg, plan, seed, device):
        groups[g.key] = tr.tree_map(lambda p: _to_host(p.to(cfg.compute_dtype)), f32)
        del f32
    return {"groups": groups}


def init_weight_streamed_state(cfg: ModelConfig, plan: WeightStreamPlan, seed: int = 0,
                               device: DeviceLike = None, store=None) -> dict:
    """``{"params": home, "opt": {"groups": ..., "step": 0}}`` with host
    numpy leaves (the ``pinned_host`` home; :func:`spill_weight_streamed_state`
    and :func:`device_weight_streamed_state` re-home it), initialized group
    by group as :func:`init_weight_streamed_params`.  The AdamW masters are
    the f32 init values, as :func:`init_train_state`'s.  With a ``store``
    each group is spilled as it is drawn (the ``disk_host`` home of
    :func:`spill_weight_streamed_state`), so the host holds one group at a
    time."""
    p_groups, o_groups = {}, {}
    for g, f32 in _groupwise_f32(cfg, plan, seed, device):
        p_groups[g.key] = tr.tree_map(lambda p: _to_host(p.to(cfg.compute_dtype)), f32)
        o_groups[g.key] = host_opt_state(f32)["leaves"]
        del f32
        if store is not None:
            store.put(plan.spill_key(g), p_groups[g.key])
            store.put(f"wopt/{g.key}", o_groups[g.key])
            p_groups[g.key] = store.get(plan.spill_key(g))
            o_groups[g.key] = store.get(f"wopt/{g.key}")
    return {"params": {"groups": p_groups},
            "opt": {"groups": o_groups, "step": np.zeros((), np.int32)}}


def abstract_weight_streamed_state(cfg: ModelConfig, plan: WeightStreamPlan) -> dict:
    """:func:`init_weight_streamed_state`'s structure on the meta device:
    the driver's restore template."""
    home = plan.init_home(abstract_params(cfg))

    def leaf(p):
        f32 = torch.empty(p.shape, dtype=torch.float32, device="meta")
        return {"master": f32, "m": f32, "v": f32}

    opt = {k: tr.tree_map(leaf, t) for k, t in home["groups"].items()}
    return {"params": home,
            "opt": {"groups": opt, "step": torch.empty((), dtype=torch.int32, device="meta")}}


def spill_weight_streamed_state(plan: WeightStreamPlan, state: dict, store) -> dict:
    """Re-home a weight-streamed train state at the ``DiskHost`` tier: one
    spill chunk per parameter group (``wp/<key>``) and one per moment group
    (``wopt/<key>``), the JAX package's keys.  Shape-only templates and
    groups already on disk pass through (the launcher calls this after a
    restore, which hands back plain host arrays)."""
    from repro_torch.core.spillstore import is_disk_leaf

    home = plan.spill_home(state["params"], store)
    opt_groups = {}
    for g in plan.groups:
        tree = state["opt"]["groups"][g.key]
        leaves = tr.leaves(tree)
        if any(isinstance(x, torch.Tensor) and x.is_meta for x in leaves):
            return {"params": home, "opt": state["opt"]}
        if not all(is_disk_leaf(x) for x in leaves):
            store.put(f"wopt/{g.key}", tree)
            tree = store.get(f"wopt/{g.key}")
        opt_groups[g.key] = tree
    return {"params": home, "opt": {"groups": opt_groups, "step": state["opt"]["step"]}}


def device_weight_streamed_state(plan: WeightStreamPlan, state: dict,
                                 device: DeviceLike = None) -> dict:
    """The state with every parameter and moment group on ``device``: the
    ``param_kind="device"`` baseline, whose groups pass through the engine
    by reference."""
    dev = resolve_device(device)
    return {
        "params": plan.device_home(state["params"], device=dev),
        "opt": {"groups": tr.tree_map(lambda x: host_tensor(x).to(dev, copy=True),
                                      state["opt"]["groups"]),
                "step": state["opt"]["step"]},
    }


def _state_shardings(shardings: Pytree) -> Pytree:
    """The AdamW state's layouts from its parameters' (``master``, ``m`` and
    ``v`` share the parameter leaf's)."""
    from repro_torch.core.memkind import Sharding

    flat, treedef = tr.flatten(shardings, is_leaf=lambda x: isinstance(x, Sharding))
    return tr.unflatten(treedef, [{"master": s, "m": s, "v": s} for s in flat])


def _leaf_sqsums(tree: Pytree) -> tuple:
    """Per-leaf f32 squared sums, in the tree's leaf order: the partial terms
    of the global gradient norm, taken group by group so the whole gradient
    tree never exists on the device."""
    return tuple(torch.sum(torch.square(g.to(torch.float32))) for g in tr.leaves(tree))


def _vjp(fn: Callable, group: Pytree, xs: tuple = (), ct: Optional[torch.Tensor] = None,
         aux_ct: bool = False):
    """Run ``fn(group, *xs)`` on fresh leaves under autograd and pull back its
    output (its first element when it returns a tuple: a scalar loss, or a
    tensor whose cotangent is ``ct``).  With ``aux_ct`` the second element
    (a stage's aux-loss carry) is pulled back too, with a cotangent of 1, as
    the loss adds it; a carry that no parameter reaches (no MoE layer in the
    stage) adds nothing.  Returns ``(output, d group, d xs)``."""
    flat, treedef = tr.flatten(group)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    ins = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        out = fn(tr.unflatten(treedef, leaves), *ins)
        outs = [out[0] if isinstance(out, tuple) else out]
        cts = [ct]
        if aux_ct and out[1].requires_grad:
            outs.append(out[1])
            cts.append(torch.ones_like(out[1]))
        grads = torch.autograd.grad(outs, leaves + ins, grad_outputs=cts, materialize_grads=True)
    grads = [_placed_like(g, x) for g, x in zip(grads, leaves + ins)]
    return out, tr.unflatten(treedef, grads[:len(leaves)]), tuple(grads[len(leaves):])


def make_weight_streamed_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    plan: WeightStreamPlan,
    prefetch: Optional[PrefetchSpec] = None,
    engine: Optional[TransferEngine] = None,
    stats: Optional[StreamStats] = None,
    opt_stats: Optional[StreamStats] = None,
    spill_store=None,
    param_kind: str = "pinned_host",
    residency: Optional[ResidencyCache] = None,
    donate: bool = False,
    device: DeviceLike = None,
    mesh=None,
    sharder=None,
    param_shardings: Optional[Pytree] = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``(state, batch) -> (state, metrics)`` with the weights homed off the
    card (the JAX package's ``make_weight_streamed_train_step``).

    ``state`` is :func:`init_weight_streamed_state`'s: grouped parameter
    homes and grouped moments.  A step runs three streamed passes over the
    plan's groups through ``engine`` (default: one on ``device``, its
    window capped by the budget):

    forward
        fetch order ``embed, L0..Ln, head``; each group's stage runs while
        the next groups stream in.  The head stage computes the loss and the
        head and trunk gradients, so the head group is fetched once.
    backward
        reverse order ``Ln..L0, embed``: each group is fetched again and its
        forward recomputed from the saved boundary activation under
        ``torch.autograd.grad`` (checkpointing at group granularity), so the
        backward holds no more weights than the forward.  The gradients
        drain D2H through the engine's writeback, each copy waiting on an
        event recorded after its group's backward; the per-leaf squared sums
        stay on the device for the global norm, summed in one fixed order
        (head, then backward order).
    optimizer
        head first, then backward order: each group streams ``{grads,
        moments}`` H2D and its updated ``{params, moments}`` drain D2H on one
        writeback to the home kind.

    A plan's stage is its unit: one group, or for an expert-split MoE layer
    (``plan.expert_stream``) the layer's non-expert group and its expert
    groups, buffered until the last has landed and merged on the card
    (:func:`~repro_torch.core.weightstream.merge_expert_slice`) into the
    unsplit slice.  Every stage's backward pulls back the hidden state's
    cotangent and a cotangent of 1 for the stage's aux-loss carry (a MoE
    layer's load-balancing loss, which the loss adds).  A MoE unit's
    gradients drain at its non-expert group's position (a 0-d placeholder
    at each expert's) and are split back into the expert groups for the
    optimizer pass.

    ``param_kind`` names the home: ``pinned_host`` (host numpy),
    ``disk_host`` (``wp/<key>`` and ``wopt/<key>`` chunks of
    ``spill_store``) or ``device`` (the bitwise baseline: groups pass
    through the engine by reference, updated groups are placed back on the
    card).  Every kind runs the same eager programs on the same values, so
    every home gives the device home's bits.

    ``stats`` counts the two fetch passes (its ``peak_inflight_bytes`` is
    what the budget bounds); ``opt_stats`` the optimizer pass.
    ``residency`` (default: sized to the budget's slack,
    :meth:`WeightStreamPlan.residency_capacity_bytes`; unused at the device
    kind) keeps landed groups on the card, pins the last forward groups
    across the turnaround so the backward's first fetches hit, refreshes
    every cached group with its updated value in the optimizer pass, and is
    cleared when a step fails.  The step has ``close``, ``param_stats``,
    ``opt_stats``, ``engine`` and ``residency``.

    ``donate=True`` hands the step its input state, for a home too large to
    hold twice: the old parameter groups are dropped from ``state`` once the
    backward has read them, and the optimizer pass runs one group at a time,
    taking each old moment group (and its drained gradients) out of
    ``state``, releasing the engine's pooled staging buffers once the group
    has landed
    (:meth:`~repro_torch.core.engine.TransferEngine.release_buffers`) and
    re-homing its update as soon as it has drained.  The old and new homes
    then overlap by one group, and the host holds one group's staging or
    drains at a time.  The values and counters are the
    same; a donated state is empty after the step, and unusable after a
    failed one.

    ``param_shardings`` (a full-params tree of
    :class:`~repro_torch.core.memkind.Sharding`, under a mesh) stages every
    group at its layout (:meth:`WeightStreamPlan.group_shardings`): the
    forward and backward fetches at the fetch groups' layouts, the
    optimizer pass's gradients and moments at the home groups'.  Each rank
    moves its own shards (one H2D request a (rank, group)); the layer body
    runs on DTensors with ``sharder``; the gradients and updates drain as
    full host values (gathered at the writeback), so the home stays the
    one-device home.
    """
    if param_kind not in PARAM_KINDS:
        raise ValueError(f"unknown param_kind {param_kind!r}; expected one of {PARAM_KINDS}")
    if param_kind == "disk_host" and spill_store is None:
        raise ValueError("param_kind='disk_host' requires a spill_store")
    if not plan.support.supported:
        raise ValueError(plan.support.reason)
    prefetch = prefetch or PrefetchSpec(buffer_size=plan.n_groups + 2, distance=AUTO)
    mode = "on_demand" if prefetch.on_demand else "prefetch"
    pf = None if mode == "on_demand" else prefetch
    if residency is None and param_kind != "device":
        residency = ResidencyCache(plan.residency_capacity_bytes())
    # device homes already pass through at zero requests: caching them would
    # only alias the home groups
    cache = residency if param_kind != "device" else None
    cache_reserved = ((cache.capacity_bytes or 0)
                      if cache is not None and plan.device_budget_bytes is not None else 0)
    window_cap = plan.max_distance_for_budget(cached_bytes=cache_reserved)
    own_engine = engine is None
    if engine is None:
        engine = TransferEngine(EngineConfig(max_distance=window_cap), device=device)
    elif plan.device_budget_bytes is not None and engine.config.max_distance > window_cap:
        raise ValueError(
            f"engine max_distance={engine.config.max_distance} exceeds the device budget's "
            f"window cap {window_cap} (prefetch window + residency cache share the budget); "
            "configure the engine from the plan")
    # the static check first: a schedule that overruns the budget, re-fetches
    # through a pending writeback or over-pins fails here, not mid-run
    verify_schedule(analyze_train_schedule(
        plan, distance=engine.config.max_distance, cached=cache is not None,
        cache_capacity=cache.capacity_bytes if cache is not None else None,
        spill=param_kind == "disk_host"))
    stats = stats if stats is not None else StreamStats()
    opt_stats = opt_stats if opt_stats is not None else StreamStats()
    f32 = torch.float32

    head_idx = plan.n_groups - 1
    units = plan.units
    #: each unit's stage: ``(groups, x, aux, angles) -> (x, aux)``; a moe
    #: unit's groups (the layer's non-expert group, then its experts) merge
    #: into the unsplit slice on the card first
    stages: list = []
    msh = dict(mesh=mesh, sharder=sharder)
    for u in units:
        g = plan.groups[u.gidx[0]]
        if u.kind == "moe":
            stages.append(lambda ps, x, a, ang: transformer.block_group_train(
                cfg, merge_expert_slice(ps[0], ps[1:]), x, a, ang, **msh))
        elif u.kind == "layers":
            stages.append(lambda ps, x, a, ang: transformer.block_group_train(
                cfg, ps[0], x, a, ang, **msh))
        elif u.kind == "period":
            stages.append(lambda ps, x, a, ang: transformer.period_group_train(
                cfg, ps[0], x, a, ang, sharder=sharder))
        else:
            kinds = tuple((name, cfg.block_kind(layer))
                          for name, layer in zip(plan.block_names(g), range(g.lo, g.hi)))
            stages.append(lambda ps, x, a, ang, kinds=kinds: transformer.hetero_group_train(
                cfg, kinds, ps[0], x, a, ang, sharder=sharder))
    #: middle group index -> (unit position, True when the group completes
    #: its unit in forward fetch order)
    unit_pos: dict = {}
    for u_i, u in enumerate(units):
        for j, gi in enumerate(u.gidx):
            unit_pos[gi] = (u_i, j == len(u.gidx) - 1)
    #: backward program: the middle groups reversed, then embed
    bwd_order = [plan.groups[i] for i in range(head_idx - 1, 0, -1)] + [plan.groups[0]]
    #: optimizer program: head first (its gradients were born on the card)
    o_order = [plan.groups[-1]] + bwd_order

    # the turnaround pins: the backward wants first what the forward fetched
    # last, so as many of those as the cache holds stay through the turn
    pin_keys: frozenset = frozenset()
    if cache is not None:
        picked, total = [], 0
        for g in bwd_order:
            nb = plan.group_bytes(g, fetch=False)
            if cache.capacity_bytes is not None and total + nb > cache.capacity_bytes:
                break
            picked.append(g.key)
            total += nb
        pin_keys = frozenset(picked)

    def store(g, fetched, *, pinned: bool = False) -> None:
        """Offer a landed group to the cache (its home part: the tied head's
        borrowed table belongs to the embed group's entry)."""
        if cache is not None:
            cache.put(g.key, plan.cache_home_tree(g, fetched), plan.group_bytes(g, fetch=False),
                      pinned=pinned)

    box: dict = {}

    def apply_f(i, carry, group):
        g = plan.groups[i]
        store(g, group, pinned=g.key in pin_keys)
        batch = box["batch"]
        if i == 0:
            x = transformer.embed_stage(cfg, group, batch, **msh)
            box.update(x=x, angles=transformer.stage_angles(cfg, batch, x.shape[1]),
                       aux=transformer._zero_like(x), acts={}, parts=[])
            return None
        if i == head_idx:
            (loss, metrics), dp, (dx,) = _vjp(
                lambda p, x: transformer.head_stage_loss(cfg, p, x, box["aux"], batch),
                group, (box["x"],))
            dp_home, dp_embed = plan.split_head_grads(dp)
            box.update(loss=loss.detach(), metrics={k: v.detach() for k, v in metrics.items()},
                       dp_head=dp_home, dp_head_embed=dp_embed, ct=dx,
                       sq=[_leaf_sqsums(dp_home)])
            return None
        u_i, last = unit_pos[i]
        box["parts"].append(group)
        if not last:  # a moe unit: buffered until its last group has landed
            return None
        parts, box["parts"] = box["parts"], []
        box["acts"][u_i] = box["x"]  # the unit's boundary activation
        box["x"], box["aux"] = stages[u_i](parts, box["x"], box["aux"], box["angles"])
        return None

    def apply_b(i, carry, group):
        g = bwd_order[i]
        store(g, group)
        batch = box["batch"]
        if g.kind == "embed":
            _, dp, _ = _vjp(lambda p: transformer.embed_stage(cfg, p, batch, **msh), group,
                            ct=box["ct"])
            if box["dp_head_embed"] is not None:
                # a tied head: the table's gradient is the gather path's plus
                # the head path's, added in this order on every home
                dp["embed"] = tr.tree_map(lambda a, b: a + b.to(a.dtype), dp["embed"],
                                          box["dp_head_embed"])
            box["sq"].append(_leaf_sqsums(dp))
            return None, dp
        u_i, _ = unit_pos[g.index]
        box["parts"].append(group)
        if g.index != units[u_i].gidx[0]:
            # a moe unit's experts land (reversed) before its non-expert
            # group; their gradients drain at that group's position, and a
            # placeholder keeps the writeback stream one output a group
            return None, transformer._zero_like(box["ct"])
        parts = box["parts"][::-1]  # fetch order: non-expert group, experts
        box["parts"] = []
        fn = stages[u_i]
        _, dp, (dx,) = _vjp(lambda ps, x: fn(ps, x, box["aux0"], box["angles"]), tuple(parts),
                            (box["acts"].pop(u_i),), box["ct"], aux_ct=True)
        box["ct"] = dx
        box["sq"].append(_leaf_sqsums(dp))
        return None, (dp[0] if len(dp) == 1 else {"ne": dp[0], "ex": dp[1:]})

    def apply_o(i, carry, group):
        if donate:  # one group a run: its staging has landed, let it go first
            engine.release_buffers()
            i = box["o_base"]
        flat_g, treedef = tr.flatten(group["g"])
        flat_s = tr.flatten(group["s"], is_leaf=is_state_leaf)[0]
        out = [adamw_leaf_update(opt_cfg, box["glob"], gr, s) for gr, s in zip(flat_g, flat_s)]
        new_p = tr.unflatten(treedef, [p.to(cfg.compute_dtype) for p, _ in out])
        new_s = tr.unflatten(treedef, [s for _, s in out])
        if cache is not None:
            # the update made every cached copy of this group stale; new_p is
            # the exact value the drain re-homes, so refreshing with it keeps
            # the cache bitwise a re-fetch of the new home
            g = o_order[i]
            cache.refresh(g.key, plan.cache_home_tree(g, new_p), plan.group_bytes(g, fetch=False))
        return None, {"p": new_p, "s": new_s}

    dev = engine.device
    ex_f = HostStreamExecutor(apply_f, indexed=True, engine=engine)
    ex_b = HostStreamExecutor(apply_b, indexed=True, writeback=True, engine=engine)
    ex_o = HostStreamExecutor(apply_o, indexed=True, writeback=True, engine=engine)

    # the layouts of each pass's groups under a mesh (None: one device)
    sh_fwd = plan.group_shardings(param_shardings)
    sh_home = plan.home_group_shardings(param_shardings)
    sh_bwd = sh_o = None
    if param_shardings is not None:
        sh_bwd = [sh_fwd[g.index] for g in bwd_order]
        home_of = {g.key: h for g, h in zip(plan.groups, sh_home)}
        sh_o = [{"g": home_of[g.key], "s": _state_shardings(home_of[g.key])} for g in o_order]

    def rehome(g, out):
        p_new = tr.tree_map(host_array, out["p"])
        s_new = tr.tree_map(host_array, out["s"])
        if param_kind == "disk_host":
            spill_store.put(plan.spill_key(g), p_new)
            spill_store.put(f"wopt/{g.key}", s_new)
            return spill_store.get(plan.spill_key(g)), spill_store.get(f"wopt/{g.key}")
        if param_kind == "device":
            if sh_home is not None:  # back to the group's home layout
                hs = sh_home[g.index]
                return (tr.tree_map(lambda x, sh: sh.put(x), p_new, hs),
                        tr.tree_map(lambda x, sh: sh.put(x), s_new, _state_shardings(hs)))
            return (tr.tree_map(lambda x: host_tensor(x).to(dev), p_new),
                    tr.tree_map(lambda x: host_tensor(x).to(dev), s_new))
        return p_new, s_new  # pinned_host: the drained host arrays are the home

    @torch.no_grad()
    def step_body(state, batch):
        home, opt = state["params"], state["opt"]
        box.clear()
        box["batch"] = batch
        # phase F: with a cache the fetches are thunks resolved at submit
        # time, so each sees the cache as it is when its transfer goes out
        fwd = (plan.fetch_thunks_forward(home, cache) if cache is not None
               else plan.fetch_groups_forward(home))
        ex_f.run(None, fwd, mode=mode, prefetch=pf, stats=stats, group_shardings=sh_fwd,
                 group_keys=[g.key for g in plan.groups])
        # phase B: reverse order; the gradients drain D2H
        box["aux0"] = transformer._zero_like(box["ct"])
        if cache is not None:
            bwd = [(lambda g=g: plan.fetch_group(home, g, cache)) for g in bwd_order]
        else:
            bwd = [fwd[g.index] for g in bwd_order]
        _, grad_outs = ex_b.run(None, bwd, mode=mode, prefetch=pf, stats=stats,
                                group_shardings=sh_bwd, group_keys=[g.key for g in bwd_order])
        if donate:  # no later pass reads the old parameters
            del fwd, bwd
            home["groups"].clear()
            engine.release_buffers()
        step_no = int(np.asarray(opt["step"])) + 1
        sq = [s for chunk in box["sq"] for s in chunk]
        box["glob"] = adamw_globals_from_norm(opt_cfg, torch.sqrt(torch.sum(torch.stack(sq))),
                                              step_no)
        # phase O: {grads, moments} in, {params, moments} out on one drain
        # a moe unit drained all its gradients at its non-expert group: split
        # them back out, so that every group (experts too) updates on its own
        grads = {plan.groups[-1].key: box.pop("dp_head")}
        for g, out in zip(bwd_order, grad_outs):
            if g.kind == "expert":
                continue
            out = tr.tree_map(host_array, out)
            u = units[unit_pos[g.index][0]] if g.index in unit_pos else None
            if u is not None and u.kind == "moe":
                grads[g.key] = out["ne"]
                grads.update((plan.groups[gi].key, ex) for gi, ex in zip(u.gidx[1:], out["ex"]))
            else:
                grads[g.key] = out
        new_home, new_opt = {}, {}
        if donate:  # one group a run: its old state out, its update re-homed
            del grad_outs, out
            for i, g in enumerate(o_order):
                box["o_base"] = i
                _, (out,) = ex_o.run(
                    None, [{"g": grads.pop(g.key), "s": opt["groups"].pop(g.key)}], mode=mode,
                    prefetch=pf, stats=opt_stats, group_keys=[g.key],
                    group_shardings=[sh_o[i]] if sh_o is not None else None)
                engine.release_buffers()
                new_home[g.key], new_opt[g.key] = rehome(g, out)
                del out
        else:
            o_groups = [{"g": grads.pop(g.key), "s": opt["groups"][g.key]} for g in o_order]
            _, o_outs = ex_o.run(None, o_groups, mode=mode, prefetch=pf, stats=opt_stats,
                                 group_shardings=sh_o, group_keys=[g.key for g in o_order])
            del o_groups
            for g, out in zip(o_order, o_outs):
                new_home[g.key], new_opt[g.key] = rehome(g, out)
        glob = box["glob"]
        metrics = {k: local.full_local(v) for k, v in
                   {"loss": box["loss"], **box["metrics"], "grad_norm": glob["grad_norm"],
                    "lr": glob["lr"]}.items()}
        # the step's device scratch (activations, cotangents) must not outlive
        # it into the checkpoint and data gap
        box.clear()
        return ({"params": {"groups": {g.key: new_home[g.key] for g in plan.groups}},
                 "opt": {"groups": {g.key: new_opt[g.key] for g in plan.groups},
                         "step": np.asarray(step_no, np.int32)}},
                metrics)

    def step_fn(state, batch):
        if cache is None:
            return step_body(state, batch)
        try:
            return step_body(state, batch)
        except BaseException:
            # a step that died mid-update leaves some cached groups refreshed
            # and some stale: only an empty cache is safe
            cache.clear()
            raise
        finally:
            cache.unpin_all()

    def close():
        for ex in (ex_f, ex_b, ex_o):
            ex.close()
        if own_engine:
            engine.close()
        if cache is not None:
            cache.clear()  # release the resident device copies

    step_fn.close = close  # type: ignore[attr-defined]
    step_fn.param_stats = stats  # type: ignore[attr-defined]
    step_fn.opt_stats = opt_stats  # type: ignore[attr-defined]
    step_fn.engine = engine  # type: ignore[attr-defined]
    step_fn.residency = cache  # type: ignore[attr-defined]
    return step_fn
