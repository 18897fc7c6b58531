"""Step builders for serving: prefill and decode, plus parameter and cache
setup.

Counterparts of the JAX package's ``make_prefill_step`` /
``make_decode_step`` / ``make_paged_decode_step`` and its streamed-weight
serving steps (``repro/train/steps.py``).  PyTorch runs eagerly, so a
"step" is a plain closure; there is nothing to trace or compile.  The
training steps, the streamed train step and the group-wise parameter init
follow with training (ROADMAP.md, queue 1 item 6).
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import TransferEngine
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.kvpager import assemble_view, paged_cache_supported  # noqa: F401 (re-exported)
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.device import generator as make_generator
from repro_torch.models import transformer
from repro_torch.models.layers import ParamTree


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
