"""Logical-axis sharding rules: param/optimizer/batch/cache specs, on
``torch.distributed``.

The JAX package's ``parallel/sharding.py``: the same rules give the same
specs leaf for leaf.  A spec is a :class:`P`, one entry per tensor dim
(``None``, a mesh axis name or a tuple of names, major to minor), compared
to JAX's ``PartitionSpec`` as a tuple.  :func:`placements` turns it into
DTensor placements on a ``DeviceMesh`` whose dims carry the axis names.

Mesh axes:
  ``("data", "model")``           single pod (16 x 16)
  ``("pod", "data", "model")``    multi-pod  (2 x 16 x 16)

Parallelism scheme:
  * batch/activations  -> all non-``model`` axes (``pod`` is pure DP),
  * TP: one tensor dim per leaf over ``model`` (first divisible candidate),
  * FSDP (train plan): one further dim over ``data`` — params + optimizer
    state fully sharded, gathered per layer (ZeRO-3),
  * serve plan: TP everywhere; ``data``-axis sharding only for MoE expert
    leaves; KV caches shard batch over ``data`` and heads/head_dim over
    ``model``.

Every rule is divisibility-checked against the actual leaf shape; dims that
cannot be evenly sharded fall through to the next candidate (or stay
replicated), so *any* architecture gets a plan on *any* mesh.

A plan's mesh is a ``DeviceMesh`` or any object with the reference's
shape-only interface (``shape`` a dict of axis sizes, ``axis_names``).
The model's layer body calls the :class:`Sharder`
(``models/transformer.py``); the engine, the pager and the streamed steps
take :func:`named_shardings` of the specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import tree as tr

Pytree = Any

__all__ = ["P", "ShardingPlan", "Sharder", "batch_spec", "batch_specs", "cache_specs_tree",
           "distribute_tree", "make_plan", "make_sharder", "named_shardings", "opt_state_specs",
           "param_specs", "per_device_bytes", "placements", "recommended_plan", "sharding_report"]


# ---------------------------------------------------------------------------
# the spec and the mesh
# ---------------------------------------------------------------------------

def _norm_entry(p):
    if isinstance(p, list):
        p = tuple(p)
    if isinstance(p, tuple):
        if not p:
            return None
        if len(p) == 1:
            return p[0]
    return p


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (major to minor).  Normalised as
    JAX's ``PartitionSpec`` (a list becomes a tuple, a one-name tuple the
    name, an empty tuple ``None``), and printed as it prints."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a shape-only mesh."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(_axis_names(mesh), mesh.shape))


def _spec_axes(ax) -> tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    for the tensor dim ``d`` that names it, else ``Replicate()``.

    A dim over several axes, as ``P(("pod", "data"))``, is split major to
    minor in JAX; DTensor splits a dim by its mesh dims in mesh order, so
    the two layouts agree when the names come in the mesh's order (every
    spec of the plan does).  Another order would need a strided placement
    and is refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    owner: dict[str, int] = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = _spec_axes(ax)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec} names mesh axis {a!r}; the mesh has {names}")
            if a in owner:
                raise ValueError(f"{spec} shards two dims over mesh axis {a!r}")
            owner[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec} orders {axes} against the mesh's {names}: "
                             f"DTensor would lay the shards out in another order")
    sizes = getattr(mesh, "shape", None)
    sizes = tuple(sizes) if sizes is not None and not isinstance(sizes, Mapping) else (0,) * len(names)
    # a dim split over a mesh dim of one rank is whole there: Replicate is
    # the same layout, and DTensor's view ops refuse some reshapes of a
    # dim "sharded" one way
    return tuple(Shard(owner[n]) if n in owner and size != 1 else Replicate()
                 for n, size in zip(names, sizes))


# ---------------------------------------------------------------------------
# trees (nested dicts, the port's param / state / cache layout)
# ---------------------------------------------------------------------------

def _as_tree(tree):
    return tree.as_dict() if hasattr(tree, "as_dict") else tree


def _map_with_path(fn: Callable, tree, *rest, path: tuple = (), is_leaf=None):
    """``fn(path, leaf, *rest_leaves)`` over a tree of nested dicts; ``rest``
    are trees of the same keys (or prefixes of them whose leaves stop
    earlier: ``is_leaf`` says where)."""
    tree = _as_tree(tree)
    if isinstance(tree, Mapping) and not (is_leaf and is_leaf(tree)):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),),
                                  is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def _map_specs(fn: Callable, specs, *rest):
    """``fn`` over the :class:`P` leaves of a spec tree (and the matching
    leaves of ``rest``)."""
    return _map_with_path(lambda _, s, *r: fn(s, *r), specs, *rest, is_leaf=_is_spec)


def _flatten_with_path(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the order of ``core.tree.flatten`` (sorted keys)."""
    tree = _as_tree(tree)
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in _flatten_with_path(tree[k], path + (str(k),))]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# leaf rules: name -> (tp_candidates, fsdp_candidates) as dim indices
# (negative = from the right, applied after stripping a stacked layer dim).
# Order within each list = preference; first divisible dim wins.
# ---------------------------------------------------------------------------

# (name, base_ndim) -> rule; base_ndim=None matches any rank
_RULES: dict[tuple[str, Optional[int]], tuple[tuple[int, ...], tuple[int, ...]]] = {
    # embeddings / head: vocab over model; NO data-sharding — an FSDP-sharded
    # contraction dim on the head partial-sums the full (B,S,V) logits over
    # data.  The table itself is ALSO vocab-sharded: a D-sharded table makes
    # the tied-embedding head (bsd,vd->bsv) partial-sum a full (B,S,V) f32
    # tensor over model; vocab-sharding turns the token gather into a masked
    # local gather + one small (B,S,D) sum instead.
    ("tok", None): ((0,), ()),
    ("out", None): ((-1,), ()),
    # attention
    ("wq", None): ((-2, -1), (-3,)),
    ("wk", None): ((-2, -1), (-3,)),
    ("wv", None): ((-2, -1), (-3,)),
    ("wo", 3): ((-3, -2), (-1,)),  # attn out-proj (N, H, D)
    ("bq", None): ((), ()),
    ("bk", None): ((), ()),
    ("bv", None): ((), ()),
    # dense MLP
    ("wi", 2): ((-1,), (-2,)),
    ("wg", 2): ((-1,), (-2,)),
    ("wo", 2): ((-2,), (-1,)),
    # MoE (E, D, F) / (E, F, D): prefer EP over model, else TP on F
    ("wi", 3): ((0, -1), (-2,)),
    ("wg", 3): ((0, -1), (-2,)),
    ("wo_moe", 3): ((0, -2), (-1,)),
    ("router", None): ((), (-2,)),
    # RG-LRU
    ("w_in", None): ((-1,), (-2,)),
    ("w_x", None): ((-1,), (-2,)),
    ("w_a", None): ((-1,), (-2,)),
    ("w_gate", None): ((-1,), (-2,)),
    ("w_out", None): ((-2,), (-1,)),
    ("conv", None): ((-1,), ()),
    ("b_a", 1): ((-1,), ()),
    ("b_x", 1): ((-1,), ()),
    ("lambda", None): ((-1,), ()),
    # xLSTM mLSTM
    ("w_up", None): ((-1,), (-2,)),
    ("w_down", None): ((-2,), (-1,)),
    ("w_if", None): ((-2,), ()),
    # slstm input/recurrent
    ("w_z", None): ((-1,), (-2,)),
    ("w_i", None): ((-1,), (-2,)),
    ("w_f", None): ((-1,), (-2,)),
    ("w_o", None): ((-1,), (-2,)),
    ("r_z", None): ((-1,), ()),
    ("r_i", None): ((-1,), ()),
    ("r_f", None): ((-1,), ()),
    ("r_o", None): ((-1,), ()),
    # vision/audio frontend stubs
    ("merge_w", None): ((-1,), (-2,)),
    ("merge_b", None): ((), ()),
}

_REPLICATED_NAMES = {"scale", "bias", "gn_scale", "b_f", "b_i", "b_o", "b_z", "slot_pos"}


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved axis names for one mesh + execution mode."""

    mesh: Any
    mode: str = "train"  # train | serve
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None  # present on multi-pod meshes
    #: when n_heads doesn't divide the model axis: fall back to head_dim
    #: sharding ("head_dim", baseline — partial-sum reductions of attention
    #: scores) or replicate the attention projections over model
    #: ("replicate" — relies on sequence-parallel activations)
    attn_indivisible: str = "head_dim"
    #: serve plans data-shard MoE expert weights (needed when experts exceed
    #: device memory under pure TP, e.g. qwen3-235b) at the cost of a
    #: per-layer expert all-gather on every decode step — off for models
    #: that fit
    serve_expert_fsdp: bool = True
    #: thread the explicit Sharder constraints through the model (per-layer
    #: FSDP gather + activation pins)
    use_sharder: bool = True
    #: pure data parallelism: batch over EVERY mesh axis, weights replicated
    #: over model — for small models whose TP activation resharding dwarfs
    #: compute
    pure_dp: bool = False
    #: ZeRO-3 FSDP param sharding over data (train plans).  Off = params
    #: replicated (no per-layer gathers); optimizer state follows the param
    #: spec so turning this off also replicates m/v
    fsdp: bool = True

    @property
    def batch_axes(self) -> tuple[str, ...]:
        axes = ((self.pod_axis,) if self.pod_axis else ()) + (self.data_axis,)
        if self.pure_dp:
            axes = axes + (self.model_axis,)
        return axes

    @property
    def data_size(self) -> int:
        return _axis_sizes(self.mesh)[self.data_axis]

    @property
    def model_size(self) -> int:
        return _axis_sizes(self.mesh)[self.model_axis]

    @property
    def batch_size_divisor(self) -> int:
        n = self.data_size
        if self.pod_axis:
            n *= _axis_sizes(self.mesh)[self.pod_axis]
        return n

    def fsdp_enabled_for(self, path_names: tuple[str, ...]) -> bool:
        if self.mode == "train":
            return self.fsdp
        # serve: only MoE expert weights get data-axis sharding, and only
        # when the model actually needs it to fit (serve_expert_fsdp)
        return self.serve_expert_fsdp and "moe" in path_names


def make_plan(mesh, mode: str = "train", **kw) -> ShardingPlan:
    axes = _axis_names(mesh)
    pod = "pod" if "pod" in axes else None
    return ShardingPlan(mesh=mesh, mode=mode, pod_axis=pod, **kw)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def _path_names(path) -> tuple[str, ...]:
    return tuple(str(k) for k in path)


def _rule_for(names: tuple[str, ...], base_ndim: int, mode: str = "train"):
    leaf = names[-1]
    if leaf in _REPLICATED_NAMES:
        return ((), ())
    # moe wo disambiguation: parent 'moe' + 3 base dims
    if leaf == "wo" and "moe" in names and base_ndim == 3:
        return _RULES[("wo_moe", 3)]
    for key in ((leaf, base_ndim), (leaf, None)):
        if key in _RULES:
            return _RULES[key]
    return ((), ())


def _spec_for_leaf(
    plan: ShardingPlan,
    names: tuple[str, ...],
    shape: tuple[int, ...],
    stacked: bool,
) -> P:
    """Greedy axis assignment with divisibility checks."""
    base_ndim = len(shape) - (1 if stacked else 0)
    off = 1 if stacked else 0
    tp_pref, fsdp_pref = _rule_for(names, base_ndim, plan.mode)

    assign: dict[int, str] = {}

    def norm(i: int) -> int:
        return off + (i if i >= 0 else base_ndim + i)

    is_attn_proj = names[-1] in ("wq", "wk", "wv") or (
        names[-1] == "wo" and base_ndim == 3 and "moe" not in names
    )
    cands = tp_pref
    if plan.pure_dp:
        cands = ()  # no tensor parallelism: weights replicated over model
    elif is_attn_proj and plan.attn_indivisible == "replicate":
        cands = tp_pref[:1]  # heads-or-nothing: no head_dim fallback
    for i in cands:
        d = norm(i)
        if d not in assign and shape[d] % plan.model_size == 0 and shape[d] > 1:
            assign[d] = plan.model_axis
            break
    if plan.fsdp_enabled_for(names):
        for i in fsdp_pref:
            d = norm(i)
            if d not in assign and shape[d] % plan.data_size == 0 and shape[d] > 1:
                assign[d] = plan.data_axis
                break
    return P(*(assign.get(d, None) for d in range(len(shape))))


def param_specs(plan: ShardingPlan, params: Pytree) -> Pytree:
    """Spec tree matching a model param tree (tensors of any device,
    ``meta`` included)."""

    def leaf(path, x):
        names = _path_names(path)
        stacked = "blocks" in names and (
            "periods" in names
            or not any(n.startswith(("layer_", "tail_")) for n in names)
        )
        return _spec_for_leaf(plan, names, tuple(x.shape), stacked)

    return _map_with_path(leaf, params)


def opt_state_specs(
    plan: ShardingPlan, p_specs: Pytree, params: Optional[Pytree] = None
) -> Pytree:
    """Optimizer-state specs: master/m/v share the param leaf's spec.

    ZeRO-1 mode (train plan with ``fsdp=False`` and ``params`` given):
    params stay replicated but the f32 master/m/v shard their leading dim
    over ``data`` where divisible — each rank owns 1/data of the optimizer
    and the updated params are all-gathered once per step.
    """
    zero1 = plan.mode == "train" and not plan.fsdp and params is not None

    if not zero1:
        leaves_specs = _map_specs(lambda s: {"master": s, "m": s, "v": s}, p_specs)
        return {"leaves": leaves_specs, "step": P()}

    def leaf(spec, p):
        shape = tuple(p.shape)
        if (
            shape
            and spec == P(*([None] * len(shape)))
            and shape[0] % plan.data_size == 0
            and shape[0] > 1
        ):
            spec = P(plan.data_axis, *([None] * (len(shape) - 1)))
        return {"master": spec, "m": spec, "v": spec}

    leaves_specs = _map_specs(leaf, p_specs, _as_tree(params))
    return {"leaves": leaves_specs, "step": P()}


def named_shardings(mesh, specs: Pytree, kind="device") -> Pytree:
    """A tree of :class:`~repro_torch.core.memkind.Sharding` records (mesh,
    placements, level) from a spec tree: the JAX package's
    ``NamedSharding`` tree, which the engine, the pager and the streamed
    steps take."""
    from repro_torch.core.memkind import sharding_for

    return _map_specs(lambda s: sharding_for(mesh, s, kind), specs)


def distribute_tree(tree: Pytree, mesh, specs: Pytree, *, src_data_rank: Optional[int] = 0
                    ) -> Pytree:
    """``tree``'s tensors as DTensors laid out by ``specs`` on ``mesh`` (the
    port's ``jax.device_put(tree, named_shardings(mesh, specs))``).
    ``src_data_rank=None``: every rank holds the same values and cuts its
    own shard (no broadcast)."""
    from torch.distributed.tensor import distribute_tensor

    return _map_with_path(lambda _, x, s: distribute_tensor(x, mesh, placements(mesh, s),
                                                            src_data_rank=src_data_rank),
                          tree, specs)


def batch_spec(plan: ShardingPlan) -> P:
    """(batch, ...) leading-dim spec."""
    return P(plan.batch_axes)


def batch_specs(plan: ShardingPlan, batch: Pytree, global_batch: int) -> Pytree:
    """Shard the batch dim over (pod, data) when divisible, else replicate."""
    ok = global_batch % plan.batch_size_divisor == 0
    ok_data_only = global_batch % plan.data_size == 0

    def leaf(_, x):
        nd = len(x.shape)
        if ok:
            return P(plan.batch_axes, *([None] * (nd - 1)))
        if ok_data_only:
            return P(plan.data_axis, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return _map_with_path(leaf, batch)


def cache_specs_tree(plan: ShardingPlan, caches: Pytree, global_batch: int) -> Pytree:
    """Decode-state specs.

    k/v caches ``(..., B, T, K, H)``: batch over data axes when divisible;
    heads over model when divisible else head_dim over model.  Recurrent /
    matrix states: batch over data, feature dim over model.
    """
    b_ok = global_batch % plan.data_size == 0
    b_axes = plan.data_axis if b_ok else None

    def leaf(path, x):
        names = _path_names(path)
        shape = tuple(x.shape)
        nd = len(shape)
        leafname = names[-1]
        if leafname in ("k", "v"):
            # (B, T, K, H) or stacked (L, B, T, K, H).
            # Preference: KV heads over model (fully local attention) when
            # divisible; else the *sequence* dim (flash-decode style — scores
            # and the softmax combine are partial-reduced over model, which
            # for single-token queries is KBs); head_dim as last resort.
            off = nd - 4
            spec = [None] * nd
            spec[off + 0] = b_axes
            if shape[off + 2] % plan.model_size == 0 and shape[off + 2] > 1:
                spec[off + 2] = plan.model_axis
            elif shape[off + 1] % plan.model_size == 0 and shape[off + 1] > 1:
                spec[off + 1] = plan.model_axis
            elif shape[off + 3] % plan.model_size == 0:
                spec[off + 3] = plan.model_axis
            return P(*spec)
        if leafname == "slot_pos":
            return P(*([None] * nd))
        # recurrent states: (B, W) / (B, NH, DH, DH) / (L, B, ...) stacked
        # batch dim = first dim whose size matches a batch multiple; we use
        # a convention: hetero states are (B, ...), stacked are (L, B, ...).
        off = 1 if (("blocks" in names or nd >= 2) and shape[0] != global_batch and nd >= 2
                    and shape[min(1, nd - 1)] == global_batch) else 0
        spec = [None] * nd
        if shape[off] == global_batch:
            spec[off] = b_axes
        # shard the largest remaining dim over model if divisible
        rest = [(shape[d], d) for d in range(nd) if d != off]
        for size, d in sorted(rest, reverse=True):
            if size % plan.model_size == 0 and size > 1:
                spec[d] = plan.model_axis
                break
        return P(*spec)

    return _map_with_path(leaf, caches)


def recommended_plan(mesh, cfg, mode: str = "train") -> ShardingPlan:
    """Plan with the measured lessons codified:

    * small models (full f32 train state fits a fraction of device memory)
      train pure-DP — TP activation resharding dwarfs their compute;
    * serve plans skip expert FSDP when the experts fit pure TP.
    """
    plan = make_plan(mesh, mode=mode)
    total, _ = cfg.param_count()
    if mode == "train" and total * 14 <= 6 * 2**30:
        plan = dataclasses.replace(plan, pure_dp=True)
    if mode == "serve" and total * 2 / plan.model_size <= 10 * 2**30:
        plan = dataclasses.replace(plan, serve_expert_fsdp=False)
    return plan


# ---------------------------------------------------------------------------
# explicit FSDP gather + activation constraints (the Sharder)
# ---------------------------------------------------------------------------

def _strip_axes(spec: P, drop: tuple[str, ...]) -> P:
    def strip(ax):
        if ax is None:
            return None
        if isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a not in drop)
            return kept if kept else None
        return None if ax in drop else ax

    return P(*(strip(a) for a in spec))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Resharded(torch.autograd.Function):
    """FSDP gather with an explicit backward layout.

    Forward: redistribute to the TP-only (gathered) placements — the
    per-layer all-gather.  Backward: redistribute the gradient to the FSDP
    placements — the per-layer reduce-scatter.  A plain ``redistribute``
    sends the gradient back to the input's placements; this names them, so
    the stacked gradient lands sharded over data whatever the input was."""

    @staticmethod
    def forward(ctx, a, mesh, fwd, bwd):
        ctx.mesh, ctx.bwd = mesh, bwd
        return a.redistribute(mesh, fwd)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.bwd), None, None, None


def _prune_to(tree, specs):
    """Restrict a spec dict-tree to the keys present in ``tree`` (identity
    when the structures already match)."""
    if isinstance(tree, Mapping) and isinstance(specs, Mapping):
        return {k: _prune_to(v, specs[k]) for k, v in tree.items()}
    return specs


@dataclasses.dataclass
class Sharder:
    """Explicit sharding control for the model's DTensors.

    * ``acts(x)`` redistributes block-boundary activations to
      (batch-sharded, replicated-feature).
    * ``block(p, name)`` redistributes a layer's parameter slice to its
      **TP-only** spec.  For FSDP('data')-sharded params this is the
      per-layer all-gather (ZeRO-3); the backward pass dually
      reduce-scatters the layer gradient (:class:`_Resharded`).
    * ``grads(g)`` pins gradients to the params' (FSDP) layout.

    On a plain tensor each is the identity; on a mesh of one rank the
    values pass unchanged.  The layer body calls it
    (``models/transformer.py``, the JAX package's points).
    """

    mesh: Any
    plan: ShardingPlan
    act_spec: P
    block_specs: Any  # TP-only per-layer spec tree (hetero: {layer_name: tree})
    fsdp_specs: Any = None  # per-layer FSDP spec tree (backward layout)
    full_specs: Any = None  # whole-params spec tree (FSDP layout)
    uniform: bool = True

    def _to(self, a, spec: P):
        if not _is_dtensor(a):
            return a
        return a.redistribute(self.mesh, placements(self.mesh, spec))

    def grads(self, g):
        """Pin gradients to the params' (FSDP) layout (ZeRO grad sharding)."""
        if self.full_specs is None:
            return g
        return _map_with_path(lambda _, a, s: self._to(a, s), g, self.full_specs)

    def acts(self, x):
        nd = len(x.shape)
        sizes = _axis_sizes(self.mesh)
        # a batch the data axes do not divide (a one-request prefill under a
        # session's batch-wide spec) stays replicated over them
        act = [None if ax is not None and x.shape[d] % int(np.prod(
            [sizes[a] for a in _spec_axes(ax)])) else ax for d, ax in enumerate(self.act_spec)]
        spec = P(*act, *([None] * (nd - len(self.act_spec))))
        return self._to(x, spec)

    def block(self, p, name=None):
        """``name``: None (uniform stacked layer slice), a key string, or a
        tuple path into the blocks subtree (period layout:
        ('periods', 'pos_k')).  ``p`` may be a key-subset of the block
        structure (a block's non-expert group alone); specs are pruned to
        the keys present."""
        specs, bwd = self.block_specs, self.fsdp_specs
        if name is not None:
            for part in (name,) if isinstance(name, str) else name:
                specs = specs[part]
                bwd = bwd[part] if bwd is not None else None
        specs = _prune_to(p, specs)
        bwd = _prune_to(p, bwd) if bwd is not None else None
        if bwd is None:
            return _map_with_path(lambda _, a, s: self._to(a, s), p, specs)

        def leaf(_, a, s, b):
            if not _is_dtensor(a):
                return a
            return _Resharded.apply(a, self.mesh, placements(self.mesh, s),
                                    placements(self.mesh, b))

        return _map_with_path(leaf, p, specs, bwd)


def make_sharder(
    plan: ShardingPlan,
    params: Pytree,
    global_batch: Optional[int] = None,
    *,
    seq_len: Optional[int] = None,
    seq_shard: bool = False,
) -> Sharder:
    """Build the Sharder for a param tree (meta or concrete).

    ``seq_shard=True`` enables sequence parallelism for the *block-boundary*
    activation spec: the residual stream (and so every remat-saved
    per-layer residual) is sharded over the model axis on the sequence dim,
    which shrinks the saved residuals by the TP degree (Megatron-SP).
    """
    if global_batch is None or global_batch % plan.batch_size_divisor == 0:
        b_axes = plan.batch_axes
    elif global_batch % plan.data_size == 0:
        b_axes = plan.data_axis
    else:
        b_axes = None
    seq_ok = seq_shard and seq_len is not None and seq_len % plan.model_size == 0
    act_spec = P(b_axes, plan.model_axis if seq_ok else None)
    specs = param_specs(plan, params)
    drop = tuple(a for a in (plan.data_axis, plan.pod_axis) if a)
    blocks = specs.get("blocks", {})
    uniform = not any(
        str(k).startswith(("layer_", "tail_", "periods")) for k in blocks
    )

    def per_layer(path, s):
        # stacked leaves (uniform stack or 'periods' position stacks) drop
        # their leading layer dim; unrolled leaves keep their full spec
        names = _path_names(path)
        stacked = uniform or "periods" in names
        return P(*s[1:]) if stacked else s

    fsdp_specs = _map_with_path(per_layer, blocks, is_leaf=_is_spec)
    block_specs = _map_specs(lambda s: _strip_axes(s, drop), fsdp_specs)
    return Sharder(
        mesh=plan.mesh,
        plan=plan,
        act_spec=act_spec,
        block_specs=block_specs,
        fsdp_specs=fsdp_specs,
        full_specs=specs,
        uniform=uniform,
    )


# ---------------------------------------------------------------------------
# debugging / reporting helpers
# ---------------------------------------------------------------------------

def _leaf_device_bytes(plan: ShardingPlan, x, spec: P) -> int:
    sizes = _axis_sizes(plan.mesh)
    shard_elems = np.prod(tuple(x.shape)) if len(x.shape) else 1
    for ax in spec:
        if ax is None:
            continue
        for a in _spec_axes(ax):
            shard_elems //= sizes[a]
    return int(shard_elems) * x.dtype.itemsize


def _flat_specs(specs) -> list:
    return tr.flatten(specs, is_leaf=_is_spec)[0]


def per_device_bytes(plan: ShardingPlan, params: Pytree, specs: Pytree) -> int:
    """Bytes of one device's shards of ``params`` laid out by ``specs``."""
    return sum(_leaf_device_bytes(plan, x, s)
               for (_, x), s in zip(_flatten_with_path(params), _flat_specs(specs)))


def sharding_report(plan: ShardingPlan, params: Pytree, specs: Pytree) -> str:
    """Human-readable table: leaf path, shape, spec, per-device bytes."""
    rows = []
    total_bytes = 0
    for (path, x), spec in zip(_flatten_with_path(params), _flat_specs(specs)):
        names = "/".join(_path_names(path))
        nbytes = _leaf_device_bytes(plan, x, spec)
        total_bytes += nbytes
        rows.append(f"  {names:55s} {str(tuple(x.shape)):26s} {str(spec):36s} {nbytes/2**20:9.2f} MiB")
    header = f"per-device param bytes: {total_bytes/2**30:.3f} GiB ({plan.mode} plan)"
    return header + "\n" + "\n".join(rows)
