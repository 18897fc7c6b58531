"""Streamed model parameters: host- and disk-homed weights under a device budget.

The JAX package's ``repro.core.weightstream`` on the port.  The paper's claim
("compute with data sets of arbitrarily large size", §3.1) applied to the
largest tree in the system, the model weights.  A :class:`WeightStreamPlan`
partitions a parameter tree into an ordered **group program** of typed
fetch groups:

  kind        home slice
  ----------  -----------------------------------------------------------
  ``embed``   the token embedding (always group 0)
  ``layers``  a contiguous ``[lo:hi)`` slice of the uniform stacked
              ``blocks`` leaves; under ``expert_stream`` the slice excludes
              the routed-expert tensors (router, attention and norms only)
  ``expert``  ONE routed expert of ONE MoE layer: the ``(1, d, f)`` rows of
              ``moe.wi`` / ``moe.wo`` / ``moe.wg`` at that expert index
  ``period``  a slice of the stacked period units of a period-scanned
              stack (``blocks["periods"]``, the hybrid)
  ``block``   named unrolled blocks (``layer_###``, the period tails)
  ``head``    final norm + LM head (always the last group; a tied head
              re-reads the embedding table, so its *fetch* group also
              references the embed home leaves)

Between steps the weights live at their **home kind**: host numpy
(``pinned_host``; bf16 as :class:`~repro_torch.core.arrays.BF16HostArray`)
or :class:`~repro_torch.core.spillstore.SpillStore` memmap chunks
(``disk_host``, one chunk per group = one disk request, in the JAX
package's chunk format under the same ``wp/`` keys), and they stream group
by group through the :class:`~repro_torch.core.engine.TransferEngine` while
the previous group's compute runs.

The plan is also the **device-budget model**: ``peak_device_bytes(d)`` is
the sliding-window maximum of ``d + 2`` consecutive stream units (``d``
prefetched + 1 landing + 1 being consumed), and ``max_distance_for_budget``
caps the adaptive prefetch window so the streamed residency never exceeds
``device_budget_mb``.  Both take a ``cached_bytes`` term for the
:class:`~repro_torch.core.residency.ResidencyCache`;
``residency_capacity_bytes`` is the slack left above the widest allowed
window.  Every integer is the JAX package's for the same config.

A **stream unit** is what one stage consumes: a ``moe`` unit spans a
layer's non-expert group and its E expert groups; every other kind is one
group a unit.  Route-aware decode (``expert_stream``): the decode program
fetches only a layer's non-expert group through the pipeline, runs the
router first, then fetches just the routed experts' groups; the expert-
granular residency cache keeps hot experts on the card.

Where the data lives never changes what is computed: the streamed steps run
the model's own layer body on the landed groups, so streamed runs are
bitwise the device-resident run's.

Under a mesh the plan maps a full-params tree of shardings onto its
groups (:meth:`WeightStreamPlan.group_shardings`): the streamed steps stage
each group at its layout, each rank its own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray, host_array, host_tensor
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "WeightGroup",
    "StreamUnit",
    "WeightStreamPlan",
    "WeightStreamSupport",
    "weight_stream_support",
    "merge_expert_slice",
    "PARAM_KINDS",
]

Pytree = Any

#: the CLI surface of ``--param-kind``
PARAM_KINDS = ("device", "pinned_host", "disk_host")

#: spill-store key namespace for parameter group chunks
_KEY_PREFIX = "wp"

#: expert tensor names inside a block's ``moe`` subtree (``wg`` only when gated)
_EXPERT_NAMES = ("wi", "wo", "wg")

@dataclasses.dataclass(frozen=True)
class WeightStreamSupport:
    """Reasoned support report for streaming an arch's parameters.

    ``supported`` covers the train path; ``serve_supported`` the decode
    path (heterogeneous layouts stream for training, but their decode state
    is not group-pageable).  ``reason`` / ``serve_reason`` say why not, word
    for word the JAX package's."""

    supported: bool
    layout: str  # "uniform" | "period" | "unrolled" | ""
    reason: str = ""
    serve_supported: bool = False
    serve_reason: str = ""

    def __bool__(self) -> bool:
        return self.supported


def weight_stream_support(cfg) -> WeightStreamSupport:
    """Which group program (if any) can stream this arch's parameters, and
    why not where it cannot."""
    if cfg.n_layers < 1:
        r = (
            f"{cfg.name}: weight streaming needs at least one block layer "
            f"(n_layers={cfg.n_layers})"
        )
        return WeightStreamSupport(False, "", r, False, r)
    if cfg.uniform_blocks and cfg.use_scan:
        return WeightStreamSupport(True, "uniform", "", True, "")
    layout = "period" if cfg.period_scan else "unrolled"
    serve_reason = (
        f"{cfg.name}: streamed serving requires uniform scanned blocks — "
        f"the {layout} layout's per-block decode state is not "
        "group-pageable; train-side streaming is supported via "
        f"{layout} group programs"
    )
    return WeightStreamSupport(True, layout, "", False, serve_reason)


def _items(tree: Pytree, path: str = ""):
    """``(path, leaf)`` in the tree's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _tree_bytes(tree: Pytree) -> int:
    """Exact byte count of a tree of shaped, dtyped leaves.  A leaf without
    a dtype is a hard error: assuming float32 would under-count the device
    budget for wider types."""
    total = 0
    for path, x in _items(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
            continue
        dt = getattr(x, "dtype", None)
        if dt is None:
            raise TypeError(
                "byte accounting needs a dtype on every leaf; leaf "
                f"{path!r} ({type(x).__name__}) has none"
            )
        total += int(np.prod(np.shape(x), dtype=np.int64)) * np.dtype(dt).itemsize
    return total


def _abstract(x: Any) -> bool:
    """A shape-only leaf (a tensor on the meta device)."""
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


def _to_host(x: Any) -> Any:
    """The host numpy home of a concrete leaf (a copy for tensors; bf16 as a
    :class:`BF16HostArray`); numpy leaves and shape-only leaves pass
    through."""
    if _abstract(x):
        return x
    if isinstance(x, torch.Tensor):
        return host_array(x.detach().to("cpu", copy=True).contiguous())
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x)


def _concrete(tree: Pytree) -> bool:
    return not any(_abstract(x) for x in tr.leaves(tree))


def _as_dict(params: Pytree) -> Pytree:
    """A :class:`~repro_torch.models.layers.ParamTree` as nested dicts."""
    as_dict = getattr(params, "as_dict", None)
    return as_dict() if as_dict is not None else params


def _cat(*xs) -> np.ndarray:
    """Concatenate home slices along the layer axis, keeping bf16 named."""
    out = np.concatenate([np.asarray(x) for x in xs], axis=0)
    return out.view(BF16HostArray) if isinstance(xs[0], BF16HostArray) else out


@dataclasses.dataclass(frozen=True)
class WeightGroup:
    """One home group of the partition (a transfer group when fetched)."""

    index: int
    key: str  # key in the home dict (sorted == home order)
    kind: str  # "embed" | "layers" | "expert" | "period" | "block" | "head"
    lo: int = 0  # absolute layer range covered by the group
    hi: int = 0
    expert: int = -1  # expert index for kind == "expert"


@dataclasses.dataclass(frozen=True)
class StreamUnit:
    """One compute stage of the stream program: the group indices a single
    stage call consumes (a ``moe`` unit spans the layer's non-expert group
    and its expert groups; other kinds are 1:1)."""

    kind: str  # "layers" | "moe" | "period" | "block"
    gidx: tuple  # indices into plan.groups, fetch order
    lo: int  # absolute layer range
    hi: int


def merge_expert_slice(ne: Pytree, experts: Sequence[Pytree]) -> Pytree:
    """Rebuild a stacked one-layer block slice from a non-expert group and
    its per-expert groups: each expert leaf ``(1, d, f)`` gains an expert
    axis and the stack concatenates to ``(1, E, d, f)``, bitwise the slice
    the un-split layer group would have carried.  Tensors in, tensors out
    (on the device the groups landed on)."""
    moe = dict(ne["moe"])
    for name in experts[0]:
        moe[name] = torch.cat([e[name][:, None] for e in experts], dim=1)
    out = dict(ne)
    out["moe"] = moe
    return out


class WeightStreamPlan:
    """Partition of a model parameter tree into a typed group program.

    Parameters
    ----------
    cfg:
        the :class:`~repro_torch.configs.base.ModelConfig` (must satisfy
        :func:`weight_stream_support`).
    abstract_params:
        the compute-dtype parameter tree (nested dicts, or a
        :class:`~repro_torch.models.layers.ParamTree`) whose leaves give the
        shapes and dtypes: meta tensors
        (:func:`repro_torch.train.steps.abstract_params`), real tensors or
        numpy arrays.
    layers_per_group:
        stream units per middle group: layers for the uniform and unrolled
        layouts, period units for the period layout.  ``None`` picks the
        largest count whose distance-1 peak fits ``device_budget_mb``
        (falling back to 1).
    device_budget_mb:
        device-residency budget for streamed weights.  Construction fails if
        even the smallest grouping at distance 1 cannot fit, and
        :meth:`max_distance_for_budget` caps the prefetch window at run
        time.  ``None`` = unbounded.
    expert_stream:
        split each MoE layer into a non-expert group (router, attention,
        norms) and one group per routed expert, for route-aware decode
        fetches and an expert-granular residency cache.  Needs an MoE
        config with the uniform layout; forces one layer a group.
    """

    def __init__(
        self,
        cfg,
        abstract_params: Pytree,
        *,
        layers_per_group: Optional[int] = None,
        device_budget_mb: Optional[float] = None,
        expert_stream: bool = False,
    ) -> None:
        support = weight_stream_support(cfg)
        if not support.supported:
            raise ValueError(support.reason)
        abstract_params = _as_dict(abstract_params)
        if "blocks" not in abstract_params:
            raise ValueError("param tree has no 'blocks' subtree")
        self.cfg = cfg
        self.support = support
        self.layout = support.layout
        self.n_layers = cfg.n_layers
        self.scan_period = cfg.scan_period
        if expert_stream:
            if self.layout != "uniform":
                raise ValueError(
                    f"{cfg.name}: --expert-stream needs the uniform layout "
                    f"(this arch streams via {self.layout} group programs)"
                )
            if not cfg.n_experts:
                raise ValueError(
                    f"{cfg.name}: --expert-stream requires an MoE config "
                    "(n_experts == 0)"
                )
        self.expert_stream = bool(expert_stream)
        keys = set(abstract_params)
        self.embed_keys = tuple(k for k in ("embed", "vision") if k in keys)
        self.head_home_keys = tuple(k for k in ("ln_f", "head") if k in keys)
        #: a tied head reads the embedding table at the head stage
        self.head_reads_embed = "head" not in keys or bool(cfg.n_codebooks)

        blocks_abs = abstract_params["blocks"]
        self._blocks_template = blocks_abs
        total_block_bytes = _tree_bytes(blocks_abs)
        self.per_layer_bytes = total_block_bytes // max(1, self.n_layers)
        self.embed_bytes = _tree_bytes({k: abstract_params[k] for k in self.embed_keys})
        head_home_bytes = _tree_bytes({k: abstract_params[k] for k in self.head_home_keys})
        embed_table_bytes = (
            _tree_bytes(abstract_params.get("embed", {})) if self.head_reads_embed else 0
        )
        self.head_home_bytes = head_home_bytes
        self.embed_table_bytes = embed_table_bytes
        self.head_fetch_bytes = head_home_bytes + embed_table_bytes
        self.total_param_bytes = self.embed_bytes + head_home_bytes + total_block_bytes

        # ---- layout-specific byte model (exact: stacked leaves divide
        # evenly along the stacking axis, named blocks are counted per tree)
        self.expert_names: tuple = ()
        self.per_expert_bytes = 0
        self.nonexpert_layer_bytes = self.per_layer_bytes
        self._block_bytes: dict = {}  # named-block layouts: name -> bytes
        tail_bytes = 0
        if self.layout == "uniform":
            if self.expert_stream:
                moe_abs = blocks_abs["moe"]
                self.expert_names = tuple(n for n in _EXPERT_NAMES if n in moe_abs)
                expert_total = _tree_bytes({n: moe_abs[n] for n in self.expert_names})
                self.per_expert_bytes = expert_total // (self.n_layers * cfg.n_experts)
                self.nonexpert_layer_bytes = (
                    self.per_layer_bytes - cfg.n_experts * self.per_expert_bytes
                )
            unit_bytes = [self.per_layer_bytes] * self.n_layers
        elif self.layout == "period":
            p = self.scan_period
            self._n_full = self.n_layers // p
            periods_bytes = _tree_bytes(blocks_abs["periods"])
            unit_bytes = [periods_bytes // self._n_full] * self._n_full
            self._tail_names = tuple(
                f"tail_{k}" for k in range(self.n_layers - self._n_full * p)
            )
            for name in self._tail_names:
                self._block_bytes[name] = _tree_bytes(blocks_abs[name])
            tail_bytes = sum(self._block_bytes.values())
        else:  # unrolled
            names = [f"layer_{i:03d}" for i in range(self.n_layers)]
            for name in names:
                self._block_bytes[name] = _tree_bytes(blocks_abs[name])
            unit_bytes = [self._block_bytes[n] for n in names]
        self._unit_bytes = unit_bytes
        self._tail_unit_bytes = tail_bytes

        budget = int(device_budget_mb * 1e6) if device_budget_mb is not None else None
        self.device_budget_bytes = budget
        if self.expert_stream:
            layers_per_group = 1
        elif layers_per_group is None:
            layers_per_group = self._fit_layers_per_group(budget)
        if layers_per_group < 1:
            raise ValueError("layers_per_group must be >= 1")
        self.layers_per_group = min(layers_per_group, len(unit_bytes))

        self._build_groups()

        if budget is not None and self.peak_device_bytes(1) > budget:
            raise ValueError(
                f"--device-budget-mb {device_budget_mb} cannot hold even a "
                f"distance-1 weight stream (peak "
                f"{self.peak_device_bytes(1) / 1e6:.1f} MB with "
                f"layers_per_group={self.layers_per_group}); raise the budget"
            )

    # --------------------------------------------------------- group program
    def _build_groups(self) -> None:
        groups: list[WeightGroup] = [WeightGroup(0, "g000_embed", "embed")]
        units: list[StreamUnit] = []
        names_map: dict = {}
        if self.layout == "uniform" and self.expert_stream:
            for l in range(self.n_layers):
                i = len(groups)
                groups.append(WeightGroup(i, f"g{i:03d}_layers_{l:03d}_{l + 1:03d}", "layers",
                                          l, l + 1))
                gidx = [i]
                for e in range(self.cfg.n_experts):
                    i = len(groups)
                    groups.append(WeightGroup(
                        i, f"g{i:03d}_expert_{l:03d}_{l + 1:03d}_e{e:02d}", "expert", l, l + 1,
                        expert=e))
                    gidx.append(i)
                units.append(StreamUnit("moe", tuple(gidx), l, l + 1))
        elif self.layout == "uniform":
            lo = 0
            while lo < self.n_layers:
                hi = min(lo + self.layers_per_group, self.n_layers)
                i = len(groups)
                groups.append(WeightGroup(i, f"g{i:03d}_layers_{lo:03d}_{hi:03d}", "layers", lo, hi))
                units.append(StreamUnit("layers", (i,), lo, hi))
                lo = hi
        elif self.layout == "period":
            p = self.scan_period
            lo_u = 0
            while lo_u < self._n_full:
                hi_u = min(lo_u + self.layers_per_group, self._n_full)
                i = len(groups)
                groups.append(WeightGroup(i, f"g{i:03d}_period_{lo_u * p:03d}_{hi_u * p:03d}",
                                          "period", lo_u * p, hi_u * p))
                units.append(StreamUnit("period", (i,), lo_u * p, hi_u * p))
                lo_u = hi_u
            if self._tail_names:
                i = len(groups)
                lo = self._n_full * p
                g = WeightGroup(i, f"g{i:03d}_block_{lo:03d}_{self.n_layers:03d}", "block",
                                lo, self.n_layers)
                groups.append(g)
                units.append(StreamUnit("block", (i,), lo, self.n_layers))
                names_map[g.key] = self._tail_names
        else:  # unrolled
            lo = 0
            while lo < self.n_layers:
                hi = min(lo + self.layers_per_group, self.n_layers)
                i = len(groups)
                g = WeightGroup(i, f"g{i:03d}_block_{lo:03d}_{hi:03d}", "block", lo, hi)
                groups.append(g)
                units.append(StreamUnit("block", (i,), lo, hi))
                names_map[g.key] = tuple(f"layer_{j:03d}" for j in range(lo, hi))
                lo = hi
        groups.append(WeightGroup(len(groups), f"g{len(groups):03d}_head", "head"))
        self.groups = tuple(groups)
        self.units = tuple(units)
        self.layer_groups = tuple(g for g in groups if g.kind == "layers")
        self.expert_groups = tuple(g for g in groups if g.kind == "expert")
        self.n_groups = len(groups)
        self._block_names_map = names_map

    def block_names(self, g: WeightGroup) -> tuple:
        """The named-block keys a ``block`` group homes."""
        return self._block_names_map[g.key]

    def experts_for_layer(self, lo: int) -> tuple:
        """The expert groups of the layer starting at ``lo`` (fetch order)."""
        return tuple(g for g in self.expert_groups if g.lo == lo)

    # ------------------------------------------------------------ byte model
    def group_bytes(self, g: WeightGroup, *, fetch: bool = True) -> int:
        if g.kind == "embed":
            return self.embed_bytes
        if g.kind == "head":
            # home bytes exclude the tied embed-table re-read
            return self.head_fetch_bytes if fetch else self.head_home_bytes
        if g.kind == "expert":
            return self.per_expert_bytes
        if g.kind == "layers":
            return (g.hi - g.lo) * self.nonexpert_layer_bytes
        if g.kind == "period":
            n_units = (g.hi - g.lo) // self.scan_period
            return n_units * self._unit_bytes[0]
        return sum(self._block_bytes[n] for n in self.block_names(g))

    def fetch_sequence_bytes(self) -> list[int]:
        """Per-group H2D bytes in forward fetch order."""
        return [self.group_bytes(g) for g in self.groups]

    def _window_sequence_bytes(self) -> list[int]:
        """Per-stage bytes for the residency window model.  A ``moe`` unit's
        groups are consumed together by prefill (the merged stage holds the
        non-expert slice and every expert), so the unit counts as one window
        element of their summed bytes; decode's routed subset uses less."""
        seq = [self.embed_bytes]
        for u in self.units:
            seq.append(sum(self.group_bytes(self.groups[i]) for i in u.gidx))
        seq.append(self.head_fetch_bytes)
        return seq

    @staticmethod
    def _window_max(seq: list, distance: int) -> int:
        w = max(1, distance + 2)
        return max(sum(seq[i : min(i + w, len(seq))]) for i in range(len(seq)))

    def peak_device_bytes(self, distance: int, cached_bytes: int = 0) -> int:
        """Streamed-weight residency model: with ``distance`` stages
        prefetched, at most ``distance + 2`` consecutive stream units are on
        the device at once (in flight + landing + being consumed).
        ``cached_bytes`` adds a residency-cache ceiling on top of the window.

        The fast path of the occupancy model; the exact per-point model is
        :func:`repro_torch.core.schedcheck.analyze_train_schedule`, which
        equals it on these layouts without a cache and is bounded by it
        everywhere, so a distance this model admits never overruns the
        budget at run time."""
        return cached_bytes + self._window_max(self._window_sequence_bytes(), distance)

    def _peak_for_grouping(self, upg: int, distance: int) -> int:
        """Residency peak for a hypothetical units-per-group, shared by the
        automatic group sizing so it never picks a size the validation then
        rejects."""
        seq = [self.embed_bytes]
        lo = 0
        while lo < len(self._unit_bytes):
            hi = min(lo + upg, len(self._unit_bytes))
            seq.append(sum(self._unit_bytes[lo:hi]))
            lo = hi
        if self._tail_unit_bytes:
            seq.append(self._tail_unit_bytes)
        seq.append(self.head_fetch_bytes)
        return self._window_max(seq, distance)

    def max_distance_for_budget(self, cap: int = 8, cached_bytes: int = 0) -> int:
        """Largest prefetch distance whose modeled peak fits the budget: the
        engine's ``max_distance``, so the adaptive controller can never learn
        its way past the budget.  ``cached_bytes`` reserves residency for the
        group cache (window and cache share the one budget)."""
        if self.device_budget_bytes is None:
            return cap
        d = 1
        while d < cap and self.peak_device_bytes(d + 1, cached_bytes) <= self.device_budget_bytes:
            d += 1
        return d

    def residency_capacity_bytes(self, cap: int = 8) -> Optional[int]:
        """Byte ceiling for the weight-residency cache: the budget slack
        above the widest allowed prefetch window.  ``None`` (no budget) =
        unbounded; zero slack = an inert cache = the uncached schedule."""
        if self.device_budget_bytes is None:
            return None
        return max(
            0,
            self.device_budget_bytes - self.peak_device_bytes(self.max_distance_for_budget(cap)),
        )

    def _fit_layers_per_group(self, budget: Optional[int]) -> int:
        n = len(self._unit_bytes)
        if budget is None:
            return max(1, n // 4)
        for upg in range(n, 1, -1):
            # the exact distance-1 sliding-window peak (a window holds up to
            # 3 consecutive groups)
            if self._peak_for_grouping(upg, 1) <= budget:
                return upg
        return 1

    def grouping(self) -> list[dict]:
        """JSON-serializable description of the group program (the group
        keys encode kind and layer bounds)."""
        return [
            {"key": g.key, "kind": g.kind, "lo": g.lo, "hi": g.hi, "expert": g.expert}
            for g in self.groups
        ]

    # ------------------------------------------------------------- slicing
    def _strip_experts(self, tree: Pytree) -> Pytree:
        """A block slice minus the routed-expert tensors (router kept)."""
        out = {k: v for k, v in tree.items() if k != "moe"}
        out["moe"] = {k: v for k, v in tree["moe"].items() if k not in self.expert_names}
        return out

    def home_group(self, params: Pytree, g: WeightGroup) -> Pytree:
        """The group's slice of a *full* parameter tree (views, no copies)."""
        params = _as_dict(params)
        if g.kind == "embed":
            return {k: params[k] for k in self.embed_keys}
        if g.kind == "head":
            return {k: params[k] for k in self.head_home_keys}
        if g.kind == "expert":
            moe = params["blocks"]["moe"]
            return {n: moe[n][g.lo : g.hi, g.expert] for n in self.expert_names}
        if g.kind == "period":
            p = self.scan_period
            return tr.tree_map(lambda a: a[g.lo // p : g.hi // p], params["blocks"]["periods"])
        if g.kind == "block":
            return {n: params["blocks"][n] for n in self.block_names(g)}
        sl = tr.tree_map(lambda a: a[g.lo : g.hi], params["blocks"])
        return self._strip_experts(sl) if self.expert_stream else sl

    def init_home(self, params: Pytree) -> dict:
        """Home representation: ``{"groups": {key: group_tree}}`` with host
        numpy leaves (copies of tensors; bf16 as
        :class:`~repro_torch.core.arrays.BF16HostArray`).  Shape-only (meta)
        leaves pass through."""
        params = _as_dict(params)
        return {
            "groups": {
                g.key: tr.tree_map(_to_host, self.home_group(params, g)) for g in self.groups
            }
        }

    def assemble(self, home: dict) -> Pytree:
        """Full host parameter tree from a home (sliced groups concatenated,
        expert groups restacked), for conversion and export; the streamed
        paths never call this."""
        out: dict = {}
        for g in self.groups:
            if g.kind in ("embed", "head"):
                out.update(dict(home["groups"][g.key].items()))
        if self.layout == "uniform" and self.expert_stream:
            layer_parts = []
            for u in self.units:
                ne = home["groups"][self.groups[u.gidx[0]].key]
                experts = [home["groups"][self.groups[i].key] for i in u.gidx[1:]]
                moe = dict(ne["moe"])
                for name in self.expert_names:
                    stacked = np.concatenate([np.asarray(e[name])[:, None] for e in experts],
                                             axis=1)
                    moe[name] = (stacked.view(BF16HostArray)
                                 if isinstance(experts[0][name], BF16HostArray) else stacked)
                merged = dict(ne)
                merged["moe"] = moe
                layer_parts.append(merged)
            out["blocks"] = tr.tree_map(_cat, *layer_parts)
        elif self.layout == "uniform":
            parts = [home["groups"][g.key] for g in self.layer_groups]
            out["blocks"] = tr.tree_map(_cat, *parts)
        elif self.layout == "period":
            parts = [home["groups"][g.key] for g in self.groups if g.kind == "period"]
            blocks = {"periods": tr.tree_map(_cat, *parts)}
            for g in self.groups:
                if g.kind == "block":
                    blocks.update(home["groups"][g.key])
            out["blocks"] = blocks
        else:  # unrolled
            blocks = {}
            for g in self.groups:
                if g.kind == "block":
                    blocks.update(home["groups"][g.key])
            out["blocks"] = blocks
        return out

    # ------------------------------------------------------------- fetching
    def fetch_group(self, home: dict, g: WeightGroup, cache=None) -> Pytree:
        """The tree actually streamed for a stage: the home group, except the
        tied head's, which also references the embed home leaves (packed
        into the same staging buffer: still one H2D request).

        ``cache`` (a :class:`~repro_torch.core.residency.ResidencyCache`
        keyed by group key) substitutes resident groups: a hit hands back
        device tensors that pass through the engine at zero H2D requests.
        The tied head borrows the embed table from the resident embed group
        even on a head miss."""
        tree = cache.lookup(g.key) if cache is not None else None
        if cache is not None and getattr(cache, "sanitize", False):
            cache.sanitize_home(g.key, home["groups"][g.key], hit=tree is not None)
        if tree is None:
            tree = home["groups"][g.key]
        if g.kind == "head" and self.head_reads_embed:
            tree = dict(tree)
            emb = cache.peek(self.groups[0].key) if cache is not None else None
            tree["embed"] = (
                emb["embed"] if emb is not None else home["groups"][self.groups[0].key]["embed"]
            )
        return tree

    def fetch_groups_forward(self, home: dict, cache=None) -> list:
        return [self.fetch_group(home, g, cache) for g in self.groups]

    def fetch_thunks_forward(self, home: dict, cache) -> list:
        """Forward fetch sequence as zero-argument thunks, resolved by the
        executor when it submits each transfer: residency decisions must see
        the cache as it is then (the embed group a head fetch borrows from
        may become resident mid-pass)."""
        return [(lambda g=g: self.fetch_group(home, g, cache)) for g in self.groups]

    def cache_home_tree(self, g: WeightGroup, fetched: Pytree) -> Pytree:
        """The cacheable home part of a landed fetch group: the tied head's
        borrowed embed table belongs to the embed group's entry, so it is
        stripped rather than counted (and held) twice."""
        if g.kind == "head" and self.head_reads_embed:
            return {k: fetched[k] for k in self.head_home_keys}
        return fetched

    def split_head_grads(self, dp_head: Pytree) -> tuple[Pytree, Optional[Pytree]]:
        """Split the head *fetch* group's gradients into (the head home's
        part, the embed table's part or ``None``): a tied head's table
        gradient is added to the embed stage's."""
        home = {k: dp_head[k] for k in self.head_home_keys}
        embed = dp_head.get("embed") if self.head_reads_embed else None
        return home, embed

    # ------------------------------------------------------------ shardings
    @staticmethod
    def _drop_expert_axis(sh):
        """Sharding for an expert group's ``(1, d, f)`` leaves derived from
        the stacked ``(L, E, d, f)`` leaf's: the expert axis (axis 1) leaves
        the layout (a mesh dim that sharded it replicates), the later dims
        move down by one."""
        from torch.distributed.tensor import Replicate, Shard

        def drop(p):
            if not isinstance(p, Shard):
                return p
            if p.dim == 1:
                return Replicate()
            return Shard(p.dim - 1) if p.dim > 1 else p

        return dataclasses.replace(sh, placements=tuple(drop(p) for p in sh.placements))

    def _group_sharding(self, g: WeightGroup, p_shardings, *, fetch: bool):
        if g.kind == "embed":
            return {k: p_shardings[k] for k in self.embed_keys}
        if g.kind == "head":
            tree = {k: p_shardings[k] for k in self.head_home_keys}
            if fetch and self.head_reads_embed:
                tree = dict(tree)
                tree["embed"] = p_shardings["embed"]  # the tied head's borrowed table
            return tree
        if g.kind == "expert":
            moe = p_shardings["blocks"]["moe"]
            return {n: self._drop_expert_axis(moe[n]) for n in self.expert_names}
        if g.kind == "period":
            return p_shardings["blocks"]["periods"]
        if g.kind == "block":
            return {n: p_shardings["blocks"][n] for n in self.block_names(g)}
        if self.expert_stream:
            return self._strip_experts(p_shardings["blocks"])
        return p_shardings["blocks"]

    def group_shardings(self, p_shardings: Optional[Pytree]):
        """Per-fetch-group sharding trees from a full-params tree of
        :class:`~repro_torch.core.memkind.Sharding` (``None`` without a
        mesh).  Slicing a stacked leaf keeps its rank, so the blocks' layout
        applies to every layer group unchanged; expert groups drop the
        expert axis; the tied head's fetch group borrows ``embed``'s."""
        if p_shardings is None:
            return None
        return [self._group_sharding(g, p_shardings, fetch=True) for g in self.groups]

    def home_group_shardings(self, p_shardings: Optional[Pytree]):
        """Home-order sharding trees (no tied-embed aliasing): the layouts
        the optimizer pass stages gradients and moments at."""
        if p_shardings is None:
            return None
        return [self._group_sharding(g, p_shardings, fetch=False) for g in self.groups]

    # ------------------------------------------------------------- spilling
    def spill_key(self, g: WeightGroup) -> str:
        return f"{_KEY_PREFIX}/{g.key}"

    def spill_home(self, home: dict, store) -> dict:
        """Re-home every group at the ``DiskHost`` tier: one spill-store chunk
        per group (= one disk request per fetch), leaves replaced by memmap
        views.  Shape-only templates pass through; groups already on disk are
        not rewritten."""
        from repro_torch.core.spillstore import is_disk_leaf

        groups = {}
        for g in self.groups:
            tree = home["groups"][g.key]
            if not _concrete(tree):
                return home
            if all(is_disk_leaf(v) for v in tr.leaves(tree)):
                groups[g.key] = tree
                continue
            store.put(self.spill_key(g), tree)
            groups[g.key] = store.get(self.spill_key(g))
        return {"groups": groups}

    def is_spilled(self, home: dict) -> bool:
        from repro_torch.core.spillstore import is_disk_leaf

        return any(is_disk_leaf(v) for v in tr.leaves(home["groups"]))

    def device_home(self, home: dict, p_shardings: Optional[Pytree] = None, *,
                    device: DeviceLike = None) -> dict:
        """Every home group placed on ``device`` (the card unless ``"cpu"``):
        the ``param_kind="device"`` baseline, whose fetch groups pass through
        the engine by reference.  With ``p_shardings`` each group lands as
        DTensors at its home layout (each rank's shard)."""
        shardings = self.home_group_shardings(p_shardings)
        dev = resolve_device(device)
        groups = {}
        for i, g in enumerate(self.groups):
            tree = home["groups"][g.key]
            if shardings is None:
                groups[g.key] = tr.tree_map(lambda x: host_tensor(x).to(dev, copy=True), tree)
            else:
                groups[g.key] = tr.tree_map(lambda x, sh: sh.put(x), tree, shardings[i])
        return {"groups": groups}

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return (
            f"WeightStreamPlan({self.cfg.name}, layout={self.layout}, "
            f"n_groups={self.n_groups}, "
            f"layers_per_group={self.layers_per_group}, "
            f"expert_stream={self.expert_stream}, "
            f"total={self.total_param_bytes / 1e6:.1f}MB)"
        )
