"""Elastic re-meshing, reduced to what one card uses.

The JAX package's ``runtime/elastic.py`` resumes a job on a different device
count: it fingerprints the mesh into every checkpoint, re-derives the mesh
on restart, and re-partitions grouped (weight-streamed) checkpoints by
streaming.  The port runs on one card, so its mesh is always
``(data=1, model=1)``: :func:`mesh_fingerprint` gives that identity under
the JAX package's keys, and :func:`check_restart_mesh` refuses to resume a
run fingerprinted on another device count.  The 2 <-> 1-device re-mesh
needs multi-device support (ROADMAP.md, queue 1 item 5) and raises.  The grouped
checkpoint reshard runs as in the JAX package: when the weight grouping of a
streamed-weight run changes (another budget or group size), its grouped
checkpoint is repartitioned in place by streaming, one output leaf in memory
at a time, and the spill chunks of the old grouping are pruned.
"""
from __future__ import annotations

import logging
import re
from typing import Optional

#: where the parts this module refuses are queued
MULTI_DEVICE = "multi-device re-meshing (ROADMAP.md, queue 1 item 5: multi-device and tooling)"

log = logging.getLogger("repro_torch.elastic")

#: the checkpoint manager's leaf-name separator
_SEP = "__"

_GROUP_KEY_RE = re.compile(
    r"g(\d{3,})_(embed|head|"
    r"(layers|expert|period|block)_(\d{3,})_(\d{3,})(?:_e(\d{2,}))?)"
)


def elastic_mesh_shape(
    n_devices: int,
    *,
    model: int = 16,
    prefer_pods: bool = True,
    pod_size: Optional[int] = None,
) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) shape that fits ``n_devices`` (the JAX
    package's policy: keep the model axis, shrink or grow the data axis)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if n_devices < model:
        raise ValueError(f"{n_devices} devices cannot host a model axis of {model}")
    if n_devices % model != 0:
        raise ValueError(f"{n_devices} devices not divisible by model={model}")
    rest = n_devices // model
    if prefer_pods and pod_size:
        if (
            pod_size % model == 0
            and pod_size >= model
            and n_devices % pod_size == 0
            and n_devices // pod_size > 1
        ):
            return (n_devices // pod_size, pod_size // model, model), ("pod", "data", "model")
    if prefer_pods and rest % 16 == 0 and rest // 16 > 1:
        return (rest // 16, 16, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def mesh_fingerprint(n_devices: int = 1) -> dict:
    """JSON-serializable identity of the run's mesh (checkpoint and run
    metadata), under the JAX package's keys: the elastic mesh over
    ``n_devices`` with a model axis of 1 — the port's one card by default."""
    if n_devices != 1:
        raise NotImplementedError(f"a mesh over {n_devices} devices needs {MULTI_DEVICE}")
    shape, axes = elastic_mesh_shape(n_devices, model=1, prefer_pods=False)
    return {"n_devices": n_devices, "shape": list(shape), "axes": list(axes)}


class RemeshRequired(RuntimeError):
    """The run's device count no longer matches the mesh its checkpoints
    were written on."""


def check_restart_mesh(expected: dict, n_devices: int = 1) -> None:
    """Called by the driver's restart loop: raise :class:`RemeshRequired`
    when ``expected`` (a :func:`mesh_fingerprint`) names another device
    count than the run's ``n_devices`` (the port's one card)."""
    if expected.get("n_devices") == n_devices:
        return
    raise RemeshRequired(
        f"checkpoints were written on {expected.get('n_devices')} devices "
        f"{tuple(expected.get('shape') or ())}, this run has {n_devices}: resuming across "
        f"device counts needs {MULTI_DEVICE}"
    )


def parse_group_key(key: str) -> Optional[dict]:
    """Parse a weight-stream group key (``g000_embed`` /
    ``g001_layers_000_002`` / ``g003_period_000_004`` /
    ``g002_block_002_003`` / ``g002_expert_001_002_e03`` / ``g004_head``)
    into its kind + layer bounds (+ expert index, -1 for non-expert kinds);
    None for names that are not group keys."""
    m = _GROUP_KEY_RE.fullmatch(key)
    if m is None:
        return None
    if m.group(2) in ("embed", "head"):
        return {"key": key, "kind": m.group(2), "lo": 0, "hi": 0, "expert": -1}
    kind, expert = m.group(3), m.group(6)
    if (kind == "expert") != (expert is not None):
        return None  # the _eNN suffix is exactly the expert kinds' marker
    return {"key": key, "kind": kind, "lo": int(m.group(4)), "hi": int(m.group(5)),
            "expert": int(expert) if expert is not None else -1}


def reshard_grouped_checkpoint(ckpt, plan, *, step: Optional[int] = None,
                               extra_meta: Optional[dict] = None) -> bool:
    """Repartition a grouped (weight-streamed) checkpoint into ``plan``'s
    grouping, in place, at the same step.

    The old partition is read from the stored leaf names
    (``{params|opt}__groups__<gkey>__<subpath>``).  For each new layer group
    ``[lo, hi)`` every overlapping old group's stacked leaves are mapped
    read-only, sliced along axis 0 and concatenated, one output leaf in
    memory at a time; named blocks move whole to the group that homes them;
    embed, head and non-group leaves (``opt__step``) pass through under
    their new keys.  Values are only repartitioned, never transformed, so a
    resumed run's losses stay bitwise.

    Returns True when it resharded; False when there is nothing to do (no
    checkpoint, not grouped, or the same partition)."""
    import numpy as np

    if step is None:
        step = ckpt.latest_step()
    if step is None:
        return False
    meta = ckpt.load_meta(step)
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in meta["leaves"]}

    # the old partition, from the leaf names
    old_groups: dict = {}
    subs: dict = {}
    passthrough: list = []
    for leaf in meta["leaves"]:
        name = leaf["name"]
        parts = name.split(_SEP)
        g = (parse_group_key(parts[2])
             if len(parts) >= 4 and parts[0] in ("params", "opt") and parts[1] == "groups"
             else None)
        if g is None:
            passthrough.append(name)
            continue
        old_groups[parts[2]] = g
        subs.setdefault((parts[0], parts[2]), []).append(_SEP.join(parts[3:]))
    if not old_groups:
        return False  # not a grouped checkpoint
    if set(old_groups) == {g.key for g in plan.groups}:
        return False  # the same partition

    mid_old = frozenset(g["kind"] for g in old_groups.values() if g["kind"] not in ("embed", "head"))
    mid_new = frozenset(g.kind for g in plan.groups if g.kind not in ("embed", "head"))
    if mid_old != mid_new:
        raise ValueError(
            f"checkpoint step {step} was written with a {sorted(mid_old)} group program but the "
            f"plan builds {sorted(mid_new)} — kind-family changes (e.g. toggling "
            "--expert-stream) cannot be streamed between partitions; resume with the original "
            "flags, or export the params and re-import under the new program")
    if "expert" in mid_old:
        raise ValueError(
            f"checkpoint step {step} and the plan both use expert-split groups but their group "
            "keys differ — the MoE shape changed; re-grouping cannot change the model")
    # stacked middle kinds reslice along axis 0 ("period" in period units);
    # named "block" groups move whole block subtrees
    stacked_kind = ("layers" if "layers" in mid_old
                    else "period" if "period" in mid_old else None)
    old_stacked = sorted((g for g in old_groups.values() if g["kind"] == stacked_kind),
                         key=lambda g: g["lo"])
    scale = plan.scan_period if stacked_kind == "period" else 1
    old_blocks = {k: g for k, g in old_groups.items() if g["kind"] == "block"}
    old_embed = next((k for k, g in old_groups.items() if g["kind"] == "embed"), None)
    old_head = next((k for k, g in old_groups.items() if g["kind"] == "head"), None)
    span = max((g["hi"] for g in old_groups.values() if g["kind"] not in ("embed", "head")),
               default=0)
    if span != plan.n_layers:
        raise ValueError(f"checkpoint step {step} covers {span} layers but the plan has "
                         f"{plan.n_layers} — re-grouping cannot change the model")
    new_embed, new_head = plan.groups[0].key, plan.groups[-1].key

    def load(name: str):
        return ckpt.load_leaf(step, name, dtype=dtypes.get(name), mmap=True)

    def leaves():
        # a params-only checkpoint (a serving export) has no ("opt", key) subs
        for top in ("params", "opt"):
            for old_key, new_key in ((old_embed, new_embed), (old_head, new_head)):
                for sub in subs.get((top, old_key), []):
                    yield (_SEP.join((top, "groups", new_key, sub)),
                           load(_SEP.join((top, "groups", old_key, sub))))
            if old_stacked:
                layer_subs = subs.get((top, old_stacked[0]["key"]), [])
                for ng in plan.groups:
                    if ng.kind != stacked_kind:
                        continue
                    for sub in layer_subs:
                        parts = []
                        for og in old_stacked:
                            lo, hi = max(ng.lo, og["lo"]), min(ng.hi, og["hi"])
                            if lo >= hi:
                                continue
                            arr = load(_SEP.join((top, "groups", og["key"], sub)))
                            parts.append(arr[(lo - og["lo"]) // scale:(hi - og["lo"]) // scale])
                        out = (np.ascontiguousarray(parts[0]) if len(parts) == 1
                               else np.concatenate([np.asarray(p) for p in parts], axis=0))
                        if getattr(parts[0], "spill_dtype", None):
                            out = out.view(type(parts[0]))  # keep bf16 named
                        yield _SEP.join((top, "groups", ng.key, sub)), out
            if old_blocks:
                # each sub is "<block name>__<rest>": whole named blocks move
                # to the new group that homes that name
                sub_home = {}
                for old_key in old_blocks:
                    for sub in subs.get((top, old_key), []):
                        sub_home[sub] = old_key
                for ng in plan.groups:
                    if ng.kind != "block":
                        continue
                    names = set(plan.block_names(ng))
                    for sub, old_key in sub_home.items():
                        if sub.split(_SEP)[0] in names:
                            yield (_SEP.join((top, "groups", ng.key, sub)),
                                   load(_SEP.join((top, "groups", old_key, sub))))
        for name in passthrough:
            yield name, load(name)

    log.info("re-sharding checkpoint step %d: %d old groups -> %d new groups "
             "(layers_per_group=%d), one group leaf at a time",
             step, len(old_groups), plan.n_groups, plan.layers_per_group)
    ckpt.save_streamed(step, leaves(), extra_meta=extra_meta,
                       treedef=meta.get("treedef", "resharded"))
    return True


def ensure_plan_matches_checkpoint(checkpoint_dir, plan, *,
                                   run_meta: Optional[dict] = None) -> bool:
    """The launcher's resume check: when the latest checkpoint's weight
    grouping differs from ``plan``'s (another budget or group size),
    repartition it in place before the driver restores.  Returns True when
    it resharded."""
    from pathlib import Path

    from repro_torch.checkpoint.manager import CheckpointManager

    if not Path(checkpoint_dir).exists():
        return False
    ckpt = CheckpointManager(checkpoint_dir, keep=0)  # keep=0: never prunes
    step = ckpt.latest_step()
    if step is None:
        return False
    return reshard_grouped_checkpoint(ckpt, plan, step=step, extra_meta=run_meta)


def prune_stale_spill(store, plan) -> int:
    """Drop the spill chunks of a previous grouping (``wp/`` and ``wopt/``
    keys not in ``plan``) from a durable store, so regroupings leave no dead
    chunk files.  Returns the number removed."""
    valid = {plan.spill_key(g) for g in plan.groups} | {f"wopt/{g.key}" for g in plan.groups}
    stale = [k for k in list(store.keys())
             if (k.startswith("wp/") or k.startswith("wopt/")) and k not in valid]
    for k in stale:
        store.delete(k)
    if stale:
        log.info("pruned %d stale spill chunk(s) left by a previous grouping", len(stale))
    return len(stale)
