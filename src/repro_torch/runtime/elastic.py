"""Elastic re-meshing, reduced to what one card uses.

The JAX package's ``runtime/elastic.py`` resumes a job on a different device
count: it fingerprints the mesh into every checkpoint, re-derives the mesh
on restart, and re-partitions grouped (weight-streamed) checkpoints by
streaming.  The port runs on one card, so its mesh is always
``(data=1, model=1)``: :func:`mesh_fingerprint` gives that identity under
the JAX package's keys, and :func:`check_restart_mesh` refuses to resume a
run fingerprinted on another device count.  The 2 <-> 1-device re-mesh
needs multi-device support (ROADMAP.md, queue 1 item 5), and the grouped
checkpoint reshard needs the streamed-weight train step (the next slice of
queue 1 item 6); both raise.
"""
from __future__ import annotations

import re
from typing import Optional

#: where the parts this module refuses are queued (the launcher names them too)
MULTI_DEVICE = "multi-device re-meshing (ROADMAP.md, queue 1 item 5: multi-device and tooling)"
WEIGHT_STREAMED = ("the streamed-weight train step (ROADMAP.md, queue 1 item 6: its "
                   "streamed-weight part, the next slice)")

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


def reshard_grouped_checkpoint(*args, **kwargs):
    """Re-partition a grouped (weight-streamed) checkpoint: not ported."""
    raise NotImplementedError(f"reshard_grouped_checkpoint needs {WEIGHT_STREAMED} and "
                              f"{MULTI_DEVICE}")


def ensure_plan_matches_checkpoint(*args, **kwargs):
    """Reshard a grouped checkpoint to the live plan on resume: not ported."""
    raise NotImplementedError(f"ensure_plan_matches_checkpoint needs {WEIGHT_STREAMED}")


def prune_stale_spill(*args, **kwargs):
    """Drop the spill chunks of an old weight grouping: not ported."""
    raise NotImplementedError(f"prune_stale_spill needs {WEIGHT_STREAMED}")
