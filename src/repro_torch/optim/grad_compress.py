"""Gradient compression for the cross-pod all-reduce (the JAX package's
``optim/grad_compress.py``).

Across pods the gradient all-reduce crosses the slow network between them,
so its traffic is compressed.  Two codecs:

  * ``bf16`` — cast f32 gradients to bf16 for the reduce (2x), no state.
  * ``int8`` — per-leaf max-abs scaling to int8 (4x) with **error
    feedback**: the quantization residual is carried and added to the next
    step's gradient (Karimireddy et al.).

The codecs act on the port's trees (:mod:`repro_torch.core.tree`) with the
JAX package's arithmetic in its order: f32, ``round`` half to even, a clip
to ±127, the scale ``max(max|g|, 1e-30) / 127``.
:func:`pod_allreduce_int8` runs the int8 reduce over one dim of a
``DeviceMesh`` (one process a rank, NCCL on the card or gloo).

The JAX package runs its codecs op by op in its tests, but its all-reduce
only compiled (``shard_map`` under ``jit``), and XLA's program rounds
differently: it folds ``/ 127`` into a product with the f32 constant
``1 / 127``, and its fused loop contracts the re-quantization's residual
``v - q' * t`` into one fused multiply-add.  The codecs here are the op by
op arithmetic; :func:`pod_allreduce_int8` takes the compiled program's
rounding points, the fused multiply-add computed in f64 (where ``q' * t``,
an int8 times an f32, and the residual are exact) and rounded once to f32,
so the CPU and the card give the same bits.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import tree as tr

Pytree = Any

__all__ = ["compress_bf16", "decompress_bf16", "init_error_state", "compress_int8",
           "decompress_int8", "requantize_int8", "pod_allreduce_int8"]


def compress_bf16(grads: Pytree) -> Pytree:
    return tr.tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads: Pytree) -> Pytree:
    return tr.tree_map(lambda g: g.to(torch.float32), grads)


def init_error_state(grads: Pytree) -> Pytree:
    return tr.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads)


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def compress_int8(grads: Pytree, error: Optional[Pytree] = None
                  ) -> tuple[Pytree, Pytree, Pytree]:
    """Returns ``(int8 payload, scales, new error state)``; ``g + error ==
    q * scale + new error`` for every leaf, in f32."""

    def leaf(g, e):
        gf = g.to(torch.float32) + (e if e is not None else 0.0)
        scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-30) / 127.0
        q = _quantize(gf, scale)
        return q, scale, gf - q.to(torch.float32) * scale

    flat_g, treedef = tr.flatten(grads)
    flat_e = [None] * len(flat_g) if error is None else tr.leaves(error)
    qs, scales, errs = zip(*(leaf(g, e) for g, e in zip(flat_g, flat_e)))
    return (tr.unflatten(treedef, list(qs)), tr.unflatten(treedef, list(scales)),
            tr.unflatten(treedef, list(errs)))


def decompress_int8(payload: Pytree, scales: Pytree) -> Pytree:
    return tr.tree_map(lambda q, s: q.to(torch.float32) * s, payload, scales)


def requantize_int8(payload: Pytree, scales: Pytree,
                    target_scales: Pytree) -> tuple[Pytree, Pytree]:
    """An int8 payload quantized at ``scales`` re-quantized onto
    ``target_scales``: ``(payload', extra_error)`` with ``q * s == q' * t +
    extra_error`` per leaf, so the residual can join the error state.  With
    ``t >= s`` (the cross-pod max) nothing clips."""

    def leaf(q, s, t):
        v = q.to(torch.float32) * s
        q2 = _quantize(v, t)
        return q2, v - q2.to(torch.float32) * t

    flat_q, treedef = tr.flatten(payload)
    qs, errs = zip(*(leaf(q, s, t) for q, s, t in
                     zip(flat_q, tr.leaves(scales), tr.leaves(target_scales))))
    return tr.unflatten(treedef, list(qs)), tr.unflatten(treedef, list(errs))


def pod_allreduce_int8(grads: Pytree, axis: str, error: Pytree,
                       mesh=None) -> tuple[Pytree, Pytree]:
    """The int8-compressed mean over mesh dim ``axis`` (``"pod"`` on
    ``make_production_mesh(multi_pod=True)``, or ``"data"``): ``(out,
    new error)``.  ``mesh`` defaults to the one-dim mesh ``(axis,)`` over
    every rank of the process group.

    The ranks first agree on one scale a leaf (an all-reduce ``MAX`` of the
    scales), each re-quantizes its payload onto it and folds the residual
    into its error state (so ``contribution + error == gradient`` stays
    exact), then the int32 payloads are summed (an all-reduce ``SUM``) and
    rescaled: ``sum * pmax / n``.  Each all-reduce carries every leaf at
    once.  The rounding is the JAX package's compiled program's (the
    module's docstring)."""
    import torch.distributed as dist

    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh

        leaf0 = tr.leaves(grads)[0]
        mesh = init_device_mesh(leaf0.device.type, (dist.get_world_size(),),
                                mesh_dim_names=(axis,))
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    flat_g, treedef = tr.flatten(grads)
    gf = [g.to(torch.float32) + e for g, e in zip(flat_g, tr.leaves(error))]
    # XLA's ``/ 127``: a product with the f32 constant 1 / 127
    scales = torch.stack([torch.clamp(torch.max(torch.abs(x)), min=1e-30) for x in gf])
    scales = scales * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=scales.device)
    qs = [_quantize(x, s) for x, s in zip(gf, scales)]
    pmax = scales.clone()
    dist.all_reduce(pmax, op=dist.ReduceOp.MAX, group=group)
    out_q, err = [], []
    for x, q, s, t in zip(gf, qs, scales, pmax):
        v = q.to(torch.float32) * s
        q2 = _quantize(v, t)
        # the residual of the re-quantization as one fused multiply-add
        extra = (v.double() - q2.double() * t.double()).float()
        out_q.append(q2)
        err.append((x - v) + extra)
    summed = torch.cat([q.reshape(-1).to(torch.int32) for q in out_q])
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    out = [si.reshape(q.shape).to(torch.float32) * t / n
           for si, q, t in zip(summed.split([q.numel() for q in out_q]), out_q, pmax)]
    return tr.unflatten(treedef, out), tr.unflatten(treedef, err)
