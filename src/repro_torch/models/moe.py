"""Mixture-of-Experts: top-k routing, the GShard dispatch and the
router-first decode (the JAX package's ``models/moe.py``).

``moe_dispatch`` (training and prefill) groups the tokens by batch row and
``moe_group_size`` chunk of the sequence, gives each routed ``(token,
choice)`` a capacity slot in GShard order (the cumsum over the flattened
``(token, choice)`` order, per expert), drops what is past capacity, runs
every expert on its capacity buffer and combines the outputs with a
scatter-add.  ``moe_decode`` is the dense top-k of one decode token: no
capacity, no drops.  Its two halves, :func:`decode_route` and
:func:`decode_apply`, are what the route-aware weight stream runs with only
the routed experts' weights on the card, so splitting the experts into their
own fetch groups never changes what is computed.

Routing runs in f32 (the router product, softmax and top-k); on the card
the device setup turns TF32 off, so the router product is f32-exact.
``torch.topk`` does not promise an order among ties, so the top-k is a
stable descending sort: on ties the lower expert index comes first, as
``jax.lax.top_k`` gives it.

``moe_sorted_ep`` is expert parallelism over a ``DeviceMesh`` (the JAX
package's ``shard_map`` strategy): the tokens sharded over the data axes and
replicated over ``model``, each model rank's ``E / m`` experts run on a
token-sorted capacity buffer, the partial outputs summed over ``model``.
The buffer is filled by index assignment (kept slots are unique) and the
choices combine by a gather summed in choice order, so neither step needs a
float scatter-add: the card's atomics would fix no order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params

#: expert tensor names inside a block's ``moe`` subtree (``wg`` only when gated)
EXPERT_NAMES = ("wi", "wo", "wg")


def init_moe(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    """``router (D, E)``, ``wi (E, D, F)``, ``wo (E, F, D)`` and, for a gated
    MLP, ``wg (E, D, F)``, drawn from ``generator`` in that order."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device)
    p = {
        "router": layers.fan_in_init((d, e), d, **kw),
        "wi": layers.fan_in_init((e, d, f), d, **kw),
        "wo": layers.fan_in_init((e, f, d), f, **kw),
    }
    if cfg.mlp_type in layers.GATED:
        p["wg"] = layers.fan_in_init((e, d, f), d, **kw)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.moe_top_k * tokens_per_group * cfg.capacity_factor / cfg.n_experts)
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, descending,
    the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """``(top_w, top_i, probs, aux_losses)`` for ``x`` (..., D), in f32:
    renormalised top-k weights, the Switch load-balance loss and the router
    z-loss, weighted by the config's coefficients."""
    logits = torch.einsum("...d,de->...e", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, cfg.moe_top_k)
    top_w = top_w / torch.clamp(torch.sum(top_w, dim=-1, keepdim=True), min=1e-9)
    # load-balance loss (Switch eq. 4): E * sum_e fraction_e * prob_e
    e = cfg.n_experts
    lead = tuple(range(top_i.dim() - 1))
    frac = torch.mean(F.one_hot(top_i[..., 0], e).float(), dim=lead)
    pmean = torch.mean(probs, dim=lead)
    aux = e * torch.sum(frac * pmean)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    losses = cfg.router_aux_coef * aux + cfg.router_z_coef * z
    return top_w, top_i, probs, losses


def _expert_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, eqn_in: str,
                eqn_out: str) -> torch.Tensor:
    """Every expert's FFN on a buffer with an expert axis."""
    h = torch.einsum(eqn_in, x, p["wi"].to(x.dtype))
    h = layers._act(h, cfg.mlp_type)
    if cfg.mlp_type in layers.GATED:
        h = h * torch.einsum(eqn_in, x, p["wg"].to(x.dtype))
    return torch.einsum(eqn_out, h, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# router-first decode (route-aware expert streaming)
# ---------------------------------------------------------------------------


def decode_route(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Routing only: ``(top_w, top_i)`` of the decode token(s), from
    ``p["router"]`` alone.  The streamed decode runs it before any expert
    weight is on the card, then fetches only the routed experts."""
    top_w, top_i, _, _ = _router(cfg, {"router": p["router"]}, x)
    return top_w, top_i


def decode_apply(cfg: ModelConfig, stack: Params, top_w: torch.Tensor, top_i: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Dense per-token expert FFN from precomputed routing.  ``stack`` holds
    expert-stacked leaves ``{wi: (E', D, F), wo: (E', F, D), wg?}``, where
    ``E'`` is all the experts or a fetched subset that ``top_i`` indexes.
    The routed rows are gathered before any cast or arithmetic, so they are
    the same values whether they come from the full stack or a subset: the
    route-aware stream gives the all-expert run's bits."""
    wi = stack["wi"][top_i].to(x.dtype)  # (..., K, D, F)
    h = torch.einsum("...d,...kdf->...kf", x, wi)
    h = layers._act(h, cfg.mlp_type)
    if "wg" in stack:
        wg = stack["wg"][top_i].to(x.dtype)
        h = h * torch.einsum("...d,...kdf->...kf", x, wg)
    wo = stack["wo"][top_i].to(x.dtype)  # (..., K, F, D)
    y = torch.einsum("...kf,...kfd->...kd", h, wo)
    return torch.sum(y * top_w.to(x.dtype)[..., None], dim=-2)


def moe_decode(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One decode step's MoE FFN: routing, then the dense top-k over the
    whole expert stack (no capacity buffer, no drops)."""
    top_w, top_i = decode_route(cfg, p, x)
    stack = {n: p[n] for n in EXPERT_NAMES if n in p}
    return decode_apply(cfg, stack, top_w, top_i, x)


# ---------------------------------------------------------------------------
# the GShard dispatch (training and prefill)
# ---------------------------------------------------------------------------


def _dispatch_chunk(cfg: ModelConfig, p: Params, xg: torch.Tensor, tw: torch.Tensor,
                    ti: torch.Tensor) -> torch.Tensor:
    """One chunk of every batch row: ``xg`` (B, gs, D), routing ``tw``/``ti``
    (B, gs, K) -> (B, gs, D)."""
    b, gs, _ = xg.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    c = _capacity(cfg, gs)
    ti_flat = ti.reshape(b, gs * k)
    e_oh = F.one_hot(ti_flat, e).float()  # (B, gs*K, E)
    # capacity slot: the (token, choice) pair's rank among its expert's
    # pairs, in the flattened (token, choice) order
    pos = torch.sum((torch.cumsum(e_oh, dim=1) - 1.0) * e_oh, dim=-1)  # (B, gs*K)
    w = tw.reshape(b, gs * k) * (pos < c)
    rows = torch.arange(b, device=xg.device)[:, None].expand(b, gs * k)
    tok_of = torch.arange(gs, device=xg.device).repeat_interleave(k)[None].expand(b, gs * k)
    slot = torch.clamp(pos.long(), max=c - 1)
    combine = torch.zeros((b, gs, e, c), dtype=torch.float32, device=xg.device)
    combine.index_put_((rows, tok_of, ti_flat, slot), w, accumulate=True)
    dispatch = (combine > 0.0).to(xg.dtype)
    ex_in = torch.einsum("bsec,bsd->becd", dispatch, xg)
    ex_out = _expert_ffn(cfg, p, ex_in, "becd,edf->becf", "becf,efd->becd")
    return torch.einsum("bsec,becd->bsd", combine.to(xg.dtype), ex_out)


def moe_dispatch(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, D) -> ``(y, aux_loss)``.  Tokens group by batch row and
    ``moe_group_size`` chunk of the sequence; each chunk runs in turn (under
    a checkpoint when gradients are on, as the JAX package remats it), so
    peak dispatch memory is one chunk's ``(B, gs, E, C)`` combine tensor.
    Tokens past an expert's capacity are dropped."""
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, s)
    if s % gs:
        raise ValueError(f"seq {s} % group {gs} != 0")
    n_chunks = s // gs
    xc = x.reshape(b, n_chunks, gs, d)
    top_w, top_i, _, aux = _router(cfg, p, xc)  # (B, n_chunks, gs, K)
    remat = torch.is_grad_enabled() and x.requires_grad
    ys = []
    for j in range(n_chunks):
        args = (cfg, p, xc[:, j], top_w[:, j], top_i[:, j])
        ys.append(ckpt.checkpoint(_dispatch_chunk, *args, use_reentrant=False,
                                  preserve_rng_state=False) if remat else _dispatch_chunk(*args))
    return torch.stack(ys, dim=1).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the sorted capacity scatter over a mesh (expert parallelism)
# ---------------------------------------------------------------------------


def moe_sorted_local(cfg: ModelConfig, p: Params, x: torch.Tensor, e_local: int,
                     e_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-sorted capacity scatter over the ``e_local`` experts from
    ``e_offset`` (the JAX package's ``_moe_sorted_local``).  ``x`` (T, D) is
    the rank's replicated view of its tokens, ``p`` holds the full
    ``router`` and the rank's expert slices; returns ``(y, aux)``, ``y`` the
    rank's partial output (summed over the model axis by the caller)."""
    t, d = x.shape
    k = cfg.moe_top_k
    dev = x.device
    top_w, top_i, _, aux = _router(cfg, {"router": p["router"]}, x)
    flat_i = top_i.reshape(-1)  # (T*K,) global expert ids
    flat_w = top_w.reshape(-1)
    tok_of = torch.arange(t, device=dev).repeat_interleave(k)
    local = (flat_i >= e_offset) & (flat_i < e_offset + e_local)
    lexp = torch.where(local, flat_i - e_offset, e_local)  # e_local: the overflow bin
    # rank of each (token, choice) within its local expert, in index order
    order = torch.argsort(lexp, stable=True)
    sorted_e = lexp[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e_local + 1, device=dev))
    rank = torch.empty_like(lexp)
    rank[order] = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    cap = _capacity(cfg, t)
    keep = local & (rank < cap)
    slot = torch.where(keep, lexp * cap + rank, e_local * cap)  # the overflow slot
    # the capacity buffer (+1 overflow row, dropped): kept slots are unique,
    # and every write to the overflow row is zero, so assignment is the JAX
    # package's scatter-add into zeros
    rows = torch.where(keep[:, None], x[tok_of], torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros((e_local * cap + 1, d), dtype=x.dtype, device=dev).index_put((slot,), rows)
    ex_in = buf[: e_local * cap].reshape(e_local, cap, d)
    ex_out = _expert_ffn(cfg, p, ex_in, "ecd,edf->ecf", "ecf,efd->ecd")
    # gather back, weight, and combine each token's choices in choice order
    # (the JAX package's index-order scatter-add over ``tok_of``)
    flat_out = torch.cat([ex_out.reshape(e_local * cap, d), ex_out.new_zeros((1, d))])
    per_choice = (flat_out[slot] * (flat_w * keep).to(x.dtype)[:, None]).reshape(t, k, d)
    y = per_choice[:, 0]
    for j in range(1, k):
        y = y + per_choice[:, j]
    return y, aux


def moe_sorted_ep(cfg: ModelConfig, p: Params, x: torch.Tensor, mesh,
                  data_axes: tuple = ("data",),
                  model_axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``mesh``: ``x`` (B, S, D) -> ``(y, aux)``.
    Each rank takes its shard of the batch over ``data_axes``, replicated
    over ``model_axis``, and its ``E / m`` experts (``Shard(0)`` over
    ``model_axis``, redistributed from the placements it was given), runs
    :func:`moe_sorted_local`, and the partial outputs are summed over
    ``model_axis`` (``Partial`` to ``Replicate``); ``aux`` is averaged over
    the data and model axes.  Autograd carries each step back: the local
    gradients of the replicated inputs are partial sums over the ranks that
    shared them.  DTensors come back as DTensors; plain tensors are taken
    as replicated and come back plain and full."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    m = mesh.shape[names.index(model_axis)]
    e = cfg.n_experts
    assert e % m == 0, f"experts {e} must divide model axis {m} for sorted_ep"
    e_local = e // m
    reduced = (*data_axes, model_axis)

    def per_dim(data, model, other):
        return [data if n in data_axes else model if n == model_axis else other for n in names]

    rep = [Replicate()] * mesh.ndim
    plain = not isinstance(x, DTensor)

    def local_of(t, placements, grads):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        if list(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        return t.to_local(grad_placements=grads)

    # tokens over the data axes, replicated over model: each model rank's
    # gradient is its experts' share, summed over model on the way back
    xb = local_of(x, per_dim(Shard(0), Replicate(), Replicate()),
                  per_dim(Shard(0), Partial(), Replicate()))
    p_local = {"router": local_of(p["router"], rep,
                                  per_dim(Partial(), Partial(), Replicate()))}
    for n in EXPERT_NAMES:
        if n in p:
            p_local[n] = local_of(p[n], per_dim(Replicate(), Shard(0), Replicate()),
                                  per_dim(Partial(), Shard(0), Replicate()))
    midx = mesh.get_local_rank(model_axis)
    b, s, d = xb.shape
    y, aux = moe_sorted_local(cfg, p_local, xb.reshape(b * s, d), e_local, midx * e_local)
    shape = torch.Size(x.shape)
    y = DTensor.from_local(y.reshape(b, s, d), mesh, per_dim(Shard(0), Partial(), Replicate()),
                           shape=shape, stride=torch.empty(shape, device="meta").stride(),
                           run_check=False)
    y = y.redistribute(mesh, per_dim(Shard(0), Replicate(), Replicate()))
    n = math.prod(mesh.shape[names.index(a)] for a in reduced)
    aux = DTensor.from_local(aux, mesh, [Partial() if a in reduced else Replicate() for a in names],
                             run_check=False).redistribute(mesh, rep) / n
    if plain:
        return y.full_tensor(), aux.to_local()
    return y, aux
