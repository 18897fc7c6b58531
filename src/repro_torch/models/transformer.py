"""Model assembly: the uniform decoder stack and the recurrentgemma hybrid,
for training and serving.

Pre-norm residual blocks.  Parameters live in a
:class:`~repro_torch.models.layers.ParamTree` whose names follow the JAX
tree, in its three layouts (``models/transformer.py:init_model``):

  uniform stacks  — ``blocks.attn.wq`` ... stacked over ``(L, ...)``;
  period-scanned  — ``blocks.periods.pos_k`` stacked over the ``L // P``
                    full periods of the block pattern, then ``blocks.tail_k``
                    for the ``L % P`` layers left (recurrentgemma-2b: 8
                    periods of (rec, rec, attn) and a tail of 2 rec);
  unrolled        — ``blocks.layer_000`` ... (a pattern that repeats fewer
                    than twice, as the smoke configs).

The JAX package's ``scan`` over layers or periods becomes a Python loop over
:func:`layer_slots`, in layer order; the caches follow the same tree.

Modes:
  ``forward_train`` — full-sequence; returns logits (+ the MoE aux loss, 0
                      here); ``lm_loss`` adds the seq-chunked CE.
  ``prefill``       — full-sequence forward + populated caches.
  ``decode_step``   — one token against the caches (scalar or per-slot pos;
                      ring and recurrent caches take a scalar).

All three run one layer body (:func:`_layer`); they differ only in the
token mixer (attention over the prompt, a cache, or the whole sequence; the
recurrence with or without a carried state).

xLSTM stacks, MoE, audio codebooks, the vision prefix, M-RoPE and
sinusoidal positions are not ported yet (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

import functools
from typing import Callable, Iterator, Optional, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tr
from repro_torch.models import attention, layers, rglru, rope
from repro_torch.models.layers import ParamTree, Params


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    todo = []
    if cfg.family == "ssm":
        todo.append("xLSTM block stacks")
    if cfg.n_experts:
        todo.append("MoE layers")
    if cfg.n_codebooks:
        todo.append("audio codebooks")
    if cfg.vision_embed:
        todo.append("the vision prefix")
    if cfg.pos_type not in ("rope", "none"):
        todo.append(f"{cfg.pos_type} positions")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(todo)} not ported yet "
            "(ROADMAP.md, queue 1 item 7: the other model families)"
        )


def layer_slots(cfg: ModelConfig) -> Iterator[tuple[str, tuple, Optional[int]]]:
    """``(kind, path, index)`` of every layer, in layer order: the layer's
    parameters and cache are ``tree["blocks"][path...]`` (caches: ``tree[path...]``),
    at ``index`` along a stacked leading axis, or the whole subtree when
    ``index`` is None."""
    if cfg.uniform_blocks and cfg.use_scan:
        for i in range(cfg.n_layers):
            yield "attn", (), i
    elif cfg.period_scan:
        p = cfg.scan_period
        n_full = cfg.n_layers // p
        for j in range(n_full):
            for k in range(p):
                yield cfg.block_kind(k), ("periods", f"pos_{k}"), j
        for k in range(cfg.n_layers % p):
            yield cfg.block_kind(n_full * p + k), (f"tail_{k}",), None
    else:
        for i in range(cfg.n_layers):
            yield cfg.block_kind(i), (f"layer_{i:03d}",), None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, generator: torch.Generator, device) -> dict:
    kw = dict(generator=generator, device=device)
    if kind == "rec":
        return {
            "ln1": layers.init_norm(cfg.d_model, cfg.norm_type, device),
            "rec": rglru.init_rglru_block(cfg, **kw),
            "ln2": layers.init_norm(cfg.d_model, cfg.norm_type, device),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw),
        }
    p = {
        "ln1": layers.init_norm(cfg.d_model, cfg.norm_type, device),
        "attn": attention.init_attention(cfg, **kw),
        "ln2": layers.init_norm(cfg.d_model, cfg.norm_type, device),
    }
    if cfg.d_ff:
        p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
    return p


def _stack(trees: list) -> dict:
    first = trees[0]
    return {
        k: _stack([t[k] for t in trees]) if isinstance(v, dict) else torch.stack([t[k] for t in trees])
        for k, v in first.items()
    }


def _layer_tree(cfg: ModelConfig, make) -> dict:
    """The blocks' tree (parameters or caches) in the JAX package's layout,
    ``make(kind)`` giving one layer's subtree."""
    if cfg.uniform_blocks and cfg.use_scan:
        return _stack([make("attn") for _ in range(cfg.n_layers)])
    tree: dict = {}
    for kind, path, j in layer_slots(cfg):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if j is None:
            node[path[-1]] = make(kind)
        else:
            node.setdefault(path[-1], []).append(make(kind))
    if "periods" in tree:
        tree["periods"] = {k: _stack(v) for k, v in tree["periods"].items()}
    return tree


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None) -> ParamTree:
    """f32 parameters drawn from ``generator`` on ``device`` (the numbers
    differ from the JAX package's for the same seed; the distributions do
    not).  ``device="meta"`` gives shapes only.

    The draw order is fixed: the embedding, the untied head, then every
    layer in layer order (:func:`layer_slots`).  The group-wise init below
    walks the same order, so it gives these bits."""
    params = init_model_shell(cfg, generator, device)
    params["blocks"] = _layer_tree(cfg, lambda kind: _init_block(cfg, kind, generator, device))
    return ParamTree(params)


# One ``torch.Generator`` feeds every draw, so unlike the JAX package's
# per-layer keys a slice cannot be drawn out of order: the group-wise init
# (streamed parameters, ``train/steps.py``) draws the shell first, then each
# layer group in layer order, and homes each group before drawing the next.

def init_model_shell(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The non-``blocks`` leaves of :func:`init_model` (the embedding, the
    untied head, ``ln_f``), drawn first, as it draws them.  Leaves
    ``generator`` where layer 0's draws begin."""
    check_supported(cfg)
    kw = dict(generator=generator, device=device)
    params: dict = {"embed": layers.init_embed(cfg.vocab_size, cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["head"] = layers.init_head(cfg.d_model, cfg.vocab_size, **kw)
    params["ln_f"] = layers.init_norm(cfg.d_model, cfg.norm_type, device)
    return params


def init_model_slice(cfg: ModelConfig, generator: torch.Generator, device, lo: int,
                     hi: int) -> dict:
    """Layers ``[lo:hi)`` of :func:`init_model`'s ``blocks``, bitwise, from a
    ``generator`` that has drawn the shell and layers ``[0:lo)``: the stacked
    slice of a uniform stack, else the named blocks (``tail_k`` of a
    period-scanned stack, ``layer_###`` unrolled)."""
    check_supported(cfg)
    if cfg.uniform_blocks and cfg.use_scan:
        return _stack([_init_block(cfg, "attn", generator, device) for _ in range(lo, hi)])
    if cfg.period_scan:
        tail0 = (cfg.n_layers // cfg.scan_period) * cfg.scan_period
        if lo < tail0:
            raise ValueError("period-scanned ranges init via init_model_period_slice")
        return {f"tail_{i - tail0}": _init_block(cfg, cfg.block_kind(i), generator, device)
                for i in range(lo, hi)}
    return {f"layer_{i:03d}": _init_block(cfg, cfg.block_kind(i), generator, device)
            for i in range(lo, hi)}


def init_model_period_slice(cfg: ModelConfig, generator: torch.Generator, device, ulo: int,
                            uhi: int) -> dict:
    """Period units ``[ulo:uhi)`` of a period-scanned model's
    ``blocks["periods"]``, bitwise, from a ``generator`` that has drawn the
    shell and layers ``[0:ulo * P)``."""
    if not cfg.period_scan:
        raise ValueError("init_model_period_slice requires a period-scanned arch")
    check_supported(cfg)
    p = cfg.scan_period
    pos: dict = {k: [] for k in range(p)}
    for _ in range(ulo, uhi):
        for k in range(p):
            pos[k].append(_init_block(cfg, cfg.block_kind(k), generator, device))
    return {f"pos_{k}": _stack(v) for k, v in pos.items()}


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, cl: int, dtype, device) -> dict:
    if kind == "rec":
        return rglru.init_rglru_state(cfg, batch, device)
    w = cfg.window if cfg.family == "hybrid" else cl
    return attention.init_cache(cfg, batch, min(w or cl, cl) or cl, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                device=None) -> dict:
    """Decode state for a context of ``seq_len`` tokens, in the layout of the
    parameters: ``{"k": (L, B, T, K, H), "v": ...}`` for a uniform stack;
    ``{"periods": {"pos_k": ...}, "tail_k": ...}`` or ``{"layer_000": ...}``
    for the hybrid, whose attention layers hold ``min(window, T)``-slot rings
    and whose recurrent layers hold f32 states."""
    check_supported(cfg)
    cl = cfg.cache_len(seq_len)
    return _layer_tree(cfg, lambda kind: _init_layer_cache(cfg, kind, batch, cl, dtype, device))


def _at(tree, path: tuple, j: Optional[int]):
    """One layer's subtree: views along the stacked axis, so that writes
    land in the stacked tensors."""
    for key in path:
        tree = tree[key]
    return tree if j is None else _index(tree, j)


# ---------------------------------------------------------------------------
# embedding / positions / head
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = layers.embed_apply(params["embed"], batch["tokens"], dt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _angles(cfg: ModelConfig, seq_len: int, pos=None, device=None) -> Optional[torch.Tensor]:
    """RoPE angles for the whole sequence (prefill) or one step."""
    if cfg.pos_type != "rope":
        return None
    if pos is not None and torch.as_tensor(pos).dim() == 1:
        positions = torch.as_tensor(pos, device=device)[:, None]  # (B,1) per-slot positions
    elif pos is not None:
        positions = torch.as_tensor(pos, device=device).reshape(1, 1)
    else:
        positions = torch.arange(seq_len, device=device)[None]
    return rope.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.norm_apply(params["ln_f"], x, cfg.norm_type)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(x.dtype).T
    else:
        logits = layers.head_apply(params["head"], x)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's second half: pre-norm MLP plus residual."""
    if "mlp" not in p:
        return x
    h = layers.norm_apply(p["ln2"], x, cfg.norm_type)
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _store(cache: dict, state: dict) -> None:
    """Write a recurrent layer's new state into its cache views."""
    for k, v in state.items():
        cache[k].copy_(v)


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
           mix: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The layer body every pass runs: the pre-norm token mixer ``mix``
    (attention or the recurrence, on the normed input) plus residual, then
    the pre-norm MLP plus residual."""
    return _mlp(cfg, p, x + mix(layers.norm_apply(p["ln1"], x, cfg.norm_type)))


def _layer_train(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 angles: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer of the training forward (the JAX package's ``_block_train``
    / ``_hetero_block_train``): no cache; the recurrence starts from zero
    and runs the plain scan, as the JAX package's ``use_kernel=False``."""
    if kind == "rec":
        return _layer(cfg, p, x, lambda h: rglru.rglru_block_train(cfg, p["rec"], h)[0])
    return _layer(cfg, p, x, lambda h: attention.attention_train(cfg, p["attn"], h, angles))


def _layer_prefill(cfg: ModelConfig, kind: str, p: Params, cache: dict, x: torch.Tensor,
                   angles: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer's prefill: the body that :func:`prefill` and
    :func:`block_group_prefill` share.  Fills ``cache`` in place."""
    def mix(h):
        if kind == "rec":
            h, state = rglru.rglru_block_train(cfg, p["rec"], h, cache,
                                               use_kernel=cfg.attn_impl == "pallas")
            _store(cache, state)
            return h
        return attention.attention_prefill(cfg, p["attn"], h, angles, cache)[0]

    return _layer(cfg, p, x, mix)


def _layer_decode(cfg: ModelConfig, kind: str, p: Params, cache: dict, x: torch.Tensor,
                  angles: Optional[torch.Tensor], pos) -> torch.Tensor:
    """One layer's decode step: the body that :func:`decode_step` and
    :func:`block_group_decode` share.  Updates ``cache`` in place."""
    def mix(h):
        if kind == "rec":
            h, state = rglru.rglru_block_step(cfg, p["rec"], h, cache)
            _store(cache, state)
            return h
        return attention.attention_decode(cfg, p["attn"], h, angles, cache, pos)[0]

    return _layer(cfg, p, x, mix)


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------

#: what ``remat="dots"`` keeps from the forward (the JAX package's
#: ``dots_with_no_batch_dims_saveable``: the matmul outputs); everything else
#: is recomputed in the backward
_DOTS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` under the config's rematerialization: ``"none"`` keeps every
    activation, ``"full"`` recomputes the layer in the backward
    (``torch.utils.checkpoint``), ``"dots"`` recomputes all but the matmuls
    (a selective checkpoint)."""
    if cfg.remat == "none":
        return fn
    kw: dict = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)


def _unbind(tree) -> list:
    """The entries of a stacked (layer-axis) parameter subtree, as views:
    one ``unbind`` per leaf, whose backward stacks the layers' gradients in
    one op (per-layer indexing would add a full-size zero gradient per
    layer)."""
    flat, treedef = tr.flatten(tree)
    cols = [torch.unbind(x) for x in flat]
    return [tr.unflatten(treedef, [c[j] for c in cols]) for j in range(len(cols[0]))]


def _train_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 angles: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer of the training forward under the config's remat: the
    program :func:`forward_hidden` and the group stages share."""
    return _remat(cfg, functools.partial(_layer_train, cfg, kind))(p, x, angles)


def _plain(params) -> dict:
    return params.as_dict() if isinstance(params, ParamTree) else params


def forward_hidden(cfg: ModelConfig, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Trunk only: pre-head hidden states (B, S, D) and the MoE aux loss (a
    0-d f32 zero: the MoE layers are not ported).  Each layer runs under
    :func:`_remat`."""
    check_supported(cfg)
    params = _plain(params)
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, x.shape[1], device=x.device)
    stacked: dict = {}
    for kind, path, j in layer_slots(cfg):
        if j is None:
            p = _at(params["blocks"], path, None)
        else:
            if path not in stacked:
                stacked[path] = _unbind(_at(params["blocks"], path, None))
            p = stacked[path][j]
        x = _train_layer(cfg, kind, p, x, angles)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(cfg: ModelConfig, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), moe_aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch)
    return _head(cfg, _plain(params), x), aux


IGNORE_INDEX = -100


def cross_entropy_sum(logits: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum-form CE over non-ignored targets (for chunked accumulation):
    (f32 sum of the NLL, int32 count of valid targets).  The gold logit is a
    gather, the value of the JAX package's iota-compare masked sum."""
    lf = logits.to(torch.float32)
    valid = targets != IGNORE_INDEX
    tgt = torch.where(valid, targets, 0).to(torch.int64)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, tgt[..., None])[..., 0]
    return torch.sum((lse - gold) * valid), torch.sum(valid).to(torch.int32)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored targets.  Returns (loss, n_valid)."""
    total, n = cross_entropy_sum(logits, targets)
    n = torch.clamp(n, min=1)
    return total / n, n


def lm_loss(cfg: ModelConfig, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
    """``(loss, {"ce", "aux", "n_tokens"})`` of next-token prediction: the
    trunk, then :func:`head_stage_loss` on the whole tree."""
    params = _plain(params)
    x, aux = forward_hidden(cfg, params, batch)
    return head_stage_loss(cfg, params, x, aux, batch)


def prefill(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
            last_pos: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the caches (in place).
    Returns (logits at one position, caches).

    ``last_pos``: position whose logits to return — the last *real* prompt
    token when the prompt is right-padded.  ``None`` takes the last
    position.  Recurrences run through the ``rglru_scan`` kernel under
    ``attn_impl="pallas"`` (the port's kernel path), else the plain scan."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, x.shape[1], device=x.device)
    for kind, path, j in layer_slots(cfg):
        x = _layer_prefill(cfg, kind, _at(params["blocks"], path, j), _at(caches, path, j), x,
                           angles)
    return _head(cfg, params, _last(x, last_pos)), caches


def decode_step(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
                pos: Union[int, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """One decode step.  ``batch["tokens"]`` holds the new token per slot;
    ``pos`` is the absolute position being written (a scalar, or a (B,)
    vector of per-slot positions — the serving path on full-attention
    caches).  The caches are updated in place.  Returns (logits, caches)."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, 1, pos=pos, device=x.device)
    for kind, path, j in layer_slots(cfg):
        x = _layer_decode(cfg, kind, _at(params["blocks"], path, j), _at(caches, path, j), x,
                          angles, pos)
    return _head(cfg, params, x), caches


def _last(x: torch.Tensor, last_pos: Optional[int]) -> torch.Tensor:
    return x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]


# ---------------------------------------------------------------------------
# layer-group stages (streamed parameters — see repro_torch.core.weightstream)
#
# The passes above consume the whole parameter tree; these stages consume ONE
# transfer group at a time, so host- or disk-homed weights can arrive
# mid-stack: the embed group starts the residual stream, each stacked
# layer-group slice continues it through the same layer body
# (``_layer_train`` / ``_layer_prefill`` / ``_layer_decode``) on views ``[j]``
# with the resident stack's strides, and the head group finishes it (the
# training head computes the loss: ``head_stage_loss``, which ``lm_loss``
# also runs).  The caches are updated in place, so a group prefills and
# decodes into ``narrow``ed views of the dense cache: the same function as the
# monolithic pass, with no copy.
# ---------------------------------------------------------------------------


def _index(tree, j: int):
    """Entry ``j`` along the leading (layer) axis of every leaf: views."""
    if isinstance(tree, ParamTree):
        return tree.index(j)
    return {k: _index(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree.shape[0]


def embed_stage(cfg: ModelConfig, group: Params, batch: dict, pos=None) -> torch.Tensor:
    """Embed-group forward: ``group`` holds the plan's embed leaves
    (``{"embed": ...}``).  Returns the first hidden states."""
    return _embed(cfg, group, batch)


def stage_angles(cfg: ModelConfig, batch: dict, seq_len: int, pos=None) -> Optional[torch.Tensor]:
    """RoPE angles for the staged passes (``None`` without RoPE)."""
    return _angles(cfg, seq_len, pos=pos, device=batch["tokens"].device)


def block_group_prefill(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict,
                        x: torch.Tensor, angles: Optional[torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """Prefill over one stacked layer-group slice ``(Lg, ...)`` of a uniform
    stack: fills ``cache_slice`` (``(Lg, ...)``, e.g. a view of the dense
    cache) in place.  Returns ``(x, cache_slice)``."""
    for j in range(_n_layers(blocks_slice)):
        x = _layer_prefill(cfg, "attn", _index(blocks_slice, j), _index(cache_slice, j), x, angles)
    return x, cache_slice


def block_group_decode(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict,
                       x: torch.Tensor, angles: Optional[torch.Tensor], pos) -> tuple[torch.Tensor, dict]:
    """One decode step over one stacked layer-group slice, the same layer
    body as :func:`decode_step`'s.  Updates ``cache_slice`` in place.
    Returns ``(x, cache_slice)``."""
    for j in range(_n_layers(blocks_slice)):
        x = _layer_decode(cfg, "attn", _index(blocks_slice, j), _index(cache_slice, j), x, angles,
                          pos)
    return x, cache_slice


def block_decode_pre_moe(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict, x, angles,
                         pos):
    """The router-first half of a MoE layer's decode step: not ported."""
    raise NotImplementedError(
        "block_decode_pre_moe: the MoE layers are not ported yet "
        "(ROADMAP.md, queue 1 item 7: the other model families)"
    )


def head_stage_logits(cfg: ModelConfig, group: Params, x: torch.Tensor) -> torch.Tensor:
    """Head-group logits from trunk hidden states.  ``group`` holds ``ln_f``
    and the head weights (a tied head: the embed table, which the plan's
    head fetch group carries)."""
    return _head(cfg, group, x)


def head_stage_loss(cfg: ModelConfig, group: Params, x: torch.Tensor, aux: torch.Tensor,
                    batch: dict) -> tuple[torch.Tensor, dict]:
    """``(loss, {"ce", "aux", "n_tokens"})`` from the trunk's hidden states:
    ``ln_f``, the head (``group`` holds ``ln_f`` and the head weights, or the
    embed table of a tied head) and the CE, with ``aux`` carried in from the
    layer stages.

    With ``cfg.loss_chunk`` dividing the sequence (and shorter than it) the
    CE runs chunk by chunk along the sequence, each chunk's head and CE
    under a checkpoint, so the (B, S, V) logits never exist whole: the JAX
    package's seq-chunked loss, its chunks summed in the same order."""
    targets = batch["targets"]
    s = targets.shape[-1]
    c = cfg.loss_chunk
    if not c or s <= c or s % c != 0:
        ce, n = cross_entropy(_head(cfg, group, x), targets)
        return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n}

    def chunk(xc, tc):
        return cross_entropy_sum(_head(cfg, group, xc), tc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(s // c):
        nll, nv = ckpt.checkpoint(chunk, x[:, i * c:(i + 1) * c], targets[..., i * c:(i + 1) * c],
                                  use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        n = n + nv
    n = torch.clamp(n, min=1)
    ce = tot / n
    return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n}


def block_group_train(cfg: ModelConfig, blocks_slice: Params, x: torch.Tensor, aux: torch.Tensor,
                      angles: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over one stacked layer-group slice ``(Lg, ...)`` of a
    uniform stack: :func:`forward_hidden`'s layer program entered mid-stack.
    ``aux`` is the MoE aux-loss carry (unchanged: no MoE layers here).
    Returns ``(x, aux)``."""
    for p in _unbind(blocks_slice):
        x = _train_layer(cfg, "attn", p, x, angles)
    return x, aux


def hetero_group_train(cfg: ModelConfig, kinds, group: Params, x: torch.Tensor,
                       aux: torch.Tensor, angles: Optional[torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over one named-block group (the unrolled layout, a
    period-scanned stack's tail): ``kinds`` is the ``(name, block kind)``
    sequence in layer order.  Returns ``(x, aux)``."""
    for name, kind in kinds:
        x = _train_layer(cfg, kind, group[name], x, angles)
    return x, aux


def period_group_train(cfg: ModelConfig, periods_slice: Params, x: torch.Tensor,
                       aux: torch.Tensor, angles: Optional[torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over a slice of stacked period units
    (``{"pos_k": (U, ...)}``), each unit's positions in order.  Returns
    ``(x, aux)``."""
    period = cfg.scan_period
    cols = [_unbind(periods_slice[f"pos_{k}"]) for k in range(period)]
    for j in range(len(cols[0])):
        for k in range(period):
            x = _train_layer(cfg, cfg.block_kind(k), cols[k][j], x, angles)
    return x, aux


def init_cache_group(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Stacked decode-cache slice for ``n_layers`` uniform attention layers
    (the per-group analogue of :func:`init_caches`)."""
    cl = cfg.cache_len(seq_len)
    return _stack([attention.init_cache(cfg, batch, cl, dtype, device) for _ in range(n_layers)])
