"""Model assembly: the uniform decoder stack, the recurrentgemma hybrid and
the xLSTM stack, for training and serving.

Pre-norm residual blocks.  Parameters live in a
:class:`~repro_torch.models.layers.ParamTree` whose names follow the JAX
tree, in its three layouts (``models/transformer.py:init_model``):

  uniform stacks  — ``blocks.attn.wq`` ... stacked over ``(L, ...)``;
  period-scanned  — ``blocks.periods.pos_k`` stacked over the ``L // P``
                    full periods of the block pattern, then ``blocks.tail_k``
                    for the ``L % P`` layers left (recurrentgemma-2b: 8
                    periods of (rec, rec, attn) and a tail of 2 rec;
                    xlstm-1.3b: 6 periods of 7 mLSTM and an sLSTM);
  unrolled        — ``blocks.layer_000`` ... (a pattern that repeats fewer
                    than twice, as the smoke configs).

The JAX package's ``scan`` over layers or periods becomes a Python loop over
:func:`layer_slots`, in layer order; the caches follow the same tree.

Modes:
  ``forward_train`` — full-sequence; returns logits (+ the MoE aux loss,
                      summed over the layers); ``lm_loss`` adds the
                      seq-chunked CE.
  ``prefill``       — full-sequence forward + populated caches.
  ``decode_step``   — one token against the caches (scalar or per-slot pos;
                      ring and recurrent caches take a scalar).

All three run one layer body (:func:`_layer`); they differ only in the
token mixer (attention over the prompt, a cache, or the whole sequence; the
recurrence with or without a carried state) and in a MoE layer's FFN: the
GShard dispatch (:func:`repro_torch.models.moe.moe_dispatch`, with its aux
loss) over a whole sequence (in training with a mesh and
``moe_impl="sorted_ep"``, the expert-parallel
:func:`~repro_torch.models.moe.moe_sorted_ep`), the router-first dense top-k
(:func:`~repro_torch.models.moe.moe_decode`) for one decode token.  An
xLSTM block (``mlstm`` / ``slstm``) is its own token mixer and carries no
MLP.

The modality front ends (:mod:`repro_torch.models.frontends`) enter at the
embedding and the head: a codebook model (musicgen) sums its K codebooks'
embeddings over ``batch["codes"]`` (B, K, S) and answers with K heads,
(B, K, S, V) logits; a vision model (qwen2-vl) prepends its merged patch
embeddings ``batch["vision_embeds"]`` to the text, its loss ignores that
prefix, and its M-RoPE angles come from ``batch["positions_3d"]`` (B, 3, S)
(per step in decode).  Sinusoidal positions are added at the embedding.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterator, Optional, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as tr
from repro_torch.models import attention, frontends, layers, moe, rglru, rope, xlstm
from repro_torch.models.layers import ParamTree, Params
from repro_torch.parallel import local


#: the position schemes the model runs (the JAX package's ``_embed`` and
#: ``_angles``)
POS_TYPES = ("rope", "mrope", "sinusoidal", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this port does not run: a
    position scheme outside :data:`POS_TYPES`."""
    if cfg.pos_type not in POS_TYPES:
        raise NotImplementedError(f"{cfg.name}: {cfg.pos_type!r} positions are not implemented "
                                  f"(have {POS_TYPES})")


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
    if kind == "mlstm":
        return {"ln1": layers.init_norm(cfg.d_model, cfg.norm_type, device),
                "mlstm": xlstm.init_mlstm_block(cfg, **kw)}
    if kind == "slstm":
        return {"ln1": layers.init_norm(cfg.d_model, cfg.norm_type, device),
                "slstm": xlstm.init_slstm_block(cfg, **kw)}
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
    if cfg.n_experts:
        p["moe"] = moe.init_moe(cfg, **kw)
    elif cfg.d_ff:
        p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
    return p


def _stack(trees: list) -> dict:
    """Stack the trees' leaves on a new leading axis; one tree's leaves
    gain the axis as views (a one-layer slice of the group-wise init holds
    one f32 copy, not two)."""
    first = trees[0]
    return {
        k: _stack([t[k] for t in trees]) if isinstance(v, dict)
        else v.unsqueeze(0) if len(trees) == 1 else torch.stack([t[k] for t in trees])
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

    The draw order is fixed: the embedding (a codebook model's codebooks,
    then its heads), the untied head, the vision merger, then every layer in
    layer order (:func:`layer_slots`).  The group-wise init below
    walks the same order, so it gives these bits."""
    params = init_model_shell(cfg, generator, device)
    params["blocks"] = _layer_tree(cfg, lambda kind: _init_block(cfg, kind, generator, device))
    return ParamTree(params)


# One ``torch.Generator`` feeds every draw, so unlike the JAX package's
# per-layer keys a slice cannot be drawn out of order: the group-wise init
# (streamed parameters, ``train/steps.py``) draws the shell first, then each
# layer group in layer order, and homes each group before drawing the next.

def init_model_shell(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The non-``blocks`` leaves of :func:`init_model`, drawn first in the
    JAX package's order: the embedding (a codebook model's codebooks and
    heads, else the token table), the untied head, the vision merger, then
    ``ln_f``.  Leaves ``generator`` where layer 0's draws begin."""
    check_supported(cfg)
    kw = dict(generator=generator, device=device)
    params: dict = {}
    if cfg.n_codebooks:
        params["embed"] = frontends.init_audio_embed(cfg, **kw)
    else:
        params["embed"] = layers.init_embed(cfg.vocab_size, cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            params["head"] = layers.init_head(cfg.d_model, cfg.vocab_size, **kw)
    if cfg.vision_embed:
        params["vision"] = frontends.init_vision_merger(cfg, **kw)
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
    if kind == "mlstm":
        return xlstm.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_state(cfg, batch, device)
    w = cfg.window if cfg.family == "hybrid" else cl
    return attention.init_cache(cfg, batch, min(w or cl, cl) or cl, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                device=None) -> dict:
    """Decode state for a context of ``seq_len`` tokens, in the layout of the
    parameters: ``{"k": (L, B, T, K, H), "v": ...}`` for a uniform stack;
    ``{"periods": {"pos_k": ...}, "tail_k": ...}`` or ``{"layer_000": ...}``
    for the hybrid and the xLSTM stack, whose attention layers hold
    ``min(window, T)``-slot rings and whose recurrent and xLSTM layers hold
    f32 states."""
    check_supported(cfg)
    cl = cfg.cache_len(seq_len)
    return _layer_tree(cfg, lambda kind: _init_layer_cache(cfg, kind, batch, cl, dtype, device))


def _at(tree, path: tuple, j: Optional[int]):
    """One layer's subtree: views along the stacked axis, so that writes
    land in the stacked tensors."""
    for key in path:
        tree = tree[key]
    return tree if j is None else _index(tree, j)


def _mesh(mesh, sharder, params):
    """The mesh the batch joins: the sharder's (or ``mesh``) when the
    parameters are DTensors; none when they are plain tensors (one rank
    without per-group shardings: the one-device program)."""
    if isinstance(params, ParamTree):  # the first leaf: the tree is one layout
        leaf = next(params.parameters(), None)
    else:
        leaf = params
        while isinstance(leaf, dict) and leaf:
            leaf = next(iter(leaf.values()))
    if not local.is_dtensor(leaf):
        return None
    return sharder.mesh if sharder is not None else mesh


def on_mesh(batch: dict, mesh) -> dict:
    """``batch`` with its plain tensors as DTensors replicated over ``mesh``
    (every rank holds the same global batch: the Sharder's ``acts`` then
    keeps each rank's rows); unchanged without a mesh."""
    if mesh is None:
        return batch
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    return {k: DTensor.from_local(v, mesh, rep, run_check=False)
            if isinstance(v, torch.Tensor) and not local.is_dtensor(v) else v
            for k, v in batch.items()}


def _acts(sharder, x):
    return x if sharder is None else sharder.acts(x)


def _like(x, t: torch.Tensor):
    """``t`` replicated on ``x``'s mesh when ``x`` is a DTensor."""
    if not local.is_dtensor(x) or local.is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def _zero_like(x, dtype=torch.float32):
    """A 0-d zero on ``x``'s device (replicated on its mesh)."""
    dev = x.to_local().device if local.is_dtensor(x) else x.device
    return _like(x, torch.zeros((), dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# embedding / positions / head
# ---------------------------------------------------------------------------

def batch_device(batch: dict) -> torch.device:
    """The device of a batch: its token ids (``tokens``, or a codebook
    model's ``codes``)."""
    return (batch["codes"] if "codes" in batch else batch["tokens"]).device


def _embed(cfg: ModelConfig, params: Params, batch: dict, pos=None) -> torch.Tensor:
    """The first hidden states: the token (or summed codebook) embeddings,
    behind the merged vision prefix when the batch carries one, plus the
    sinusoidal positions.  ``pos`` is a decode step's absolute position (a
    scalar, or a (B,) per-slot vector); a full sequence starts at 0."""
    dt = cfg.compute_dtype
    if cfg.n_codebooks:
        x = frontends.audio_embed_apply(params["embed"], batch["codes"], dt)
    else:
        x = layers.embed_apply(params["embed"], batch["tokens"], dt)
    if cfg.vision_embed and "vision_embeds" in batch:
        vis = frontends.vision_merge_apply(params["vision"], batch["vision_embeds"].to(dt))
        x = torch.cat([vis, x], dim=1)  # the vision prefix, then the text
    if cfg.pos_type == "sinusoidal":
        s = x.shape[1]
        steps = torch.arange(s, device=x.device)
        if pos is None:
            positions = steps
        else:
            p = torch.as_tensor(local.full_local(pos), device=x.device).to(torch.int32)
            positions = (p[:, None] if p.dim() == 1 else p) + steps - (s - 1)
        emb = rope.sinusoidal_embedding(positions, cfg.d_model)
        x = x + _like(x, (emb[None] if emb.dim() == 2 else emb).to(dt))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _angles(cfg: ModelConfig, batch: dict, seq_len: int, pos=None,
            device=None) -> Optional[torch.Tensor]:
    """Rotary angles for the whole sequence (prefill) or one step: RoPE from
    the positions, M-RoPE from ``batch["positions_3d"]`` (a decode batch
    carries the step's ids); ``None`` for other position schemes."""
    if cfg.pos_type == "mrope":
        return rope.mrope_angles(batch["positions_3d"], cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
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
    """Logits (B, S, V), or (B, K, S, V) from a codebook model's K heads."""
    x = layers.norm_apply(params["ln_f"], x, cfg.norm_type)
    if cfg.n_codebooks:
        logits = frontends.audio_heads_apply(params["embed"], x)
    elif cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(x.dtype).T
    else:
        logits = layers.head_apply(params["head"], x)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor, decode: bool,
         mesh=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's second half: the pre-norm MLP or MoE FFN plus residual.
    Returns ``(x, aux)``: a MoE layer's aux loss over a sequence (``decode``
    False: the dispatch, or with ``moe_impl="sorted_ep"`` and a ``mesh`` the
    expert-parallel :func:`~repro_torch.models.moe.moe_sorted_ep`, as the
    JAX package's ``_block_train``), else ``None``."""
    if "moe" in p:
        h = layers.norm_apply(p["ln2"], x, cfg.norm_type)
        if decode:
            return x + local.on_full(moe.moe_decode, cfg, p["moe"], h), None
        if cfg.moe_impl == "sorted_ep" and mesh is not None:
            y, aux = moe.moe_sorted_ep(cfg, p["moe"], h, mesh)
        else:
            y, aux = local.on_full(moe.moe_dispatch, cfg, p["moe"], h)
        return x + y, aux
    if "mlp" not in p:
        return x, None
    h = layers.norm_apply(p["ln2"], x, cfg.norm_type)
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type), None


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _store(cache: dict, state: dict) -> None:
    """Write a recurrent layer's new state into its cache views."""
    for k, v in state.items():
        cache[k].copy_(v)


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
           mix: Callable[[torch.Tensor], torch.Tensor],
           decode: bool = False, mesh=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer body every pass runs: the pre-norm token mixer ``mix``
    (attention or the recurrence, on the normed input) plus residual, then
    the pre-norm MLP or MoE FFN plus residual.  Returns ``(x, aux)`` as
    :func:`_mlp`."""
    return _mlp(cfg, p, x + mix(layers.norm_apply(p["ln1"], x, cfg.norm_type)), decode, mesh)


#: the xLSTM blocks' sequence and decode-step forms, by block kind
_XLSTM_TRAIN = {"mlstm": xlstm.mlstm_block_train, "slstm": xlstm.slstm_block_train}
_XLSTM_STEP = {"mlstm": xlstm.mlstm_block_step, "slstm": xlstm.slstm_block_step}


def _layer_train(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 angles: Optional[torch.Tensor], sharder=None, path: tuple = (),
                 mesh=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the training forward (the JAX package's ``_block_train``
    / ``_hetero_block_train``): no cache; the recurrence starts from zero
    and runs the plain scan, as the JAX package's ``use_kernel=False``.
    With a ``sharder`` the layer's parameters are gathered to their
    TP-only layout first and the output pinned to the activation layout
    (the JAX package's ``_block_train``).  ``mesh`` reaches :func:`_mlp`
    (given only for a uniform stack's layers, as the JAX package's
    ``_block_train`` gets it).  Returns ``(x, aux)`` as :func:`_mlp`."""
    if sharder is not None:
        p = sharder.block(p, path or None)
        x, aux = _layer_train(cfg, kind, p, x, angles, mesh=mesh)
        return sharder.acts(x), aux
    if kind == "rec":
        return _layer(cfg, p, x, lambda h: local.on_full(rglru.rglru_block_train, cfg, p["rec"],
                                                          h)[0])
    if kind in _XLSTM_TRAIN:
        return _layer(cfg, p, x, lambda h: local.on_full(_XLSTM_TRAIN[kind], cfg, p[kind], h)[0])
    return _layer(cfg, p, x, lambda h: attention.attention_train(cfg, p["attn"], h, angles),
                  mesh=mesh)


def _layer_prefill(cfg: ModelConfig, kind: str, p: Params, cache: dict, x: torch.Tensor,
                   angles: Optional[torch.Tensor], sharder=None, path: tuple = ()) -> torch.Tensor:
    """One layer's prefill: the body that :func:`prefill` and
    :func:`block_group_prefill` share.  Fills ``cache`` in place.  A
    ``sharder`` gathers the layer's parameters and pins its output, as in
    :func:`_layer_train`."""
    if sharder is not None:
        x = _layer_prefill(cfg, kind, sharder.block(p, path or None), cache, x, angles)
        return sharder.acts(x)
    def mix(h):
        if kind == "rec":
            h, state = local.on_full(rglru.rglru_block_train, cfg, p["rec"], h, cache,
                                     use_kernel=cfg.attn_impl == "pallas")
            _store(cache, state)
            return h
        if kind in _XLSTM_TRAIN:
            h, state = local.on_full(_XLSTM_TRAIN[kind], cfg, p[kind], h, cache)
            _store(cache, state)
            return h
        return attention.attention_prefill(cfg, p["attn"], h, angles, cache)[0]

    return _layer(cfg, p, x, mix)[0]


def _layer_decode(cfg: ModelConfig, kind: str, p: Params, cache: dict, x: torch.Tensor,
                  angles: Optional[torch.Tensor], pos, sharder=None,
                  path: tuple = ()) -> torch.Tensor:
    """One layer's decode step: the body that :func:`decode_step` and
    :func:`block_group_decode` share.  Updates ``cache`` in place.  A
    ``sharder`` gathers the layer's parameters and pins its output, as in
    :func:`_layer_train`."""
    if sharder is not None:
        x = _layer_decode(cfg, kind, sharder.block(p, path or None), cache, x, angles, pos)
        return sharder.acts(x)
    def mix(h):
        if kind == "rec":
            h, state = local.on_full(rglru.rglru_block_step, cfg, p["rec"], h, cache)
            _store(cache, state)
            return h
        if kind in _XLSTM_STEP:
            h, state = local.on_full(_XLSTM_STEP[kind], cfg, p[kind], h, cache)
            _store(cache, state)
            return h
        return attention.attention_decode(cfg, p["attn"], h, angles, cache, pos)[0]

    return _layer(cfg, p, x, mix, decode=True)[0]


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
                 angles: Optional[torch.Tensor], aux: torch.Tensor, sharder=None,
                 path: tuple = (), mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer of the training forward under the config's remat: the
    program :func:`forward_hidden` and the group stages share.  Returns
    ``(x, aux)`` with a MoE layer's aux loss added to the carried ``aux``.
    The Sharder's gather runs inside the remat, so the backward gathers the
    layer again (ZeRO-3)."""
    x, a = _remat(cfg, functools.partial(_layer_train, cfg, kind, sharder=sharder,
                                         path=path, mesh=mesh))(p, x, angles)
    return x, aux if a is None else aux + a


def _plain(params) -> dict:
    return params.as_dict() if isinstance(params, ParamTree) else params


def forward_hidden(cfg: ModelConfig, params: Params, batch: dict, mesh=None,
                   sharder=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Trunk only: pre-head hidden states (B, S, D) and the MoE aux loss (a
    0-d f32 sum over the layers, zero without MoE layers).  Each layer runs
    under :func:`_remat`.  Under a mesh (``mesh``, or the ``sharder``'s) the
    parameters are DTensors, the batch is taken as every rank's same global
    batch, and the ``sharder`` gathers each layer and pins the activations
    at the JAX package's points; without, this is the one-device program."""
    check_supported(cfg)
    params = _plain(params)
    x = _acts(sharder, _embed(cfg, params, on_mesh(batch, _mesh(mesh, sharder, params))))
    angles = _angles(cfg, batch, x.shape[1], device=x.device)
    aux = _zero_like(x)
    # the JAX package passes its mesh to the uniform stack's body only
    layer_mesh = mesh if cfg.uniform_blocks and cfg.use_scan else None
    stacked: dict = {}
    for kind, path, j in layer_slots(cfg):
        if j is None:
            p = _at(params["blocks"], path, None)
        else:
            if path not in stacked:
                stacked[path] = _unbind(_at(params["blocks"], path, None))
            p = stacked[path][j]
        x, aux = _train_layer(cfg, kind, p, x, angles, aux, sharder, path, layer_mesh)
    return x, aux


def forward_train(cfg: ModelConfig, params: Params, batch: dict, mesh=None,
                  sharder=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), or (B, K, S, V) with codebooks;
    moe_aux_loss).  A vision batch's S counts its prefix."""
    x, aux = forward_hidden(cfg, params, batch, mesh, sharder)
    return _head(cfg, _plain(params), x), aux


IGNORE_INDEX = -100


def cross_entropy_sum(logits: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum-form CE over non-ignored targets (for chunked accumulation):
    (f32 sum of the NLL, int32 count of valid targets).  The gold logit is a
    gather, the value of the JAX package's iota-compare masked sum."""
    lf = _full_last_dim(logits.to(torch.float32))
    valid = targets != IGNORE_INDEX
    tgt = torch.where(valid, targets, 0).to(torch.int64)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, tgt[..., None])[..., 0]
    return torch.sum((lse - gold) * valid), torch.sum(valid).to(torch.int32)


def _full_last_dim(x):
    """A DTensor sharded along its last dim (vocab-sharded logits) or
    pending a sum, gathered or reduced: the gold logit's gather has no
    sharding strategy over a sharded vocab, so the CE runs on full vocab
    rows."""
    if not local.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    last = x.dim() - 1
    pl = [Replicate() if p.is_partial() or getattr(p, "dim", None) in (last, -1) else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored targets.  Returns (loss, n_valid)."""
    total, n = cross_entropy_sum(logits, targets)
    n = torch.clamp(n, min=1)
    return total / n, n


def lm_loss(cfg: ModelConfig, params: Params, batch: dict, mesh=None,
            sharder=None) -> tuple[torch.Tensor, dict]:
    """``(loss, {"ce", "aux", "n_tokens"})`` of next-token prediction: the
    trunk, then :func:`head_stage_loss` on the whole tree."""
    params = _plain(params)
    x, aux = forward_hidden(cfg, params, batch, mesh, sharder)
    return head_stage_loss(cfg, params, x, aux, batch)


def prefill(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
            last_pos: Optional[int] = None, mesh=None, sharder=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the caches (in place).
    Returns (logits at one position, caches).

    ``last_pos``: position whose logits to return — the last *real* prompt
    token when the prompt is right-padded.  ``None`` takes the last
    position.  Recurrences run through the ``rglru_scan`` kernel under
    ``attn_impl="pallas"`` (the port's kernel path), else the plain scan.
    ``mesh`` and ``sharder`` as in :func:`forward_hidden`; the caches are
    then DTensors too."""
    check_supported(cfg)
    x = _acts(sharder, _embed(cfg, params, on_mesh(batch, _mesh(mesh, sharder, params))))
    angles = _angles(cfg, batch, x.shape[1], device=x.device)
    for kind, path, j in layer_slots(cfg):
        x = _layer_prefill(cfg, kind, _at(params["blocks"], path, j), _at(caches, path, j), x,
                           angles, sharder, path)
    return _head(cfg, params, _last(x, last_pos)), caches


def decode_step(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
                pos: Union[int, torch.Tensor], mesh=None, sharder=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  ``batch["tokens"]`` (a codebook model:
    ``batch["codes"]`` (B, K, 1)) holds the new token per slot, and an
    M-RoPE model's ``batch["positions_3d"]`` (B, 3, 1) its ids; ``pos`` is
    the absolute position being written (a scalar, or a (B,) vector of
    per-slot positions — the serving path on full-attention caches).  The
    caches are updated in place.  Returns (logits, caches).  ``mesh`` and
    ``sharder`` as in :func:`prefill`."""
    check_supported(cfg)
    x = _acts(sharder, _embed(cfg, params, on_mesh(batch, _mesh(mesh, sharder, params)), pos=pos))
    angles = _angles(cfg, batch, 1, pos=pos, device=x.device)
    for kind, path, j in layer_slots(cfg):
        x = _layer_decode(cfg, kind, _at(params["blocks"], path, j), _at(caches, path, j), x,
                          angles, pos, sharder, path)
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


def embed_stage(cfg: ModelConfig, group: Params, batch: dict, pos=None, mesh=None,
                sharder=None) -> torch.Tensor:
    """Embed-group forward: ``group`` holds the plan's embed leaves
    (``{"embed": ...}``, and a vision model's ``"vision"``); ``pos`` is a
    decode step's position.  Returns the first hidden states (pinned to the
    activation layout by a ``sharder``)."""
    return _acts(sharder, _embed(cfg, group, on_mesh(batch, _mesh(mesh, sharder, group)),
                                 pos=pos))


def stage_angles(cfg: ModelConfig, batch: dict, seq_len: int, pos=None) -> Optional[torch.Tensor]:
    """Rotary angles for the staged passes (``None`` without RoPE or
    M-RoPE)."""
    return _angles(cfg, batch, seq_len, pos=pos, device=batch_device(batch))


def block_group_prefill(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict,
                        x: torch.Tensor, angles: Optional[torch.Tensor],
                        sharder=None) -> tuple[torch.Tensor, dict]:
    """Prefill over one stacked layer-group slice ``(Lg, ...)`` of a uniform
    stack: fills ``cache_slice`` (``(Lg, ...)``, e.g. a view of the dense
    cache) in place.  Returns ``(x, cache_slice)``."""
    for j in range(_n_layers(blocks_slice)):
        x = _layer_prefill(cfg, "attn", _index(blocks_slice, j), _index(cache_slice, j), x, angles,
                           sharder)
    return x, cache_slice


def block_group_decode(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict,
                       x: torch.Tensor, angles: Optional[torch.Tensor], pos,
                       sharder=None) -> tuple[torch.Tensor, dict]:
    """One decode step over one stacked layer-group slice, the same layer
    body as :func:`decode_step`'s.  Updates ``cache_slice`` in place.
    Returns ``(x, cache_slice)``."""
    for j in range(_n_layers(blocks_slice)):
        x = _layer_decode(cfg, "attn", _index(blocks_slice, j), _index(cache_slice, j), x, angles,
                          pos, sharder)
    return x, cache_slice


def block_decode_pre_moe(cfg: ModelConfig, blocks_slice: Params, cache_slice: dict,
                         x: torch.Tensor, angles: Optional[torch.Tensor], pos):
    """The first half of ONE MoE layer's decode step, up to the routed FFN:
    attention plus residual, the pre-MoE norm and the router.
    ``blocks_slice`` is the layer's non-expert group (leading axis 1: the
    norms, the attention and ``moe.router``; no expert tensors), and
    ``cache_slice`` its cache layer, updated in place.  Returns ``(x_attn,
    h2, top_w, top_i)``: the caller fetches the routed experts and finishes
    with :func:`repro_torch.models.moe.decode_apply` (``x = x_attn + y``),
    the same operations :func:`block_group_decode` runs on the whole layer."""
    p = _index(blocks_slice, 0)
    cache = _index(cache_slice, 0)
    h = layers.norm_apply(p["ln1"], x, cfg.norm_type)
    x = x + attention.attention_decode(cfg, p["attn"], h, angles, cache, pos)[0]
    h2 = layers.norm_apply(p["ln2"], x, cfg.norm_type)
    top_w, top_i = moe.decode_route(cfg, p["moe"], h2)
    return x, h2, top_w, top_i


def head_stage_logits(cfg: ModelConfig, group: Params, x: torch.Tensor) -> torch.Tensor:
    """Head-group logits from trunk hidden states.  ``group`` holds ``ln_f``
    and the head weights (a tied head: the embed table, which the plan's
    head fetch group carries)."""
    return _head(cfg, group, x)


def head_stage_loss(cfg: ModelConfig, group: Params, x: torch.Tensor, aux: torch.Tensor,
                    batch: dict) -> tuple[torch.Tensor, dict]:
    """``(loss, {"ce", "aux", "n_tokens"})`` from the trunk's hidden states:
    ``ln_f``, the head (``group`` holds ``ln_f`` and the head weights, or the
    embed tree of a tied or codebook head) and the CE, with ``aux`` carried
    in from the layer stages.  A vision prefix carries no targets: they are
    padded with ``IGNORE_INDEX`` over it.  A codebook model's targets are
    (B, K, S) against its (B, K, S, V) logits.

    With ``cfg.loss_chunk`` dividing the sequence (and shorter than it) the
    CE runs chunk by chunk along the sequence, each chunk's head and CE
    under a checkpoint, so the (B, S, V) logits never exist whole: the JAX
    package's seq-chunked loss, its chunks summed in the same order.  On a
    DTensor stream the targets join the mesh as the global batch."""
    if local.is_dtensor(x):
        batch = on_mesh(batch, x.device_mesh)
    targets = batch["targets"]
    if cfg.vision_embed and "vision_embeds" in batch:
        s_img = batch["vision_embeds"].shape[1]
        pad = torch.full(targets.shape[:1] + (s_img,), IGNORE_INDEX, dtype=targets.dtype,
                         device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    s = targets.shape[-1]
    c = cfg.loss_chunk
    if not c or s <= c or s % c != 0:
        ce, n = cross_entropy(_head(cfg, group, x), targets)
        return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n}

    def chunk(xc, tc):
        return cross_entropy_sum(_head(cfg, group, xc), tc)

    tot = _zero_like(x)
    n = _zero_like(x, torch.int32)
    for i in range(s // c):
        nll, nv = ckpt.checkpoint(chunk, x[:, i * c:(i + 1) * c], targets[..., i * c:(i + 1) * c],
                                  use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        n = n + nv
    n = torch.clamp(n, min=1)
    ce = tot / n
    return ce + aux, {"ce": ce, "aux": aux, "n_tokens": n}


def block_group_train(cfg: ModelConfig, blocks_slice: Params, x: torch.Tensor, aux: torch.Tensor,
                      angles: Optional[torch.Tensor], mesh=None,
                      sharder=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over one stacked layer-group slice ``(Lg, ...)`` of a
    uniform stack: :func:`forward_hidden`'s layer program entered mid-stack.
    ``aux`` is the MoE aux-loss carry.  Returns ``(x, aux)``."""
    for p in _unbind(blocks_slice):
        x, aux = _train_layer(cfg, "attn", p, x, angles, aux, sharder, mesh=mesh)
    return x, aux


def hetero_group_train(cfg: ModelConfig, kinds, group: Params, x: torch.Tensor,
                       aux: torch.Tensor, angles: Optional[torch.Tensor], sharder=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over one named-block group (the unrolled layout, a
    period-scanned stack's tail): ``kinds`` is the ``(name, block kind)``
    sequence in layer order.  Returns ``(x, aux)``."""
    for name, kind in kinds:
        x, aux = _train_layer(cfg, kind, group[name], x, angles, aux, sharder, (name,))
    return x, aux


def period_group_train(cfg: ModelConfig, periods_slice: Params, x: torch.Tensor,
                       aux: torch.Tensor, angles: Optional[torch.Tensor], sharder=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over a slice of stacked period units
    (``{"pos_k": (U, ...)}``), each unit's positions in order.  Returns
    ``(x, aux)``."""
    period = cfg.scan_period
    cols = [_unbind(periods_slice[f"pos_{k}"]) for k in range(period)]
    for j in range(len(cols[0])):
        for k in range(period):
            x, aux = _train_layer(cfg, cfg.block_kind(k), cols[k][j], x, angles, aux, sharder,
                                  ("periods", f"pos_{k}"))
    return x, aux


def init_cache_group(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Stacked decode-cache slice for ``n_layers`` uniform attention layers
    (the per-group analogue of :func:`init_caches`)."""
    cl = cfg.cache_len(seq_len)
    return _stack([attention.init_cache(cfg, batch, cl, dtype, device) for _ in range(n_layers)])
