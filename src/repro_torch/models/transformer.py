"""Model assembly: the uniform decoder stack and the recurrentgemma hybrid,
for serving.

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
  ``prefill``      — full-sequence forward + populated caches.
  ``decode_step``  — one token against the caches (scalar or per-slot pos;
                     ring and recurrent caches take a scalar).

xLSTM stacks, MoE, audio codebooks, the vision prefix, M-RoPE and
sinusoidal positions are not ported yet (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

from typing import Iterator, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
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
    not).  ``device="meta"`` gives shapes only."""
    check_supported(cfg)
    kw = dict(generator=generator, device=device)
    params: dict = {"embed": layers.init_embed(cfg.vocab_size, cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["head"] = layers.init_head(cfg.d_model, cfg.vocab_size, **kw)
    params["ln_f"] = layers.init_norm(cfg.d_model, cfg.norm_type, device)
    params["blocks"] = _layer_tree(cfg, lambda kind: _init_block(cfg, kind, generator, device))
    return ParamTree(params)


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
    if j is None:
        return tree
    if isinstance(tree, ParamTree):
        return tree.index(j)
    return {k: v[j] for k, v in tree.items()}


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
        p = _at(params["blocks"], path, j)
        cache = _at(caches, path, j)
        h = layers.norm_apply(p["ln1"], x, cfg.norm_type)
        if kind == "rec":
            h, state = rglru.rglru_block_train(cfg, p["rec"], h, cache,
                                               use_kernel=cfg.attn_impl == "pallas")
            _store(cache, state)
        else:
            h, _ = attention.attention_prefill(cfg, p["attn"], h, angles, cache)
        x = _mlp(cfg, p, x + h)
    xl = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return _head(cfg, params, xl), caches


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
        p = _at(params["blocks"], path, j)
        cache = _at(caches, path, j)
        h = layers.norm_apply(p["ln1"], x, cfg.norm_type)
        if kind == "rec":
            h, state = rglru.rglru_block_step(cfg, p["rec"], h, cache)
            _store(cache, state)
        else:
            h, _ = attention.attention_decode(cfg, p["attn"], h, angles, cache, pos)
        x = _mlp(cfg, p, x + h)
    return _head(cfg, params, x), caches
