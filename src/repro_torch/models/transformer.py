"""Model assembly: the uniform decoder stack, for serving.

Pre-norm residual blocks over stacked ``(L, ...)`` parameter leaves, as the
JAX package's scanned uniform path; its ``scan`` over layers becomes a
Python loop.  Parameters live in a :class:`~repro_torch.models.layers.ParamTree`
whose names follow the JAX tree (``embed.tok``, ``ln_f.scale``,
``blocks.attn.wq``, ...).

Modes:
  ``prefill``      — full-sequence forward + populated KV caches.
  ``decode_step``  — one token against the caches (scalar or per-slot pos).

Heterogeneous stacks (hybrid / ssm), MoE, audio codebooks, the vision prefix,
M-RoPE and sinusoidal positions are not ported yet (ROADMAP.md, queue 1
item 1 for the recurrentgemma hybrid, item 7 for the rest).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, rope
from repro_torch.models.layers import ParamTree, Params


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    todo = []
    if not (cfg.uniform_blocks and cfg.use_scan):
        todo.append(f"{cfg.family} (heterogeneous) block stacks")
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
            "(ROADMAP.md, queue 1 item 1: recurrentgemma, item 7: the other model families)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    kw = dict(generator=generator, device=device)
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
    params["blocks"] = _stack([_init_block(cfg, generator, device) for _ in range(cfg.n_layers)])
    return ParamTree(params)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                device=None) -> dict:
    """Stacked decode caches ``{"k": (L, B, T, K, H), "v": ...}`` for a
    context of ``seq_len`` tokens."""
    check_supported(cfg)
    cache = attention.init_cache(cfg, batch, cfg.cache_len(seq_len), dtype, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim()) for k, v in cache.items()}


def _layer_cache(caches: dict, i: int) -> dict:
    """Views of layer ``i``'s caches: writes land in the stacked tensors."""
    return {k: v[i] for k, v in caches.items()}


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

def prefill(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
            last_pos: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the caches (in place).
    Returns (logits at one position, caches).

    ``last_pos``: position whose logits to return — the last *real* prompt
    token when the prompt is right-padded.  ``None`` takes the last
    position."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        p = params["blocks"].index(i)
        h = layers.norm_apply(p["ln1"], x, cfg.norm_type)
        h, _ = attention.attention_prefill(cfg, p["attn"], h, angles, _layer_cache(caches, i))
        x = _mlp(cfg, p, x + h)
    xl = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return _head(cfg, params, xl), caches


def decode_step(cfg: ModelConfig, params: ParamTree, batch: dict, caches: dict,
                pos: Union[int, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """One decode step.  ``batch["tokens"]`` holds the new token per slot;
    ``pos`` is the absolute position being written (a scalar, or a (B,)
    vector of per-slot positions — the serving path).  The caches are
    updated in place.  Returns (logits, caches)."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, 1, pos=pos, device=x.device)
    for i in range(cfg.n_layers):
        p = params["blocks"].index(i)
        h = layers.norm_apply(p["ln1"], x, cfg.norm_type)
        h, _ = attention.attention_decode(cfg, p["attn"], h, angles, _layer_cache(caches, i), pos)
        x = _mlp(cfg, p, x + h)
    return _head(cfg, params, x), caches
