"""Step builders for serving: prefill and decode, plus parameter and cache
setup.

Counterparts of the JAX package's ``make_prefill_step`` /
``make_decode_step`` (``repro/train/steps.py``).  PyTorch runs eagerly, so a
"step" is a plain closure; there is nothing to trace or compile.  The
training steps, the streamed-weight steps and the paged decode step follow
in later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvpager import assemble_view, paged_cache_supported  # noqa: F401 (re-exported)
from repro_torch.device import generator as make_generator
from repro_torch.models import transformer
from repro_torch.models.layers import ParamTree


def make_prefill_step(
    cfg: ModelConfig, batch_size: int, seq_len: int
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, batch, last_pos=None) -> (logits, caches)``.

    Caches for a context of ``seq_len`` are created inside the step (zeros,
    on the tokens' device) and filled in place by the prefill."""

    @torch.no_grad()
    def prefill_step(params: ParamTree, batch: dict, last_pos: Optional[int] = None):
        caches = transformer.init_caches(
            cfg, batch_size, seq_len, cfg.compute_dtype, batch["tokens"].device
        )
        return transformer.prefill(cfg, params, batch, caches, last_pos=last_pos)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, caches, batch, pos) -> (logits, caches)`` — one new token
    against populated caches, which are updated in place."""

    @torch.no_grad()
    def decode_step(params: ParamTree, caches: dict, batch: dict, pos):
        return transformer.decode_step(cfg, params, batch, caches, pos)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``(params, view, batch, pos) -> (logits, caches)`` over a paged KV
    cache (see :mod:`repro_torch.core.kvpager`).

    ``view`` is the pager's per-slot tuple of page trees; ``pos`` is the (B,)
    vector of per-slot context positions.  :func:`assemble_view` copies the
    pages into a fresh dense cache, then the step of :func:`make_decode_step`
    runs on it, so paged and unpaged decode run the same code on the same
    values.  The returned caches are that assembled view, updated in place.
    The assembly runs inside a ``record_function`` span, which a profiler
    reads."""
    decode_fn = make_decode_step(cfg)

    def paged_decode_step(params: ParamTree, view, batch: dict, pos):
        with record_function("assemble_view"):
            dense = assemble_view(view)
        return decode_fn(params, dense, batch, pos)

    return paged_decode_step


def init_params(cfg: ModelConfig, seed: int, device) -> ParamTree:
    """Serving parameters: f32 init from ``seed`` on ``device``, cast to the
    compute dtype (as the JAX package's ``init_train_state`` casts them)."""
    device = torch.device(device)
    params = transformer.init_model(cfg, make_generator(seed, device), device)
    return params.to(cfg.compute_dtype)


def abstract_caches(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Cache shapes and dtypes on the meta device — no allocation."""
    return transformer.init_caches(cfg, batch, seq_len, cfg.compute_dtype, "meta")


def clone_caches(caches: Mapping) -> dict:
    """A deep copy of a cache tree (the steps update caches in place)."""
    return {k: clone_caches(v) if isinstance(v, Mapping) else v.clone() for k, v in caches.items()}

