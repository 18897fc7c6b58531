"""Modality front ends: MusicGen's codebooks and Qwen2-VL's vision merger.

The JAX package's ``models/frontends.py``.  Both front ends are stubs of the
real encoders, with a faithful token interface:

MusicGen: K EnCodec codebooks (4 of 2048 at full size).  The input embedding
of a step is the sum of its K codebook embeddings; the output is K parallel
LM heads, (B, K, S, V) logits.

Qwen2-VL: vision tokens arrive as precomputed patch embeddings (B, S_img, D)
from the stub ViT; a linear merger projects them into the LM's embedding
space, and the model prepends them to the text.  Their M-RoPE position ids
arrive beside them (``batch["positions_3d"]``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params


# -- audio (MusicGen) --------------------------------------------------------

def init_audio_embed(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    """``codebooks`` (K, V, D) then ``heads`` (K, D, V), in that draw order."""
    kw = dict(generator=generator, device=device)
    return {
        "codebooks": layers.trunc_normal((cfg.n_codebooks, cfg.vocab_size, cfg.d_model), 0.02,
                                         **kw),
        "heads": layers.fan_in_init((cfg.n_codebooks, cfg.d_model, cfg.vocab_size), cfg.d_model,
                                    **kw),
    }


def audio_embed_apply(p: Params, codes: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """codes (B, K, S) int -> (B, S, D): the sum over codebooks of each
    codebook's gather."""
    emb = p["codebooks"].to(dtype)  # (K, V, D)
    per_cb = torch.stack([emb[k][codes[:, k]] for k in range(emb.shape[0])])  # (K, B, S, D)
    return per_cb.sum(dim=0)


def audio_heads_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, K, S, V)."""
    return torch.einsum("bsd,kdv->bksv", x, p["heads"].to(x.dtype))


# -- vision (Qwen2-VL) ---------------------------------------------------------

def init_vision_merger(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    return {"proj": layers.fan_in_init((cfg.d_model, cfg.d_model), cfg.d_model,
                                       generator=generator, device=device)}


def vision_merge_apply(p: Params, patch_embeds: torch.Tensor) -> torch.Tensor:
    """(B, S_img, D) stub-ViT outputs -> the LM's embedding space."""
    return torch.einsum("bsd,de->bse", patch_embeds, p["proj"].to(patch_embeds.dtype))
