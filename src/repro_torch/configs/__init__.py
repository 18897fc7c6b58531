"""Architecture registry + dry-run input specs.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the full / reduced
``ModelConfig``; ``vision_prefix_len`` the vision prefix of a VLM sequence;
``input_specs(cfg, shape)`` returns meta-tensor stand-ins (shape and dtype,
no allocation) for every model input of that (arch x shape) cell, and
``cell_is_runnable`` says which cells run at all.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "cell_is_runnable", "get_config",
           "get_smoke_config", "input_specs", "step_inputs", "vision_prefix_len"]

_MODULES = {
    "olmo-1b": "olmo_1b",
    "internlm2-20b": "internlm2_20b",
    "smollm-360m": "smollm_360m",
    "minitron-4b": "minitron_4b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mixtral-8x7b": "mixtral_8x7b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def vision_prefix_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM cells dedicate 1/8 of the sequence to the (stub) vision prefix."""
    return seq_len // 8 if cfg.vision_embed else 0


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Batch stand-ins (meta tensors) for one (arch x shape) cell.

    ``train``/``prefill`` shapes describe the full sequence; ``decode``
    shapes describe ONE new token against a ``seq_len`` context (the KV
    cache / recurrent state comes from ``train.steps.abstract_caches``).
    """
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape!r}; have {list(SHAPES)}")
    return step_inputs(cfg, *SHAPES[shape])


def step_inputs(cfg: ModelConfig, seq: int, batch: int, step: str) -> dict:
    """:func:`input_specs` of any ``(seq_len, global_batch, step kind)``."""
    i32 = torch.int32
    f = cfg.compute_dtype

    if step in ("train", "prefill"):
        if cfg.n_codebooks:
            return {
                "codes": _spec((batch, cfg.n_codebooks, seq), i32),
                "targets": _spec((batch, cfg.n_codebooks, seq), i32),
            }
        specs = {}
        s_img = vision_prefix_len(cfg, seq)
        specs["tokens"] = _spec((batch, seq - s_img), i32)
        specs["targets"] = _spec((batch, seq - s_img), i32)
        if cfg.vision_embed:
            specs["vision_embeds"] = _spec((batch, s_img, cfg.d_model), f)
        if cfg.pos_type == "mrope":
            specs["positions_3d"] = _spec((batch, 3, seq), i32)
        return specs

    # decode: one new token
    if cfg.n_codebooks:
        return {"codes": _spec((batch, cfg.n_codebooks, 1), i32)}
    specs = {"tokens": _spec((batch, 1), i32)}
    if cfg.pos_type == "mrope":
        specs["positions_3d"] = _spec((batch, 3, 1), i32)
    return specs


def cell_is_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: 500k-token decode needs sub-quadratic "
            "attention (see DESIGN.md §5 skip list)"
        )
    return True, ""
