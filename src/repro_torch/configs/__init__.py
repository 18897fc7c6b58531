"""Architecture registry.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the full / reduced
``ModelConfig``.  The JAX package's dry-run helpers (``input_specs``,
``cell_is_runnable``) are not ported yet: they serve the dry-run tooling.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "get_config", "get_smoke_config"]

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
