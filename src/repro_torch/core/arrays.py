"""Leaves as the port's core moves them: torch tensors and numpy arrays.

Host data may arrive as numpy arrays (what the JAX package's host tiers
hold, and what a spill chunk's memory-mapped views are) or as CPU tensors
(pinned or pageable).  numpy has no bfloat16 without ``ml_dtypes``, which
the card's machine does not have, so a bf16 host leaf is either a torch
tensor or a numpy array whose dtype is *named* ``bfloat16`` (ml_dtypes, as
the JAX package hands it out) or a ``uint16`` array that carries
``spill_dtype == "bfloat16"`` (the spill store's view).
"""
from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

__all__ = ["DTYPES", "dtype_of", "dtype_name", "canonical", "host_tensor", "nbytes"]

#: dtype names shared by numpy, JAX and the spill manifest
DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint64": torch.uint64,
    "uint32": torch.uint32,
    "uint16": torch.uint16,
    "uint8": torch.uint8,
    "bool": torch.bool,
    "complex128": torch.complex128,
    "complex64": torch.complex64,
}

#: the JAX package's canonical dtypes without x64: what a host leaf is
#: packed at (``jax.dtypes.canonicalize_dtype``)
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.complex128: torch.complex64,
}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def dtype_of(x: Any) -> torch.dtype:
    """The torch dtype of a tensor or numpy leaf."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    name = getattr(x, "spill_dtype", None) or np.asarray(x).dtype.name
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported leaf dtype {name!r}") from None


def canonical(dtype: torch.dtype) -> torch.dtype:
    return _CANONICAL.get(dtype, dtype)


def nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def host_tensor(x: Any) -> torch.Tensor:
    """A CPU tensor with the leaf's values, sharing its memory where it can
    (a numpy array is viewed, not copied).  Read-only arrays (memory-mapped
    chunks) are viewed too: the port only ever reads through the view."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    dtype = dtype_of(x)
    if dtype == torch.bfloat16:
        a = a.view(np.uint16)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
