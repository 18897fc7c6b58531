"""Shared neural blocks: norms, MLPs, embeddings.

``init_*`` return a dict of tensors (the JAX package's param pytree);
``*_apply`` are plain functions of tensors.  Compute dtype is the input's
(bf16 on the serving path); statistics are taken in f32 at the same points
as the JAX package, so the rounding points match.

:class:`ParamTree` holds such a dict as an ``nn.Module`` whose parameter
names follow the JAX tree (``embed.tok``, ``blocks.attn.wq``, ...).
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

Params = Mapping[str, Union[torch.Tensor, "Params"]]


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``.

    Indexable like the JAX package's param dicts (``p["attn"]["wq"]``,
    ``"mlp" in p``), so the apply functions take either this or a plain
    dict.  Parameters are frozen: the port serves, it does not train yet.
    """

    def __init__(self, tree: Mapping) -> None:
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def index(self, i: int) -> dict:
        """Views of entry ``i`` along every leaf's leading (layer) axis."""
        out: dict = {k: p[i] for k, p in self._parameters.items()}
        out.update({k: m.index(i) for k, m in self._modules.items()})
        return out


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def trunc_normal(shape, scale: float = 0.02, *, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def fan_in_init(shape, fan_in: Optional[int] = None, *, generator: torch.Generator,
                device: torch.device, dtype=torch.float32) -> torch.Tensor:
    fi = fan_in if fan_in is not None else shape[0]
    return trunc_normal(shape, fi ** -0.5, generator=generator, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(d: int, norm_type: str, device: torch.device) -> dict:
    if norm_type == "rmsnorm":
        return {"scale": torch.ones(d, device=device)}
    if norm_type == "layernorm":
        return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}
    if norm_type == "layernorm_nonparam":  # OLMo: non-parametric LN
        return {}
    raise ValueError(f"unknown norm_type {norm_type!r}")


def norm_apply(p: Params, x: torch.Tensor, norm_type: str, eps: float = 1e-6) -> torch.Tensor:
    """Norm with f32 *statistics* but elementwise math in ``x.dtype``, as
    the JAX package rounds it (``models/layers.py:norm_apply``)."""
    xf = x.float()
    if norm_type == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps).to(x.dtype)
        return y * p["scale"].to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) - mu * mu
    y = (x - mu.to(x.dtype)) * torch.rsqrt(torch.clamp(var, min=0.0) + eps).to(x.dtype)
    if norm_type == "layernorm":
        y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return y


def init_rms_head_norm(head_dim: int, device: torch.device) -> dict:
    """Per-head-dim RMSNorm for qk-norm (Qwen3)."""
    return {"scale": torch.ones(head_dim, device=device)}


def head_norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * p["scale"]).to(x.dtype)  # cast at the end, as in JAX


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

GATED = {"swiglu", "geglu"}


def init_mlp(d: int, f: int, mlp_type: str, *, generator: torch.Generator,
             device: torch.device) -> dict:
    kw = dict(generator=generator, device=device)
    p = {"wi": fan_in_init((d, f), d, **kw), "wo": fan_in_init((f, d), f, **kw)}
    if mlp_type in GATED:
        p["wg"] = fan_in_init((d, f), d, **kw)
    return p


def _act(h: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        return F.silu(h)
    if mlp_type in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if mlp_type == "relu2":  # Nemotron/Minitron squared ReLU
        r = F.relu(h)
        return r * r
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def mlp_apply(p: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = _act(x @ p["wi"].to(x.dtype), mlp_type)
    if mlp_type in GATED:
        h = h * (x @ p["wg"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / output head
# ---------------------------------------------------------------------------

def init_embed(vocab: int, d: int, *, generator: torch.Generator, device: torch.device) -> dict:
    return {"tok": trunc_normal((vocab, d), 0.02, generator=generator, device=device)}


def embed_apply(p: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p["tok"].to(compute_dtype)[tokens]


def init_head(d: int, vocab: int, *, generator: torch.Generator, device: torch.device) -> dict:
    return {"out": fan_in_init((d, vocab), d, generator=generator, device=device)}


def head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["out"].to(x.dtype)
