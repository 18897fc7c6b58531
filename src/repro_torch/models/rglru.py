"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence (per channel), as the JAX package's ``models/rglru.py``:
    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Over a whole sequence the linear recurrence runs either as a log-depth
doubling scan in plain PyTorch (:func:`rglru_scan`, the counterpart of the
JAX package's ``associative_scan``) or, with ``use_kernel``, through the
CUDA ``rglru_scan`` kernel (``repro_torch.kernels.rglru_scan``); decode is
the O(1) sequential update.

Block structure (Griffin): pre-norm -> {gate branch: linear+GeLU} x
{recurrent branch: linear -> causal conv(4) -> RG-LRU} -> out proj.  The
functions return new states, as the JAX package's do; the model copies them
into its caches.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import linear_recurrence
from repro_torch.models import layers
from repro_torch.models.layers import Params

C_RGLRU = 8.0


def init_rglru_block(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    kw = dict(generator=generator, device=device)
    # Lambda init so a = exp(-c*softplus(L)) is in ~(0.9, 0.999) (paper app. A)
    u = torch.empty(w, device=device).uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / C_RGLRU))  # softplus^-1(-log u / c)
    return {
        "w_in": layers.fan_in_init((d, w), d, **kw),
        "w_gate": layers.fan_in_init((d, w), d, **kw),
        "conv": layers.trunc_normal((cfg.conv_width, w), 0.02, **kw),
        "w_a": layers.fan_in_init((w, w), w, **kw),
        "b_a": torch.zeros(w, device=device),
        "w_x": layers.fan_in_init((w, w), w, **kw),
        "b_x": torch.zeros(w, device=device),
        "lambda": lam,
        "w_out": layers.fan_in_init((w, d), w, **kw),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Decode state in f32, whatever the caches' dtype (as the JAX package)."""
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), device=device),
    }


def _gates(p: Params, x: torch.Tensor):
    """x: (..., W) -> (a, b) of the affine recurrence h = a*h + b, in f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    lam = p["lambda"].float()
    log_a = -C_RGLRU * torch.logaddexp(lam, torch.zeros_like(lam)) * r  # jax.nn.softplus
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1-a^2 = -expm1(2 log a)
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * xf)
    return a, b


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over axis 1 (h_0 = 0) in log2(S) steps:
    after the step of offset ``d`` each ``(a, b)`` composes the last ``2d``
    steps, as the associative scan's combine ``(al*ar, ar*bl + br)``."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p: Params, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
               use_kernel: bool = False):
    """Scan over the sequence.  x: (B, S, W) -> (y, h_last).

    ``use_kernel`` runs the recurrence through ``linear_recurrence`` (the
    CUDA kernel on a card, its plain version on the CPU); otherwise through
    the doubling scan."""
    a, b = _gates(p, x)  # (B, S, W) f32
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b[:, 0] += a[:, 0] * h0.float()
    h = linear_recurrence(a.contiguous(), b.contiguous()) if use_kernel else _doubling_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: Params, x: torch.Tensor, h: torch.Tensor):
    """One decode step.  x: (B, W), h: (B, W) -> (y, h')."""
    a, b = _gates(p, x[:, None, :])
    hf = a[:, 0] * h.float() + b[:, 0]
    return hf.to(x.dtype), hf


def _causal_conv(p: Params, x: torch.Tensor, prefix: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width cw.  x: (B, S, W); prefix: (B, cw-1, W)."""
    cw = p["conv"].shape[0]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for j in range(cw):
        out = out + xp[:, j:j + x.shape[1]] * p["conv"][j].to(x.dtype)
    return out, xp[:, -(cw - 1):] if cw > 1 else prefix


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def rglru_block_train(
    cfg: ModelConfig, p: Params, x: torch.Tensor, state: Optional[Params] = None,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence application.  x: (B, S, D) -> (out, new_state);
    ``use_kernel`` as :func:`rglru_scan`."""
    dt = x.dtype
    gate = _gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"].to(dt)))
    u = torch.einsum("bsd,dw->bsw", x, p["w_in"].to(dt))
    prefix = state["conv"] if state is not None else None
    u, conv_state = _causal_conv(p, u, prefix)
    h0 = state["h"] if state is not None else None
    y, h_last = rglru_scan(p, u, h0, use_kernel)
    out = torch.einsum("bsw,wd->bsd", y * gate, p["w_out"].to(dt))
    return out, {"h": h_last, "conv": conv_state.float()}


def rglru_block_step(
    cfg: ModelConfig, p: Params, x: torch.Tensor, state: Params
) -> tuple[torch.Tensor, dict]:
    """One decode step.  x: (B, 1, D) -> (out (B,1,D), new_state)."""
    dt = x.dtype
    xs = x[:, 0]
    gate = _gelu(xs @ p["w_gate"].to(dt))
    u = xs @ p["w_in"].to(dt)
    # conv over the stored prefix + current input
    hist = torch.cat([state["conv"].to(dt), u[:, None]], dim=1)  # (B, cw, W)
    u_conv = torch.einsum("bcw,cw->bw", hist, p["conv"].to(dt))
    y, h = rglru_step(p, u_conv, state["h"])
    out = (y * gate) @ p["w_out"].to(dt)
    return out[:, None], {"h": h, "conv": hist[:, 1:].float()}
