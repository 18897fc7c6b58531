"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

The JAX package's ``models/xlstm.py`` on tensors.

mLSTM, per head, with stabilized exponential gating:
    C_t = f'_t C_{t-1} + i'_t k_t v_t^T      (dk, dv) matrix memory
    n_t = f'_t n_{t-1} + i'_t k_t
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))
with the running stabilizer m_t = max(log f_t + m_{t-1}, log i_t),
i'_t = exp(log i_t - m_t), f'_t = exp(log f_t + m_{t-1} - m_t).

Training runs the chunkwise-parallel form (:func:`mlstm_chunkwise`: within
a chunk an attention-like quadratic, across chunks the carried state);
:func:`mlstm_sequential` is kept as the oracle; decode is the O(1)
:func:`mlstm_step`.  sLSTM is scalar memory with block-diagonal recurrent
mixing per head, a time loop over the sequence (the JAX package's
``lax.scan``), its four gates' products stacked into one a step (the input
products into one for the whole sequence).  Cell states are f32 whatever
the compute dtype.

Blocks: mLSTM = up-projection to (inner, gate) -> causal conv -> q/k/v
(block-diagonal per head, q and k at half width) -> cell -> per-head
groupnorm -> gate -> down-projection.  sLSTM = cell -> groupnorm -> gated
MLP (factor 4/3).  The block functions return new states; the model copies
them into its caches.

The stabilizer starts at ``-inf``, and masked chunk weights are ``-inf``:
every ``exp`` of them is 0 with a gradient of 0, and every ``maximum``
against them picks the finite side, so no ``inf - inf`` reaches a value or
a gradient.  Maxima use ``torch.amax`` / ``torch.maximum``, which share a
gradient among ties as ``jnp.max`` / ``jnp.maximum`` do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params
from repro_torch.models.rglru import _causal_conv

QK_FACTOR = 0.5  # the official xLSTM qk_dim_factor

f32 = torch.float32


def _dims(cfg: ModelConfig):
    di = int(cfg.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    dhin = di // nh
    dqk = int(dhin * QK_FACTOR)
    return di, nh, dhin, dqk


# ---------------------------------------------------------------------------
# init: the JAX package's leaves and distributions, drawn in the order of its
# per-block keys from one generator
# ---------------------------------------------------------------------------

def init_mlstm_block(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    d = cfg.d_model
    di, nh, dhin, dqk = _dims(cfg)
    kw = dict(generator=generator, device=device)
    p = {
        "w_up": layers.fan_in_init((d, 2 * di), d, **kw),
        "conv": layers.trunc_normal((cfg.conv_width, di), 0.02, **kw),
        "wq": layers.fan_in_init((nh, dhin, dqk), dhin, **kw),
        "wk": layers.fan_in_init((nh, dhin, dqk), dhin, **kw),
        "wv": layers.fan_in_init((nh, dhin, dhin), dhin, **kw),
        "w_if": layers.fan_in_init((di, 2 * nh), di, **kw),
        "b_i": torch.full((nh,), -10.0, device=device),  # a small initial input gate
        "b_f": torch.full((nh,), 3.0, device=device),  # forget-open init
        "gn_scale": torch.ones((nh, dhin), device=device),
    }
    p["w_down"] = layers.fan_in_init((nh, dhin, d), di, **kw)
    return p


def init_slstm_block(cfg: ModelConfig, *, generator: torch.Generator, device) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    kw = dict(generator=generator, device=device)
    p: dict = {"gn_scale": torch.ones((d,), device=device)}
    for g in ("z", "i", "f", "o"):
        p[f"w_{g}"] = layers.fan_in_init((d, d), d, **kw)
    for g in ("z", "i", "f", "o"):
        p[f"r_{g}"] = layers.fan_in_init((nh, dh, dh), dh, **kw) * 0.1
    p["b_z"] = torch.zeros((d,), device=device)
    p["b_i"] = torch.full((d,), -10.0, device=device)
    p["b_f"] = torch.full((d,), 3.0, device=device)
    p["b_o"] = torch.zeros((d,), device=device)
    p["mlp"] = layers.init_mlp(d, int(4 * d / 3), "swiglu", **kw)
    return p


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, nh, dhin, dqk = _dims(cfg)
    return {
        "C": torch.zeros((batch, nh, dqk, dhin), device=device),
        "n": torch.zeros((batch, nh, dqk), device=device),
        "m": torch.full((batch, nh), -torch.inf, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), device=device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), device=device),
        "c": torch.zeros((batch, d), device=device),
        "n": torch.zeros((batch, d), device=device),
        "m": torch.full((batch, d), -torch.inf, device=device),
    }


def _cell_state(state: Optional[dict], b: int, nh: int, dqk: int, dv: int, device):
    if state is not None:
        return state["C"], state["n"], state["m"]
    return (torch.zeros((b, nh, dqk, dv), device=device),
            torch.zeros((b, nh, dqk), device=device),
            torch.full((b, nh), -torch.inf, device=device))


# ---------------------------------------------------------------------------
# mLSTM cell: the sequential oracle
# ---------------------------------------------------------------------------

def mlstm_sequential(q, k, v, log_i, log_f, state: Optional[dict] = None):
    """The reference semantics, one step at a time.  q/k: (B, S, H, dqk),
    v: (B, S, H, dv), log_i/log_f: (B, S, H) f32.  Returns (h (B, S, H, dv),
    state')."""
    b, s, nh, dqk = q.shape
    C, n, m = _cell_state(state, b, nh, dqk, v.shape[-1], q.device)
    qf = q.to(f32) * (dqk ** -0.5)
    kf, vf = k.to(f32), v.to(f32)
    hs = []
    for t in range(s):
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * torch.einsum(
            "bhk,bhv->bhkv", kf[:, t], vf[:, t])
        n = fp[..., None] * n + ip[..., None] * kf[:, t]
        num = torch.einsum("bhk,bhkv->bhv", qf[:, t], C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qf[:, t], n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel (the training path)
# ---------------------------------------------------------------------------

def mlstm_chunkwise(q, k, v, log_i, log_f, state: Optional[dict] = None, chunk: int = 128):
    """The chunkwise-parallel evaluation: :func:`mlstm_sequential`'s
    semantics (up to float association) in O(S * chunk) time and O(S)
    memory, the state carried across chunks in f32."""
    b, s, nh, dqk = q.shape
    dv = v.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    C, n, m = _cell_state(state, b, nh, dqk, dv, q.device)

    def ch(x):  # (B, S, ...) -> (NC, B, L, ...)
        return x.reshape(b, nc, chunk, *x.shape[2:]).transpose(0, 1)

    qc = ch(q.to(f32) * (dqk ** -0.5))
    kc, vc = ch(k.to(f32)), ch(v.to(f32))
    lic, lfc = ch(log_i), ch(log_f)
    idx = torch.arange(chunk, device=q.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # causal within a chunk
    neg_inf = torch.tensor(-torch.inf, device=q.device)
    hs = []
    for c in range(nc):
        qq, kk, vv, li, lf = qc[c], kc[c], vc[c], lic[c], lfc[c]
        cum = torch.cumsum(lf, dim=1)  # (B, L, H): the decay from the chunk start, f_t included
        # intra-chunk log weights D[t, s] = cum[t] - cum[s] + li[s] (s <= t)
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(tri, dmat, neg_inf)  # (B, L, L, H)
        m_intra = torch.amax(dmat, dim=2)
        m_inter = cum + m[:, None, :]  # the carried state's contribution
        m_t = torch.maximum(m_inter, m_intra)
        scores = torch.einsum("blhk,bshk->blsh", qq, kk)
        sw = scores * torch.exp(dmat - m_t[:, :, None, :])
        num = torch.einsum("blsh,bshv->blhv", sw, vv)
        den = torch.sum(sw, dim=2)
        g = torch.exp(m_inter - m_t)
        num = num + g[..., None] * torch.einsum("blhk,bhkv->blhv", qq, C)
        den = den + g * torch.einsum("blhk,bhk->blh", qq, n)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])
        # the state at the chunk's end
        total = cum[:, -1]  # (B, H): the chunk's whole log decay
        ws = total[:, None, :] - cum + li  # each step's log weight into the state
        m_new = torch.maximum(total + m, torch.amax(ws, dim=1))
        scale_old = torch.exp(total + m - m_new)
        wsn = torch.exp(ws - m_new[:, None, :])
        C = scale_old[..., None, None] * C + torch.einsum("blh,blhk,blhv->bhkv", wsn, kk, vv)
        n = scale_old[..., None] * n + torch.einsum("blh,blhk->bhk", wsn, kk)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(b, s, nh, dv)
    return h.to(q.dtype), {"C": C, "n": n, "m": m}


def mlstm_step(q, k, v, log_i, log_f, state: dict):
    """The O(1) decode step.  q/k: (B, H, dqk), v: (B, H, dv), gates (B, H)."""
    C, n, m = state["C"], state["n"], state["m"]
    dqk = q.shape[-1]
    qf = q.to(f32) * (dqk ** -0.5)
    kf = k.to(f32)
    m_new = torch.maximum(log_f + m, log_i)
    fp = torch.exp(log_f + m - m_new)
    ip = torch.exp(log_i - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * torch.einsum("bhk,bhv->bhkv", kf,
                                                                     v.to(f32))
    n = fp[..., None] * n + ip[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qf, n)), torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_qkv_gates(cfg: ModelConfig, p: Params, u: torch.Tensor, uc: torch.Tensor):
    """u (before the conv), uc (after the conv and SiLU): (..., Di) ->
    q, k, v, log_i, log_f."""
    di, nh, dhin, dqk = _dims(cfg)
    lead = u.shape[:-1]
    uh = uc.reshape(*lead, nh, dhin)
    vh = u.reshape(*lead, nh, dhin)
    q = torch.einsum("...hi,hik->...hk", uh, p["wq"].to(u.dtype))
    k = torch.einsum("...hi,hik->...hk", uh, p["wk"].to(u.dtype))
    v = torch.einsum("...hi,hiv->...hv", vh, p["wv"].to(u.dtype))
    gates = torch.einsum("...i,ig->...g", uc.to(f32), p["w_if"].to(f32))
    gi, gf = torch.chunk(gates, 2, dim=-1)
    return q, k, v, gi + p["b_i"], F.logsigmoid(gf + p["b_f"])


def _groupnorm_heads(scale: torch.Tensor, h: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS groupnorm.  h: (..., H, dv)."""
    hf = h.to(f32)
    hf = hf * torch.rsqrt(torch.mean(hf * hf, dim=-1, keepdim=True) + eps)
    return (hf * scale).to(h.dtype)


def mlstm_block_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out, state')."""
    dt = x.dtype
    up = torch.einsum("bsd,du->bsu", x, p["w_up"].to(dt))
    u, z = torch.chunk(up, 2, dim=-1)
    prefix = state["conv"] if state is not None else None
    uc, conv_state = _causal_conv({"conv": p["conv"]}, u, prefix)
    uc = F.silu(uc)
    q, k, v, log_i, log_f = _mlstm_qkv_gates(cfg, p, u, uc)
    cell = None if state is None else {"C": state["C"], "n": state["n"], "m": state["m"]}
    h, new_cell = mlstm_chunkwise(q, k, v, log_i, log_f, cell,
                                  chunk=min(cfg.mlstm_chunk, x.shape[1]))
    h = _groupnorm_heads(p["gn_scale"], h)
    di, nh, dhin, _ = _dims(cfg)
    zh = F.silu(z).reshape(*z.shape[:-1], nh, dhin)
    out = torch.einsum("bshv,hvd->bsd", h * zh, p["w_down"].to(dt))
    return out, dict(new_cell, conv=conv_state.to(f32))


def mlstm_block_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: dict) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D), one decode step."""
    dt = x.dtype
    up = x[:, 0] @ p["w_up"].to(dt)
    u, z = torch.chunk(up, 2, dim=-1)
    hist = torch.cat([state["conv"].to(dt), u[:, None]], dim=1)
    uc = F.silu(torch.einsum("bcw,cw->bw", hist, p["conv"].to(dt)))
    q, k, v, log_i, log_f = _mlstm_qkv_gates(cfg, p, u, uc)
    h, new_cell = mlstm_step(q, k, v, log_i, log_f,
                             {"C": state["C"], "n": state["n"], "m": state["m"]})
    h = _groupnorm_heads(p["gn_scale"], h)
    di, nh, dhin, _ = _dims(cfg)
    zh = F.silu(z).reshape(-1, nh, dhin)
    out = torch.einsum("bhv,hvd->bd", h * zh, p["w_down"].to(dt))
    return out[:, None], dict(new_cell, conv=hist[:, 1:].to(f32))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def _slstm_f32(cfg: ModelConfig, p: Params) -> dict:
    """The four gates' weights in f32, stacked: a step runs one recurrent
    product for the four, and a sequence one input product, beside the JAX
    package's four of each a step (the same terms, summed in the same order).
    Cast once for a whole sequence: a cast inside the time loop would be
    kept for the backward at every step."""
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    w = torch.cat([p[f"w_{g}"].to(f32) for g in _GATES], dim=1)  # (D, 4D)
    r = torch.stack([p[f"r_{g}"].to(f32) for g in _GATES], dim=2)  # (H, dh, 4, dh)
    b = torch.stack([p[f"b_{g}"].to(f32) for g in _GATES])  # (4, D)
    return {"w": w, "r": r.reshape(nh, dh, 4 * dh), "b": b,
            "eps": torch.full((), 1e-6, device=w.device)}


def _slstm_cell_step(cfg: ModelConfig, w: dict, wx: torch.Tensor, st: dict) -> dict:
    """One sLSTM step.  ``w``: :func:`_slstm_f32`'s weights; ``wx``: the
    step's input product (B, 4, D) f32, one row a gate."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    rh = torch.einsum("bhi,hij->bhj", st["h"].reshape(-1, nh, dh), w["r"])
    pre = wx + rh.reshape(-1, nh, 4, dh).transpose(1, 2).reshape(-1, 4, d) + w["b"]
    z = torch.tanh(pre[:, 0])
    li = pre[:, 1]  # the log input gate (exponential gating)
    lf = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(lf + st["m"], li)
    fp = torch.exp(lf + st["m"] - m_new)
    ip = torch.exp(li - m_new)
    c = fp * st["c"] + ip * z
    n = fp * st["n"] + ip
    h = o * c / torch.maximum(n, w["eps"])
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_out(cfg: ModelConfig, p: Params, h: torch.Tensor, dtype) -> torch.Tensor:
    """The groupnorm and the gated MLP over the cell's outputs (..., D)."""
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    hn = _groupnorm_heads(p["gn_scale"].reshape(nh, dh), h.reshape(*h.shape[:-1], nh, dh))
    return layers.mlp_apply(p["mlp"], hn.reshape(h.shape).to(dtype), "swiglu")


def slstm_block_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out, cell state'): the cell walks the sequence one
    step at a time, as the JAX package's ``lax.scan``."""
    b = x.shape[0]
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    cell = {k: st[k] for k in ("h", "c", "n", "m")}
    w = _slstm_f32(cfg, p)
    wx = (x.to(f32) @ w["w"]).reshape(b, x.shape[1], 4, cfg.d_model)
    hs = []
    for t in range(x.shape[1]):
        cell = _slstm_cell_step(cfg, w, wx[:, t], cell)
        hs.append(cell["h"])
    return _slstm_out(cfg, p, torch.stack(hs, dim=1), x.dtype), cell


def slstm_block_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: dict) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D), one decode step."""
    w = _slstm_f32(cfg, p)
    wx = (x[:, 0].to(f32) @ w["w"]).reshape(-1, 4, cfg.d_model)
    cell = _slstm_cell_step(cfg, w, wx, {k: state[k] for k in ("h", "c", "n", "m")})
    return _slstm_out(cfg, p, cell["h"], x.dtype)[:, None], cell
