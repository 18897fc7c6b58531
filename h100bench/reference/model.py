"""The plain reference: a decoder of GQA attention with RoPE and a SwiGLU MLP
or a top-k routed mixture of SwiGLU experts (Mixtral), in float32, from
the published description.

It imports torch alone.  It is handed the benchmark's weights (bf16, as
served) a layer at a time by the caller, widens them to float32, and runs
the whole sequence of each request (its prompt and the tokens that were
served) through one layer at a time, queries in blocks, so that it fits
beside nothing else on the card.  TF32 is off.

``control=True`` runs a second stream beside the first with every layer
product (attention projections and experts) in float8 e4m3, activations
scaled per row and weights per output column: the step below bf16 that a
faster serving path would take.  The router, embedding and head stay in
float32.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

E4M3_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x`` (S, heads, H) at positions 0..S-1."""
    s, _, h = x.shape
    inv = 1.0 / theta ** (torch.arange(0, h, 2, dtype=torch.float32, device=x.device) / h)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : h // 2], x[..., h // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """One configuration's reference.  ``c`` is the configuration file's
    dict (published keys)."""

    def __init__(self, c: dict, q_block: int = 512):
        self.c = c
        self.D, self.N = c["hidden_size"], c["num_attention_heads"]
        self.K, self.H = c["num_key_value_heads"], c["head_dim"]
        self.E = c.get("num_local_experts", 0)
        self.top_k = c.get("num_experts_per_tok", 0)
        self.eps = c["rms_norm_eps"]
        self.theta = c["rope_theta"]
        self.window = c.get("sliding_window") or 0
        self.q_block = q_block

    # -- one layer ---------------------------------------------------------
    def _mm(self, a: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
        """``a @ w``; with ``low``, both in e4m3 (``w``'s scale per column)."""
        if low:
            return _q8(a, -1) @ _q8(w, -2)
        return a @ w

    def attention(self, x: torch.Tensor, w: dict, low: bool) -> torch.Tensor:
        s = x.shape[0]
        N, K, H = self.N, self.K, self.H
        g = N // K
        q = rope(self._mm(x, w["wq"], low).view(s, N, H), self.theta)
        k = rope(self._mm(x, w["wk"], low).view(s, K, H), self.theta)
        v = self._mm(x, w["wv"], low).view(s, K, H)
        q = q.view(s, K, g, H)
        out = torch.empty((s, K, g, H), dtype=torch.float32, device=x.device)
        kpos = torch.arange(s, device=x.device)
        for lo in range(0, s, self.q_block):
            hi = min(s, lo + self.q_block)
            sc = torch.einsum("qkgh,tkh->kgqt", q[lo:hi], k) / math.sqrt(H)
            qpos = torch.arange(lo, hi, device=x.device)[:, None]
            mask = kpos[None, :] <= qpos
            if self.window:
                mask &= kpos[None, :] > qpos - self.window
            sc = sc.masked_fill(~mask, float("-inf"))
            out[lo:hi] = torch.einsum("kgqt,tkh->qkgh", torch.softmax(sc, dim=-1), v)
        return self._mm(out.reshape(s, N * H), w["wo"], low)

    def ffn(self, x: torch.Tensor, w1, w3, w2, low: bool) -> torch.Tensor:
        return self._mm(torch.nn.functional.silu(self._mm(x, w1, low)) * self._mm(x, w3, low),
                        w2, low)

    def route(self, x: torch.Tensor, router: torch.Tensor):
        """Top-k of the softmax over the experts (lower index first on a
        tie), renormalised over the k: Mixtral's gate."""
        probs = torch.softmax(x @ router, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_i = vals[:, : self.top_k], idx[:, : self.top_k]
        return top_w / top_w.sum(-1, keepdim=True), top_i

    def moe(self, x: torch.Tensor, w: dict, low: bool) -> tuple:
        top_w, top_i = self.route(x, w["router"])
        y = torch.zeros_like(x)
        for e in range(self.E):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel():
                out = self.ffn(x[rows], w["w1"][e], w["w3"][e], w["w2"][e], low)
                y.index_add_(0, rows, out * top_w[rows, slot, None])
        return y, top_i

    def layer(self, x: torch.Tensor, w: dict, low: bool) -> tuple:
        """One block; returns ``(x, top_i)`` (``top_i`` None without experts)."""
        x = x + self.attention(rms_norm(x, w["attn_norm"], self.eps), w, low)
        h = rms_norm(x, w["ffn_norm"], self.eps)
        if self.E:
            y, top_i = self.moe(h, w, low)
            return x + y, top_i
        return x + self.ffn(h, w["w1"], w["w3"], w["w2"], low), None

    # -- whole sequences ---------------------------------------------------
    @torch.no_grad()
    def served_logits(self, seqs: list, shell: dict, layer: Callable[[int], dict],
                      n_layers: int, device, control: bool = False,
                      on_route: Optional[Callable] = None) -> list:
        """For each ``(prompt, served)`` pair, the float32 logits at the
        positions that produced the served tokens: ``(ref, ctrl)`` of shape
        (len(served), V) each, ``ctrl`` None without ``control``.

        ``shell()`` and ``layer(i)`` give the bf16 weights by published
        name; they are widened here.  ``on_route(seq, layer, top_i)`` sees
        the reference's routing of each sequence and layer."""
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            sh = {k: v.to(device=device, dtype=torch.float32) for k, v in shell.items()}
            ids = [torch.as_tensor(list(p) + list(t[:-1]), dtype=torch.long, device=device)
                   for p, t in seqs]
            xs = [sh["embed"][i] for i in ids]
            cs = [x.clone() for x in xs] if control else None
            for li in range(n_layers):
                w = {k: v.to(device=device, dtype=torch.float32) for k, v in layer(li).items()}
                for j in range(len(xs)):
                    xs[j], top_i = self.layer(xs[j], w, False)
                    if on_route is not None and top_i is not None:
                        on_route(j, li, top_i)
                    if control:
                        cs[j], _ = self.layer(cs[j], w, True)
                del w
            out = []
            for j, (p, t) in enumerate(seqs):
                pos = slice(len(p) - 1, len(p) - 1 + len(t))

                def head(x):
                    return rms_norm(x[pos], sh["final_norm"], self.eps) @ sh["lm_head"]

                out.append((head(xs[j]), head(cs[j]) if control else None))
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far below the reference's best logit each token's logit lies."""
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=ref_logits.device)
    return ref_logits.max(dim=-1).values - ref_logits.gather(1, t[:, None])[:, 0]
