"""ModelConfig — the single source of truth a model is built from.

Every assigned architecture is a ``ModelConfig`` instance in its own file in
this package (exact hyperparameters from the assignment table), plus a
``smoke()`` reduced config of the same family for CPU tests.  A field-for-field
copy of the JAX package's config; only ``compute_dtype`` differs, returning a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


SHAPES = {
    # name: (seq_len, global_batch, step kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # ---- variant knobs -----------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu|geglu|gelu|relu2|none
    norm_type: str = "rmsnorm"  # rmsnorm|layernorm|layernorm_nonparam
    pos_type: str = "rope"  # rope|mrope|sinusoidal|none
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    attn_type: str = "full"  # full | swa (sliding window)
    window: int = 0
    attn_impl: str = "xla"  # xla | chunked (q-block scan) | pallas (flash kernel)
    attn_chunk_q: int = 512  # q-block size for attn_impl="chunked"
    scale_embeddings: bool = False  # gemma-style sqrt(d) embed scale
    logit_softcap: float = 0.0
    # ---- MoE ----------------------------------------------------------------
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048
    moe_impl: str = "dispatch"  # dispatch (GShard einsum) | sorted_ep (shard_map)
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # ---- hybrid (RecurrentGemma / Griffin) -----------------------------------
    block_pattern: tuple[str, ...] = ()  # cycled per layer: "rec" | "attn"
    lru_width: int = 0
    conv_width: int = 4
    # ---- ssm (xLSTM) ----------------------------------------------------------
    slstm_every: int = 0  # one sLSTM block every N (0 = pure mLSTM)
    proj_factor: float = 2.0
    mlstm_chunk: int = 128
    # ---- audio (MusicGen) ------------------------------------------------------
    n_codebooks: int = 0
    # ---- vlm (Qwen2-VL) ---------------------------------------------------------
    vision_embed: bool = False
    # ---- execution ---------------------------------------------------------------
    use_scan: bool = True
    remat: str = "full"  # none | full | dots
    loss_chunk: int = 512  # seq-chunked CE (0 = whole-sequence logits)
    # decode scan carries the stacked cache and updates layer i in place
    # (single aliased buffer) instead of passing caches as scan xs/ys
    # (3 live copies measured) — §Perf knob
    decode_cache_in_carry: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    max_seq: int = 8192
    fsdp: bool = False
    source: str = ""  # provenance note

    # ------------------------------------------------------------------ helpers
    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kind(self, i: int) -> str:
        """Temporal-mixing kind of layer i."""
        if self.family == "hybrid":
            return self.block_pattern[i % len(self.block_pattern)]
        if self.family == "ssm":
            if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                return "slstm"
            return "mlstm"
        return "attn"

    @property
    def uniform_blocks(self) -> bool:
        return self.family not in ("hybrid", "ssm")

    @property
    def scan_period(self) -> int:
        """Layers per scan step: 1 for uniform stacks; the block-pattern
        period for heterogeneous archs (hybrid/ssm), whose layers repeat
        with this period so a scan over period-groups is exact."""
        if self.family == "hybrid" and self.block_pattern:
            return len(self.block_pattern)
        if self.family == "ssm" and self.slstm_every:
            return self.slstm_every
        return 1

    @property
    def period_scan(self) -> bool:
        """True when the hetero stack is executed as a scan over stacked
        period-groups (plus an unrolled tail of n_layers % period)."""
        p = self.scan_period
        return (
            self.use_scan
            and not self.uniform_blocks
            and p > 1
            and self.n_layers // p >= 2
        )

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with O(1)/O(window) state (long_500k eligible)?"""
        if self.family in ("hybrid", "ssm"):
            return True
        return self.attn_type == "swa" and self.window > 0

    def cache_len(self, seq_len: int) -> int:
        """KV-cache slots needed to decode with a context of ``seq_len``."""
        if self.family == "ssm":
            return 0  # constant-size recurrent state only
        if self.attn_type == "swa" and self.window:
            return min(self.window, seq_len)
        return seq_len

    # ---------------------------------------------------------- param counting
    def _attn_params(self) -> int:
        d, n, k, h = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        p = d * n * h + 2 * d * k * h + n * h * d
        if self.qkv_bias:
            p += n * h + 2 * k * h
        if self.qk_norm:
            p += 2 * h
        return p

    def _mlp_params(self) -> int:
        if self.mlp_type == "none" or self.d_ff == 0:
            return 0
        gated = self.mlp_type in ("swiglu", "geglu")
        return self.d_model * self.d_ff * (3 if gated else 2)

    def _moe_params_per_layer(self) -> tuple[int, int]:
        """(total, active) routed-FFN params per MoE layer."""
        e, k = self.n_experts, self.moe_top_k
        per_exp = self._mlp_params()
        router = self.d_model * e
        return e * per_exp + router, k * per_exp + router

    def _xlstm_params_per_block(self, kind: str) -> int:
        d = self.d_model
        di = int(self.proj_factor * d)
        nh = self.n_heads
        if kind == "mlstm":
            up = d * 2 * di  # two branches (inner, gate)
            conv = self.conv_width * di
            qkv = 3 * di * (di // nh)  # block-diagonal per head: nh blocks of (di/nh, dh)
            gates = 3 * di  # i, f, o scalar-per-head projections from di
            down = di * d
            return up + conv + qkv + gates + down
        # slstm: 4 gates x (input proj + per-head recurrent) + post-MLP (pf 4/3)
        fi = int(4 * d / 3)
        return 4 * (d * d + d * (d // nh)) + d * fi * 2

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts (embeddings included once)."""
        d, v = self.d_model, self.vocab_size
        embed = v * d
        if self.n_codebooks:
            embed = self.n_codebooks * v * d
        head = 0 if self.tie_embeddings else d * v * (self.n_codebooks or 1)
        total = embed + head
        active = embed + head
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                t = self._attn_params()
                if self.n_experts:
                    moe_t, moe_a = self._moe_params_per_layer()
                    total += t + moe_t
                    active += t + moe_a
                else:
                    m = self._mlp_params()
                    total += t + m
                    active += t + m
            elif kind == "rec":
                w = self.lru_width
                t = 2 * d * w + self.conv_width * w + 2 * w + w + w * d + self._mlp_params()
                total += t
                active += t
            elif kind in ("mlstm", "slstm"):
                t = self._xlstm_params_per_block(kind)
                total += t
                active += t
        return total, active
