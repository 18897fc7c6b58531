"""Roofline terms: the analytic model of a step and the HLO text parser.

The JAX package's ``roofline/analysis.py``, with the same arithmetic, so the
same config gives the same floats:

  * ``model_flops`` — the assignment's 6·N·D (train) / 2·N·D (forward),
  * ``analytic_hbm_bytes`` — a first-order per-device HBM traffic model,
  * ``residual_inner_scan_flops`` — the work inside time/chunk scans that a
    layer probe cannot unroll (sLSTM's time loop, mLSTM's chunks),
  * ``collective_bytes_from_hlo`` — per-device collective bytes by op class
    from an HLO text dump (text parsing; nothing here compiles),
  * ``RooflineResult.terms`` — compute, memory and collective times on an
    ``HwSpec`` (the port's default is :data:`~repro_torch.roofline.hw.H100`).

``cost_terms`` reads a lowered step's cost analysis
(:mod:`repro_torch.core.lowering`, which the dry-run drives).
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.roofline.hw import H100, HwSpec

__all__ = ["RooflineResult", "analytic_hbm_bytes", "collective_bytes_from_hlo", "cost_terms",
           "model_flops", "residual_inner_scan_flops", "roofline_report",
           "weighted_collective_bytes"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# bytes moved per device relative to the (sharded) output tensor size
_CLASS_WEIGHT = {
    "all-gather": 1.0,       # receives ~full output
    "all-reduce": 2.0,       # ring: reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def _shape_bytes(segment: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(segment):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> dict[str, int]:
    """Per-device collective bytes by op class (output-tensor sizes).

    ``-start`` ops are skipped (their ``-done`` twin carries the output);
    shapes in an SPMD module are shard shapes, so sums are per-device.
    """
    out: dict[str, int] = {op: 0 for op in _COLL_OPS}
    for line in hlo_text.splitlines():
        line = line.strip()
        if "=" not in line:
            continue
        for op in _COLL_OPS:
            token = f" {op}("
            done = f" {op}-done("
            start = f" {op}-start("
            if start in line:
                break  # counted at -done
            seg = None
            if done in line:
                seg = line.split(done)[0]
            elif token in line:
                seg = line.split(token)[0]
            if seg is not None:
                lhs = seg.split("=", 1)[1] if "=" in seg else seg
                out[op] += _shape_bytes(lhs)
                break
    return out


def weighted_collective_bytes(by_class: dict[str, int]) -> float:
    return sum(_CLASS_WEIGHT[k] * v for k, v in by_class.items())


def cost_terms(compiled) -> dict[str, float]:
    """flops / bytes-accessed per device from a compiled step's cost
    analysis (a :class:`repro_torch.core.lowering.Compiled`, or any object
    whose ``cost_analysis()`` gives such a dict, or a list of them)."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {
        "flops": float(ca.get("flops", 0.0)),
        "bytes": float(ca.get("bytes accessed", 0.0)),
    }


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    step_kind: str
    n_devices: int
    # per-device quantities
    hlo_flops: float
    hlo_bytes: float
    coll_bytes_by_class: dict[str, int]
    coll_bytes_weighted: float
    residual_flops: float = 0.0  # analytic inner-scan add-on
    model_flops_global: float = 0.0
    analytic_bytes: float = 0.0  # first-order HBM model (see analytic_hbm_bytes)

    def terms(self, hw: HwSpec = H100) -> dict[str, float]:
        t_c = (self.hlo_flops + self.residual_flops) / hw.peak_flops_bf16
        t_m_hlo = self.hlo_bytes / hw.hbm_bw
        t_m = (self.analytic_bytes or self.hlo_bytes) / hw.hbm_bw
        t_x = self.coll_bytes_weighted / hw.ici_bw
        dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])
        mf_dev = self.model_flops_global / max(self.n_devices, 1)
        return {
            "t_compute_s": t_c,
            "t_memory_hlo_s": t_m_hlo,
            "t_memory_s": t_m,
            "t_collective_s": t_x,
            "dominant": dom[0],
            "t_dominant_s": dom[1],
            "t_ideal_s": max(mf_dev / hw.peak_flops_bf16, 1e-30),
            "model_flops_ratio": mf_dev / max(self.hlo_flops + self.residual_flops, 1.0),
            "roofline_fraction": (mf_dev / hw.peak_flops_bf16) / max(dom[1], 1e-30),
        }


def analytic_hbm_bytes(
    cfg,
    step_kind: str,
    seq: int,
    batch: int,
    *,
    data: int = 16,
    model: int = 16,
    n_devices: int = 256,
    tp_degree: int | None = None,
    act_passes: float | None = None,
) -> float:
    """First-order per-device HBM traffic model.

    Terms (bf16 weights/activations, f32 optimizer/scores):
      weights     fwd(+remat+bwd for train) reads of the TP-local shard
      optimizer   master/m/v read+write + f32 grads (fully sharded)
      activations ~12 block tensors per pass, 1 pass fwd / 3 passes train
      scores      materialized (B,S,S) f32+bf16 per local head (XLA path)
      kv/state    decode-cache read + write

    The scores term counts the (B, S, S) tensors of the plain attention; a
    flash kernel never writes them, so a step through it can run faster
    than this model's memory time.
    """
    p_total, p_active = cfg.param_count()
    tp = tp_degree if tp_degree is not None else model
    dp = n_devices // max(tp, 1)
    b_loc = max(batch // dp, 1)
    d = cfg.d_model
    L = cfg.n_layers
    n_attn = sum(1 for i in range(L) if cfg.block_kind(i) == "attn")
    h_loc = max(cfg.n_heads // max(tp, 1), 1)
    tp_shards = max(tp, 1)
    if cfg.n_experts and step_kind != "train":
        tp_shards = min(n_devices, cfg.n_experts * max(tp, 1))  # serve expert FSDP

    w_local = 2.0 * p_total / tp_shards  # bf16 TP shard
    toks = b_loc * seq

    if step_kind == "train":
        passes = act_passes if act_passes is not None else (3.0 if cfg.remat == "full" else 2.0)
        weights = passes * w_local  # fwd (+ remat recompute) + bwd
        optim = (24.0 + 8.0) * p_total / n_devices  # f32 m/v/master rw + grads
        acts = L * 12.0 * toks * d * 2.0 * passes
        attn_ctx = min(seq, cfg.window or seq) if cfg.attn_type == "swa" else seq
        scores = n_attn * passes * h_loc * b_loc * seq * attn_ctx * 6.0
        return weights + optim + acts + scores
    if step_kind == "prefill":
        weights = w_local
        acts = L * 12.0 * toks * d * 2.0
        attn_ctx = (min(seq, cfg.window or seq)
                    if (cfg.attn_type == "swa" or cfg.family == "hybrid") else seq)
        scores = n_attn * h_loc * b_loc * seq * attn_ctx * 6.0
        kv_write = (2.0 * n_attn * b_loc * cfg.cache_len(seq) * cfg.n_kv_heads * cfg.head_dim
                    * 2.0 / max(model // 8, 1))
        return weights + acts + scores + kv_write
    # decode: weights + full cache read dominate
    weights = w_local
    cl = cfg.cache_len(seq)
    kv_heads_loc = max(cfg.n_kv_heads, 1)
    kv = 2.0 * n_attn * b_loc * cl * kv_heads_loc * cfg.head_dim * 2.0 / model
    acts = L * 12.0 * b_loc * d * 2.0
    return weights + kv + acts


def model_flops(cfg, step_kind: str, seq: int, batch: int) -> float:
    """Assignment formula: 6·N·D (train) / 2·N·D (forward-only serve steps);
    N = active params (MoE: routed active + shared), D = tokens."""
    _, n_active = cfg.param_count()
    if step_kind == "train":
        return 6.0 * n_active * batch * seq
    if step_kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch  # decode: one token per sequence


def residual_inner_scan_flops(cfg, step_kind: str, seq: int, batch: int, n_devices: int) -> float:
    """Per-device analytic FLOPs for work inside time/chunk scans that layer
    probes cannot unroll:
      * sLSTM recurrent matvecs (the whole time scan),
      * mLSTM intra-chunk cell beyond the first chunk (<5% of block FLOPs;
        projections are outside the scan and counted exactly)."""
    if cfg.family != "ssm" or step_kind == "decode":
        return 0.0
    total = 0.0
    n_slstm = sum(1 for i in range(cfg.n_layers) if cfg.block_kind(i) == "slstm")
    n_mlstm = cfg.n_layers - n_slstm
    nh = cfg.n_heads
    if n_slstm:
        dh = cfg.d_model // nh
        per_tok = 4 * nh * dh * dh * 2  # r_z/r_i/r_f/r_o matvecs
        total += n_slstm * batch * seq * per_tok
    if n_mlstm:
        di = int(cfg.proj_factor * cfg.d_model)
        dhin = di // nh
        dqk = dhin // 2
        c = min(cfg.mlstm_chunk, seq)
        n_chunks = max(seq // c, 1)
        per_chunk = nh * (2 * c * c * dqk + 2 * c * c * dhin)  # qk^T + D@v
        total += n_mlstm * batch * (n_chunks - 1) * per_chunk
    if step_kind == "train":
        total *= 3  # fwd + bwd (2x)
    return total / n_devices


def roofline_report(res: RooflineResult, hw: HwSpec = H100) -> str:
    t = res.terms(hw)
    lines = [
        f"{res.arch} x {res.shape} [{res.mesh}, {res.step_kind}, {res.n_devices} chips]",
        f"  compute    {t['t_compute_s']*1e3:10.3f} ms   ({(res.hlo_flops+res.residual_flops)/1e9:.1f} GFLOP/dev)",
        f"  memory     {t['t_memory_s']*1e3:10.3f} ms   (analytic {res.analytic_bytes/1e9:.2f} GB/dev;"
        f" HLO {res.hlo_bytes/1e9:.2f} GB/dev = {t['t_memory_hlo_s']*1e3:.1f} ms)",
        f"  collective {t['t_collective_s']*1e3:10.3f} ms   ({res.coll_bytes_weighted/1e9:.2f} GB/dev weighted)",
        f"  dominant: {t['dominant']}   MODEL/HLO flops ratio: {t['model_flops_ratio']:.3f}"
        f"   roofline fraction: {t['roofline_fraction']:.3f}",
    ]
    return "\n".join(lines)
