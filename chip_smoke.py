#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository (it imports ``src/repro_torch``) on a
machine with a CUDA card and ``nvcc``.  Phases, each fatal on failure:

0. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the compiler's register/spill report;
1. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (bf16 tolerance rtol = atol = 2e-2, the JAX
   package's ``_tol``); decode must give the same bits for three
   ``PrefetchSpec`` rings;
2. serve full-width smollm-360m (32 layers, random bf16 weights from seed 0)
   with ``attn_impl="pallas"`` through ``repro_torch.launch.serve.serve``:
   batch 4, prompt 512, gen 32, unpaged device-resident caches; the
   kernels' launch counts are zeroed just before and read just after;
3. check the output: shapes, token range, finite logits, and the kernel
   path's logits against the plain path's (``attn_impl="xla"``) on the same
   full-width model and prompt;
4. time each kernel, its plain version and one PyTorch library call for the
   same function (``scaled_dot_product_attention``, a yardstick the port
   never calls) with CUDA events, L2 flushed before every launch, beside
   the least time the card could take (bytes at 3.35 TB/s, FLOPs at 989
   TFLOP/s bf16).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense tensor cores
RTOL = ATOL = 2e-2  # bf16 tolerance of the JAX package's kernel tests
# kernel path vs plain path through 32 bf16 layers: the two round the
# attention probabilities at different points, and the difference grows
# with depth; bound relative to the largest logit
LOGIT_RTOL = 5e-2

BATCH, PROMPT, GEN, SEED = 4, 512, 32, 0


def log(msg: str) -> None:
    print(msg, flush=True)


def rand(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), rtol=RTOL, atol=ATOL)
    log(f"  {name}: max |kernel - plain| = {err:.3e} (rtol = atol = {RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"phase 0 build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def flash_inputs(b, s, t, n, kh, h, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return rand((b, s, n, h), g, 0.5), rand((b, t, kh, h), g, 0.5), rand((b, t, kh, h), g)


def decode_inputs(b, t, n, kh, h, lens, seed=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return rand((b, n, h), g, 0.5), rand((b, t, kh, h), g, 0.5), rand((b, t, kh, h), g), lengths


def phase_kernels(cfg) -> dict:
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    log("phase 1 kernels vs plain versions on the card")
    errs = {}
    # the serving path's shapes first, then edges of the wrappers' contract
    flash_cases = [
        (1, PROMPT, PROMPT, n, kh, h, 0, 0),
        (2, 100, 100, 4, 4, 64, 0, 0),
        (1, 256, 256, 4, 2, 64, 64, 0),
        (2, 64, 192, 4, 2, 64, 0, 128),
        (1, 128, 128, 4, 2, 128, 0, 0),
    ]
    for i, (b, s, t, nn, kk, hh, window, qo) in enumerate(flash_cases):
        q, k, v = flash_inputs(b, s, t, nn, kk, hh)
        out = flash_attention(q, k, v, window=window, q_offset=qo)
        ref = attention_ref(q, k, v, window=window, q_offset=qo)
        err = check_close(f"flash_attention B={b} S={s} T={t} N={nn} KH={kk} H={hh} "
                          f"window={window} q_offset={qo}", out, ref)
        if i == 0:
            errs["flash_attention"] = err
    t = PROMPT + GEN
    decode_cases = [
        (BATCH, t, n, kh, h, [t, 300, 77, 1]),
        (2, 1024, 8, 2, 64, [1, 777]),
        (1, 300, 4, 1, 128, [300]),
        (2, 256, 10, 5, 64, [0, 129]),
    ]
    for i, (b, tt, nn, kk, hh, lens) in enumerate(decode_cases):
        q, k, v, lengths = decode_inputs(b, tt, nn, kk, hh, lens)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        err = check_close(f"decode_attention B={b} T={tt} N={nn} KH={kk} H={hh} lengths={lens}",
                          out, ref)
        if i == 0:
            errs["decode_attention"] = err
            specs = [PrefetchSpec(1, 1, 0), PrefetchSpec(2, 1, 1), PrefetchSpec(4, 1, 3)]
            outs = [decode_attention(q, k, v, lengths, spec=sp) for sp in specs]
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            log(f"  decode_attention bitwise equal across {[(s.buffer_size, s.distance) for s in specs]}"
                f" (buffer_size, distance): {same}")
            if not same:
                raise SystemExit("decode_attention: value depends on the PrefetchSpec")
    torch.cuda.synchronize()
    return errs


def phase_serve(cfg) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve

    log(f"phase 2 serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"attn_impl={cfg.attn_impl}; batch {BATCH}, prompt {PROMPT}, gen {GEN}")
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    res = serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, kv_kind="device",
                kv_page_len=0, seed=SEED)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {res['prefill_s'] * 1e3:.3f} ms for {BATCH} requests "
        f"({res['prefill_s'] * 1e3 / BATCH:.3f} ms each), decode {res['decode_s'] * 1e3:.3f} ms "
        f"for {res['n_steps']} steps = {res['tokens_per_s']:.1f} tok/s, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  launches during serve: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the path was not launched: {launches}")
    return res, launches


def phase_check(cfg, res: dict) -> None:
    from repro_torch.train import steps as st

    log("phase 3 output checks")
    gen = res["generated"]
    if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"generated tokens malformed: shape {gen.shape}, "
                         f"range [{gen.min()}, {gen.max()}]")
    log(f"  generated {gen.shape} int32 in [0, {cfg.vocab_size}); first request {gen[0, :8].tolist()}...")
    # the kernel path against the plain path on the full-width model
    params = st.init_params(cfg, SEED, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(1, cfg.vocab_size, (1, PROMPT), generator=g, device="cuda")
    out = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        logits, caches = st.make_prefill_step(c, 1, PROMPT + 2)(params, {"tokens": tokens})
        nxt = logits[:, -1].argmax(-1)
        logits2, _ = st.make_decode_step(c)(params, caches, {"tokens": nxt[:, None]},
                                            torch.tensor([PROMPT], dtype=torch.int32, device="cuda"))
        out[impl] = (logits.float(), logits2.float())
    for i, step in enumerate(("prefill", "decode")):
        a, b = out["pallas"][i], out["xla"][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"{step} logits are not finite")
        rel = max_err(a, b) / b.abs().max().item()
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        log(f"  {step} logits, kernel path vs plain path: max |diff| / max |logit| = {rel:.3e} "
            f"(limit {LOGIT_RTOL}), same greedy token: {same}")
        if rel > LOGIT_RTOL:
            raise SystemExit(f"{step} logits of the kernel path disagree with the plain path")


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Mean time of one call, L2 flushed before each (CUDA events)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def phase_times(cfg, errs: dict, launches: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    grp = n // kh
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = []

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    log("phase 4 times (CUDA events, L2 flushed before each launch)")
    # prefill attention of one request
    q, k, v = flash_inputs(1, PROMPT, PROMPT, n, kh, h)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)))
    pairs = PROMPT * (PROMPT + 1) // 2
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), 4 * pairs * n * h)
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:32",
        launches=launches["flash_attention"], max_abs_err=errs["flash_attention"],
        ms=time_ms(lambda: flash_attention(q, k, v), flush),
        plain_ms=time_ms(lambda: attention_ref(q, k, v), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), flush),
    ))
    # one decode step of the batch against its caches
    t = PROMPT + GEN
    lens = [t, 300, 77, 1]
    q, k, v, lengths = decode_inputs(BATCH, t, n, kh, h, lens)
    qs = q[:, :, None, :]
    ks, vs = (x.repeat_interleave(grp, 2).transpose(1, 2) for x in (k, v))
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    valid = sum(lens)
    b_ms, b_by = bound(2 * 2 * q.numel() + 4 * BATCH + 2 * 2 * valid * kh * h, 4 * valid * n * h)
    rows.append(dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:36",
        launches=launches["decode_attention"], max_abs_err=errs["decode_attention"],
        ms=time_ms(lambda: decode_attention(q, k, v, lengths), flush),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, lengths), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), flush),
    ))
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off: the plain versions are f32-exact references
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="pallas")
    t0 = time.perf_counter()
    phase_build()
    errs = phase_kernels(cfg)
    res, launches = phase_serve(cfg)
    phase_check(cfg, res)
    rows = phase_times(cfg, errs, launches)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
