#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and the paper's offload path on one
NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository (it imports ``src/repro_torch``) on a
machine with a CUDA card and ``nvcc``.  Phases, each fatal on failure:

0. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the compiler's register/spill report;
1. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (the JAX package's ``_tol``: bf16 rtol = atol = 2e-2,
   f32 rtol 2e-4 / atol 2e-3); decode must give the same bits for three
   ``PrefetchSpec`` rings, ``streamed_matmul`` for six;
2. serve full-width smollm-360m (32 layers, random bf16 weights from seed 0)
   with ``attn_impl="pallas"`` through ``repro_torch.launch.serve.serve``:
   batch 4, prompt 512, gen 32, unpaged device-resident caches; the
   kernels' launch counts are zeroed just before and read just after;
3. check the output: shapes, token range, finite logits, and the kernel
   path's logits against the plain path's (``attn_impl="xla"``) on the same
   full-width model and prompt;
4. the paper's path, ``streamed_matmul``'s launch count zeroed just before
   and read just after: the quickstart's listings 1-4; the lung-NN Fig 4
   at the JAX package's full size (1.8M pixels, 100 hidden, batch 2, 120
   groups: 720 MB of f32 weights in pinned host memory) through the
   ``HostStreamExecutor`` in eager, on-demand and prefetch — carries and
   written-back groups bitwise equal across modes, one H2D request and the
   exact payload per group — and again with the weights at ``DiskHost``
   through ``stream_host(policy=DISK_PARAMS)``; the kernel sweep at 512³
   f32 and the host-stream distance sweep; ``streamed_matmul`` at full
   width (smollm-360m's MLP at the serving token count);
5. time each kernel, its plain version and one PyTorch library call for the
   same function (``scaled_dot_product_attention``, ``torch.matmul``:
   yardsticks the port never calls) with CUDA events, L2 flushed before
   every launch, beside the least time the card could take (bytes at 3.35
   TB/s, FLOPs at 989 TFLOP/s bf16 on the tensor cores).

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
F32_TOL = dict(rtol=2e-4, atol=2e-3)  # f32 tolerance of the same tests (_tol)
# the JAX package's streamed-matmul test shapes (tests/test_kernels.py)
MM_SHAPES = [(128, 256, 128), (64, 100, 200), (7, 384, 512), (1, 128, 128), (130, 130, 130)]
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


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, rtol=RTOL, atol=ATOL) -> float:
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
    log(f"  {name}: max |kernel - plain| = {err:.3e} (rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def mlp_shapes(cfg) -> list:
    """smollm-360m's MLP projections at the serving phase's token count:
    (M, K, N) of x (M, K) @ w (K, N)."""
    m = BATCH * PROMPT
    return [(m, cfg.d_model, cfg.d_ff), (m, cfg.d_ff, cfg.d_model)]


def mm_inputs(m, k, n, dtype, seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=g, device="cuda").to(dtype)
    return x, w


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
    errs.update(check_streamed_matmul(cfg))
    torch.cuda.synchronize()
    return errs


def check_streamed_matmul(cfg) -> dict:
    from repro_torch.core.refspec import AUTO, PrefetchSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.streamed_matmul import matmul_ref, ops, streamed_matmul

    lib = _build.load("streamed_matmul", ops._SIGNATURES)
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        if lib.repro_streamed_matmul_stage_bytes(code) != ops.stage_bytes(dt):
            raise SystemExit(f"streamed_matmul: the wrapper's ring stage for {dt} is "
                             f"{ops.stage_bytes(dt)} bytes, the kernel's "
                             f"{lib.repro_streamed_matmul_stage_bytes(code)}")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = dict(rtol=RTOL, atol=ATOL) if dt == torch.bfloat16 else F32_TOL
        for m, k, n in MM_SHAPES:
            x, w = mm_inputs(m, k, n, dt)
            check_close(f"streamed_matmul ({m},{k})@({k},{n}) {dt}", streamed_matmul(x, w),
                        matmul_ref(x, w), **tol)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((2, 3, 32, 96), generator=g, device="cuda")
    w = torch.randn((96, 64), generator=g, device="cuda")
    check_close("streamed_matmul batched (2,3,32,96)@(96,64) float32", streamed_matmul(x, w),
                matmul_ref(x.reshape(-1, 96), w).reshape(2, 3, 32, 64), rtol=1e-4, atol=1e-3)
    for i, (m, k, n) in enumerate(mlp_shapes(cfg)):
        x, w = mm_inputs(m, k, n, torch.bfloat16)
        err = check_close(f"streamed_matmul full width ({m},{k})@({k},{n}) bf16",
                          streamed_matmul(x, w), matmul_ref(x, w))
        errs[f"streamed_matmul_{i}"] = err
    specs = [PrefetchSpec(slots, 1, dist) for dist, slots in [(0, 1), (1, 2), (2, 3), (3, 4), (1, 4)]]
    specs.append(PrefetchSpec(5, 1, AUTO))
    for m, k, n, dt in [(64, 256, 192, torch.float32), (*mlp_shapes(cfg)[0], torch.bfloat16)]:
        x, w = mm_inputs(m, k, n, dt)
        outs = [streamed_matmul(x, w, spec=sp) for sp in specs]
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        log(f"  streamed_matmul ({m},{k})@({k},{n}) {dt} bitwise equal across "
            f"{[(sp.distance, sp.buffer_size) for sp in specs]} (distance, buffer_size): {same}")
        if not same:
            raise SystemExit("streamed_matmul: value depends on the PrefetchSpec")
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


def phase_paper(cfg) -> int:
    """The paper's offload path; returns ``streamed_matmul``'s launches."""
    import shutil

    from repro_torch.benchmarks import common as C
    from repro_torch.benchmarks import kernel_streaming, offload_modes, offload_modes_full
    from repro_torch.examples import quickstart
    from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul

    log("phase 4 the paper's offload path")
    streamed_matmul.launches = 0

    checks = quickstart.main()
    log(f"  quickstart listings: {checks}")
    if not all(checks.values()):
        raise SystemExit(f"quickstart listings failed: {checks}")

    # Fig 4 at the JAX package's full size
    n_px, n_groups, batch = offload_modes_full.N_PIXELS, offload_modes_full.N_GROUPS, offload_modes_full.BATCH
    gp = n_px // n_groups
    cfg4 = C.LungNNConfig(n_pixels=n_px, batch_images=batch)
    payload = (batch * gp + gp * cfg4.n_hidden) * 4  # x_g + w1_g in f32; dh passes through
    t0 = time.perf_counter()
    rows, outs = offload_modes.run(n_px, groups=n_groups, batch_images=batch, tag="fig4_full")
    for r in rows:
        log(f"  fig4 {r['mode']}: feed forward {r['feed_forward_s'] * 1e3:.3f} ms, combine gradients "
            f"{r['combine_grad_s'] * 1e3:.3f} ms, model update {r['model_update_s'] * 1e3:.4f} ms, "
            f"transfer_wait_s {r['transfer_wait_s']:.6f} (cg {r['cg_transfer_wait_s']:.6f}), "
            f"h2d_requests {r['h2d_requests']} (cg {r['cg_h2d_requests']}), bytes_h2d {r['bytes_h2d']} "
            f"(cg {r['cg_bytes_h2d']}), peak_inflight_bytes {r['peak_inflight_bytes']}")
        for key in ("h2d_requests", "cg_h2d_requests"):
            if r[key] != n_groups:
                raise SystemExit(f"fig4 {r['mode']}: {key} = {r[key]}, not one per group ({n_groups})")
        for key in ("bytes_h2d", "cg_bytes_h2d"):
            if r[key] != payload * n_groups:
                raise SystemExit(f"fig4 {r['mode']}: {key} = {r[key]}, not {payload} x {n_groups}")
    base = outs["prefetch"]
    for mode, o in outs.items():
        same = (torch.equal(o["ff"], base["ff"]) and torch.equal(o["cg"], base["cg"])
                and all(torch.equal(a, b) for a, b in zip(o["cg_groups"], base["cg_groups"])))
        if not same:
            raise SystemExit(f"fig4: mode {mode} differs from prefetch")
    log(f"  fig4 eager, on_demand, prefetch: carries and {n_groups} written-back groups bitwise equal")
    # against the plain (device-resident, one-product) computation
    params = C.init_lung_nn(cfg4)
    xs, ys = C.make_images(cfg4, batch)
    h = torch.sigmoid(xs @ params["w1"])
    dh = ((torch.sigmoid(h @ params["w2"]) - ys) @ params["w2"].T) * h * (1 - h)
    check_close("fig4 feed-forward carry vs x @ w1", base["ff"], xs @ params["w1"], **F32_TOL)
    check_close("fig4 gradient groups vs x.T @ dh", torch.cat(base["cg_groups"]).cuda(), xs.T @ dh,
                **F32_TOL)
    del params, xs, ys, h, dh
    log(f"  fig4 three modes done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    spill = ROOT / "build" / "spill-fig4"
    shutil.rmtree(spill, ignore_errors=True)
    try:
        disk = offload_modes_full.disk_run(cfg4, groups=n_groups, spill_dir=str(spill))
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    for tier, o in disk.items():
        st = o["stats"]
        log(f"  fig4 stream_host from {tier}: total {st.total_s * 1e3:.3f} ms, transfer_wait_s "
            f"{st.transfer_wait_s:.6f}, disk_wait_s {st.disk_wait_s:.6f}, h2d_requests "
            f"{st.h2d_requests}, disk_requests {st.disk_requests}, bytes_h2d {st.bytes_h2d}, "
            f"bytes_disk {st.bytes_disk}")
    pinned, dsk = disk["pinned_host"], disk["disk_host"]
    if dsk["stats"].disk_requests != n_groups or dsk["stats"].h2d_requests != n_groups:
        raise SystemExit(f"fig4 disk: {dsk['stats'].disk_requests} disk and {dsk['stats'].h2d_requests}"
                         f" H2D requests, not one each per group ({n_groups})")
    if not (torch.equal(dsk["blocks"], pinned["blocks"]) and torch.equal(dsk["carry"], pinned["carry"])):
        raise SystemExit("fig4: the DiskHost run differs from the PinnedHost run")
    if not torch.equal(pinned["carry"], base["ff"].cpu()):
        raise SystemExit("fig4: stream_host's feed forward differs from the executor's")
    log(f"  fig4 DiskHost == PinnedHost == executor feed forward, bitwise "
        f"({time.perf_counter() - t0:.1f} s)")

    ks = kernel_streaming.kernel_sweep()
    hs = kernel_streaming.host_stream_sweep()
    by = {r["distance"]: r for r in hs}
    if not (all(r["matches_oracle"] for r in ks) and all(r["matches_eager"] for r in hs)):
        raise SystemExit("kernel_streaming: a ring or a distance changed the value")
    if not by["auto"]["steady_wait_s"] < by[1]["steady_wait_s"]:
        raise SystemExit("kernel_streaming: distance='auto' did not beat distance=1")

    # full width: smollm-360m's MLP projections at the serving token count
    (m, d, f), _ = mlp_shapes(cfg)
    x, w_up = mm_inputs(m, d, f, torch.bfloat16, seed=5)
    w_down = mm_inputs(1, f, d, torch.bfloat16, seed=6)[1]
    up = streamed_matmul(x, w_up)
    y = streamed_matmul(up, w_down)
    check_close(f"full-width MLP ({m},{d})->({m},{f})->({m},{d}) bf16", y,
                matmul_ref(matmul_ref(x, w_up), w_down))
    torch.cuda.synchronize()
    launches = streamed_matmul.launches
    log(f"  streamed_matmul launches during the paper path: {launches}")
    if launches <= 0:
        raise SystemExit("streamed_matmul was not launched on the paper path")
    return launches


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
    from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul

    n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    grp = n // kh
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = []

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    log("phase 5 times (CUDA events, L2 flushed before each launch)")
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
    # the full-width MLP projections, bf16: tensor-core bound
    for i, (m, k, n) in enumerate(mlp_shapes(cfg)):
        x, w = mm_inputs(m, k, n, torch.bfloat16)
        b_ms, b_by = bound(2 * (m * k + k * n + m * n), 2 * m * k * n)
        rows.append(dict(
            name="streamed_matmul", route="cuda", source="src/repro_torch/csrc/streamed_matmul.cu",
            replaces="src/repro/kernels/streamed_matmul/kernel.py:38", shape=[m, k, n],
            launches=launches["streamed_matmul"], max_abs_err=errs[f"streamed_matmul_{i}"],
            ms=time_ms(lambda: streamed_matmul(x, w), flush),
            plain_ms=time_ms(lambda: matmul_ref(x, w), flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.matmul(x, w), flush),
        ))
    for r in rows:
        log(f"  {r['name']}{r.get('shape', '')}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
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
    launches["streamed_matmul"] = phase_paper(cfg)
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
