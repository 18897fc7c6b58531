#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths and the paper's offload path on one
NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository (it imports ``src/repro_torch``) on a
machine with a CUDA card and ``nvcc``.  Phases, each fatal on failure:

0. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the compiler's register/spill report;
   the tensor-core libraries must hold their instructions in their SASS
   (``cuobjdump -sass``) and spill nothing: ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) in ``streamed_matmul`` and ``flash_attention``,
   ``HMMA`` (mma.sync) in ``decode_attention``;
1. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (the JAX package's ``_tol``: bf16 rtol = atol = 2e-2,
   f32 rtol 2e-4 / atol 2e-3; ``rglru_scan`` rtol = atol = 1e-5, its JAX
   test's); decode must give the same bits for three ``PrefetchSpec``
   rings, ``streamed_matmul`` for six (its f32 route at 512³, where K is
   split, at 130³ by cp.async and at 64 x 256 x 192; its tensor-core route
   at both of smollm-360m's MLP shapes), ``rglru_scan`` for three
   ``(chunk_t, block_w)`` tilings; flash also at head_dim 128 with 1 and 8
   query heads per KV head and a window; the attention kernels also at the
   hybrid's head_dim 256 with 10 query heads over 1 KV head, on scores
   peaked enough that a missing key block or a window off by one fails
   (decode there at atol 2e-3), decode also at every edge of its key
   split (lengths 0, 1, SPLIT_KV - 1, SPLIT_KV, SPLIT_KV + 1, T - 1, T),
   bitwise equal across four rings, row by row alone, paged and in caches
   cut to each length; the f32 route also at listing 4's shape, and it
   refuses a split plan that misses or repeats a k-tile;
2. serve full-width smollm-360m (32 layers, random bf16 weights from seed 0)
   with ``attn_impl="pallas"`` through ``repro_torch.launch.serve.serve``:
   batch 4, prompt 512, gen 32, unpaged device-resident caches; the
   kernels' launch counts are zeroed just before and read just after;
3. check the output: shapes, token range, finite logits, and the kernel
   path's logits against the plain path's (``attn_impl="xla"``) on the same
   full-width model and prompt;
2b. serve full-width recurrentgemma-2b (26 layers, random bf16 weights from
   seed 0) the same way in lock-step: batch 4, prompt 3072 (longer than its
   2048 window, so prefill places the ring and decode wraps it), gen 32;
   ``rglru_scan``, ``flash_attention`` and ``decode_attention`` must all
   have been launched;
3b. check its output as in phase 3, on one 3072-token prompt;
4. the paper's path, ``streamed_matmul``'s launch count zeroed just before
   and read just after: the quickstart's listings 1-4; the lung-NN Fig 4
   at the JAX package's full size (1.8M pixels, 100 hidden, batch 2, 120
   groups: 720 MB of f32 weights in pinned host memory) through the
   ``HostStreamExecutor`` in eager, on-demand and prefetch — carries and
   written-back groups bitwise equal across modes, one H2D request and the
   exact payload per group — and again with the weights at ``DiskHost``
   through ``stream_host(policy=DISK_PARAMS)``; the kernel sweep at 512³
   f32 and the host-stream distance sweep; ``streamed_matmul`` at full
   width (smollm-360m's MLP at the serving token count), which must take
   the tensor-core route (its own launch count): each product against its
   plain version on the same inputs, the chain against float64 as close as
   the plain chain;
5. time each kernel, its plain version and one PyTorch library call for the
   same function (``scaled_dot_product_attention``, ``torch.matmul``:
   yardsticks the port never calls; no single PyTorch call computes a
   linear recurrence) with CUDA events, L2 flushed before every launch, at
   both serving paths' shapes and ``streamed_matmul`` on both routes (the
   MLP in bf16, the sweep's 512³ in f32), beside the least time the card
   could take (bytes at 3.35 TB/s; FLOPs at 989 TFLOP/s bf16 on the tensor
   cores, or 67 TFLOP/s f32 on the CUDA cores); it also logs the host time
   of one call of each serving-path wrapper, ``streamed_matmul`` by ring
   depth on both routes, listing 4's product beside ``torch.matmul``, and
   phase 4's kernel sweep by ring.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense tensor cores
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
RTOL = ATOL = 2e-2  # bf16 tolerance of the JAX package's kernel tests
F32_TOL = dict(rtol=2e-4, atol=2e-3)  # f32 tolerance of the same tests (_tol)
LRU_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_rglru_kernel.py
DECODE_256_TOL = dict(rtol=2e-2, atol=2e-3)  # see check_attention_256
# the JAX package's streamed-matmul test shapes (tests/test_kernels.py)
MM_SHAPES = [(128, 256, 128), (64, 100, 200), (7, 384, 512), (1, 128, 128), (130, 130, 130)]
# the JAX package's kernel sweep (benchmarks/kernel_streaming.py): f32, the
# CUDA-core route; and quickstart listing 4's product with its ring
SWEEP_SHAPE = (512, 512, 512)
LISTING4_SHAPE, LISTING4_RING = (256, 512, 256), (2, 3)  # (M, K, N); (distance, slots)
# the rings phase 5 times the matmul by (distance, slots); the kernel sweep's four are
# (0, 1), (1, 2), (2, 3), (4, 5)
TIMED_RINGS = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)]
# kernel path vs plain path through 32 bf16 layers: the two round the
# attention probabilities at different points, and the difference grows
# with depth; bound relative to the largest logit
LOGIT_RTOL = 5e-2

BATCH, PROMPT, GEN, SEED = 4, 512, 32, 0
# the recurrentgemma-2b cell: a prompt longer than the 2048-token window
HYB_PROMPT = 3072
# the JAX package's rglru_scan test shapes (tests/test_rglru_kernel.py)
LRU_SHAPES = [(2, 128, 256), (1, 64, 128), (3, 100, 130), (2, 8, 512), (1, 256, 64)]
LRU_TILINGS = [(8, 128), (64, 128), (128, 256)]


def log(msg: str) -> None:
    print(msg, flush=True)


def rand(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, rtol=RTOL, atol=ATOL) -> float:
    o, r = out.float(), ref.float()
    err = max_err(o, r)
    # the largest |kernel - plain| as a share of what the tolerance allows there
    share = ((o - r).abs() / (atol + rtol * r.abs())).max().item() if o.numel() else 0.0
    ok = torch.allclose(o, r, rtol=rtol, atol=atol)
    log(f"  {name}: max |kernel - plain| = {err:.3e} (rtol {rtol}, atol {atol}; "
        f"{share:.3f} of the tolerance) {'ok' if ok else 'FAIL'}")
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


#: the libraries redesigned for Hopper's tensor cores and the instructions
#: their SASS must hold (wgmma and TMA loads; mma.sync); no kernel of theirs
#: may spill
TENSOR_CORE_LIBRARIES = {"streamed_matmul": ("HGMMA", "UTMALDG"),
                         "flash_attention": ("HGMMA", "UTMALDG"),
                         "decode_attention": ("HMMA",)}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"phase 0 build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        spilled = False
        for line in path.with_suffix(".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spilled |= bool(spill) and int(spill[1]) + int(spill[2]) > 0
        if name in TENSOR_CORE_LIBRARIES:
            counts = _build.sass_counts(name, TENSOR_CORE_LIBRARIES[name])
            log(f"  {name}: SASS holds {counts}")
            if min(counts.values()) == 0 or spilled:
                raise SystemExit(f"{name}: the tensor-core kernels must issue {list(counts)} "
                                 f"and spill nothing: {counts}, spilled {spilled}")


def flash_inputs(b, s, t, n, kh, h, seed=1, qk=0.5):
    """q and k ~ N(0, qk^2), so scores have std qk^2; v ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return rand((b, s, n, h), g, qk), rand((b, t, kh, h), g, qk), rand((b, t, kh, h), g)


def decode_inputs(b, t, n, kh, h, lens, seed=2, qk=0.5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return rand((b, n, h), g, qk), rand((b, t, kh, h), g, qk), rand((b, t, kh, h), g), lengths


def phase_kernels(cfg, hcfg) -> dict:
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
        (1, 300, 300, 8, 8, 128, 100, 0),
        (2, 300, 300, 8, 1, 128, 100, 20),
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
    errs.update(check_attention_256(hcfg))
    errs.update(check_rglru_scan(hcfg))
    errs.update(check_streamed_matmul(cfg))
    torch.cuda.synchronize()
    return errs


def check_smem_formulas() -> None:
    """The wrappers refuse a tile or ring that does not fit before any
    launch, by their own count of its bytes: it must be the kernels'."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as lru
    from repro_torch.kernels.streamed_matmul import ops as smm

    fl = _build.load("flash_attention", fa._SIGNATURES)
    dl = _build.load("decode_attention", da._SIGNATURES)
    ll = _build.load("rglru_scan", lru._SIGNATURES)
    sl = _build.load("streamed_matmul", smm._SIGNATURES)
    pairs = [(f"flash H={h}", fa.smem_bytes(h), fl.repro_flash_attention_smem_bytes(h))
             for h in fa.HEAD_DIMS]
    pairs += [(f"streamed_matmul tensor cores slots={n}", smm.ring_bytes(torch.bfloat16, n),
               sl.repro_streamed_matmul_tc_smem_bytes(n)) for n in range(1, smm.max_slots(torch.bfloat16) + 1)]
    pairs += [(f"streamed_matmul f32 slots={n}", smm.ring_bytes(torch.float32, n),
               sl.repro_streamed_matmul_f32_smem_bytes(n)) for n in range(1, smm.max_slots(torch.float32) + 1)]
    pairs += [(f"decode H={h} slots={n}", da.smem_bytes(h, n), dl.repro_decode_attention_smem_bytes(h, n))
              for h in da.HEAD_DIMS for n in (1, 2, 3)]
    pairs += [(f"rglru_scan rows={r} block_w={w}", lru.smem_bytes(r, w),
               ll.repro_rglru_scan_smem_bytes(r, w)) for r, w in ((8, 128), (56, 256), (113, 128))]
    pairs.append(("decode SPLIT_KV", da.SPLIT_KV, dl.repro_decode_attention_split_kv()))
    bad = [(name, a, b) for name, a, b in pairs if a != b]
    if bad:
        raise SystemExit(f"the wrappers' shared-memory counts or split differ from the kernels': {bad}")
    log(f"  shared-memory counts of the wrappers equal the kernels' ({len(pairs)} cases)")


def check_attention_256(hcfg) -> dict:
    """Both attention kernels at recurrentgemma-2b's head_dim 256, 10 query
    heads over 1 KV head: the serving shapes (flash over the whole prompt
    with the 2048 window; decode over full 2048-slot rings), then edges.

    Over ~2048 keys a softmax of scores with std 0.25 is nearly uniform and
    each output is a mean of ~2048 values (std ~0.02, the size of the bf16
    atol): a dropped key block or a window off by one would pass.  So q and
    k are drawn with scores of std 1, and decode, whose outputs are all
    averages there, is held at atol 2e-3, also at every edge of its key
    split.  ``fault_check.py`` plants such faults in a copy of the kernels
    and shows that these checks fail them.
    """
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref, ops
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    n, kh, h, win = hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim, hcfg.window
    check_smem_formulas()
    errs = {}
    for i, (b, s, t, window, qo) in enumerate([(BATCH, HYB_PROMPT, HYB_PROMPT, win, 0),
                                                (1, 300, 300, 64, 0), (2, 100, 164, 0, 64)]):
        q, k, v = flash_inputs(b, s, t, n, kh, h, qk=1.0)
        out = flash_attention(q, k, v, window=window, q_offset=qo)
        ref = attention_ref(q, k, v, window=window, q_offset=qo)
        err = check_close(f"flash_attention B={b} S={s} T={t} N={n} KH={kh} H={h} "
                          f"window={window} q_offset={qo}", out, ref)
        if i == 0:
            errs["flash_attention_256"] = err
        del q, k, v, out, ref
    split, edge_t = ops.SPLIT_KV, 7 * ops.SPLIT_KV + 37  # T a multiple of neither split nor stage
    edges = [0, 1, split - 1, split, split + 1, edge_t - 1, edge_t]
    for i, (b, t, lens) in enumerate([(BATCH, win, [win] * BATCH), (BATCH, win, [win, 1000, 1, 0]),
                                      (1, 300, [300]), (len(edges), edge_t, edges)]):
        q, k, v, lengths = decode_inputs(b, t, n, kh, h, lens, qk=1.0)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        err = check_close(f"decode_attention B={b} T={t} N={n} KH={kh} H={h} lengths={lens}", out, ref,
                          **DECODE_256_TOL)
        if i == 0:
            errs["decode_attention_256"] = err
    check_decode_bits(q, k, v, lengths, out)
    return errs


def check_decode_bits(q, k, v, lengths, out) -> None:
    """A row's decode depends on its q, valid prefix and length alone: the
    same bits for every ring, paged, and for each row alone in its cache,
    in the cache cut to its length, and in a longer one."""
    from repro_torch.core.refspec import AUTO, PrefetchSpec
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_paged

    specs = [PrefetchSpec(1, 1, 0), PrefetchSpec(2, 1, 1), PrefetchSpec(3, 1, 2), PrefetchSpec(3, distance=AUTO)]
    same = {"rings": all(torch.equal(decode_attention(q, k, v, lengths, spec=sp), out) for sp in specs),
            "paged": torch.equal(decode_attention_paged(q, k.tensor_split(9, 1), v.tensor_split(9, 1),
                                                        lengths), out)}
    longer = torch.zeros((1, 77) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device).normal_()
    alone = True
    for i, n in enumerate(lengths.tolist()):
        row, cut = slice(i, i + 1), max(n, 1)
        for kk, vv in ((k[row], v[row]), (k[row, :cut].contiguous(), v[row, :cut].contiguous()),
                       (torch.cat([k[row], longer], 1), torch.cat([v[row], longer], 1))):
            alone &= torch.equal(decode_attention(q[row], kk, vv, lengths[row]), out[row])
    same["alone, cut and longer"] = alone
    log(f"  decode_attention lengths={lengths.tolist()} bitwise equal: {same}")
    if not all(same.values()):
        raise SystemExit(f"decode_attention: a row's value depends on more than the row: {same}")


def lru_inputs(b, s, w, seed=7):
    """a in (0, 1) like the RG-LRU's decay, b arbitrary (the JAX test's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, w), generator=g, device="cuda") + 2.0)
    return a, torch.randn((b, s, w), generator=g, device="cuda") * 0.5


def check_rglru_scan(hcfg) -> dict:
    from repro_torch.kernels.rglru_scan import linear_recurrence, linear_recurrence_ref

    full = (BATCH, HYB_PROMPT, hcfg.lru_width)
    for b, s, w in LRU_SHAPES:
        a, bb = lru_inputs(b, s, w)
        check_close(f"rglru_scan ({b},{s},{w}) chunk_t=32 block_w=128",
                    linear_recurrence(a, bb, chunk_t=32, block_w=128), linear_recurrence_ref(a, bb),
                    **LRU_TOL)
    a, bb = lru_inputs(*full)
    err = check_close(f"rglru_scan {full} (the serving shape)", linear_recurrence(a, bb),
                      linear_recurrence_ref(a, bb), **LRU_TOL)
    for shape in ((2, 128, 256), full):
        a, bb = lru_inputs(*shape, seed=8)
        outs = [linear_recurrence(a, bb, chunk_t=ct, block_w=bw) for ct, bw in LRU_TILINGS]
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        log(f"  rglru_scan {shape} bitwise equal across {LRU_TILINGS} (chunk_t, block_w): {same}")
        if not same:
            raise SystemExit("rglru_scan: value depends on the tiling")
    ones = torch.ones((1, 16, 128), device="cuda")
    forget = torch.equal(linear_recurrence(torch.zeros_like(ones), ones), ones)
    integrate = torch.equal(linear_recurrence(ones, ones)[0, :, 0].cpu(), torch.arange(1.0, 17.0))
    log(f"  rglru_scan decay: a = 0 gives b: {forget}; a = 1 gives cumsum(b): {integrate}")
    if not (forget and integrate):
        raise SystemExit("rglru_scan: wrong decay semantics")
    return {"rglru_scan": err}


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
    # the f32 kernel takes the wrapper's split plan and refuses one that
    # misses a k-tile or repeats one, before it launches anything
    m, k, n = SWEEP_SHAPE
    x, w = mm_inputs(m, k, n, torch.float32)
    y, work = torch.empty((m, n), device="cuda"), torch.empty((8, m, n), device="cuda")
    plan = ops.split_plan(m, n, k)
    for splits, kps in [(plan.splits - 1, plan.tiles_per_split), (plan.splits + 1, plan.tiles_per_split),
                        (plan.splits, plan.tiles_per_split - 1)]:
        rc = lib.repro_streamed_matmul_f32(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(), m, n, k,
                                           splits, kps, 1, 1, 2, torch.cuda.current_stream().cuda_stream)
        if rc == 0:
            raise SystemExit(f"streamed_matmul: the f32 kernel took a plan of {splits} splits of {kps} "
                             f"k-tiles at {SWEEP_SHAPE}, which does not take each k-tile once")
    log(f"  streamed_matmul f32 refuses split plans that miss or repeat a k-tile; {SWEEP_SHAPE}: {plan}")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = dict(rtol=RTOL, atol=ATOL) if dt == torch.bfloat16 else F32_TOL
        for m, k, n in MM_SHAPES:
            x, w = mm_inputs(m, k, n, dt)
            check_close(f"streamed_matmul ({m},{k})@({k},{n}) {dt}", streamed_matmul(x, w),
                        matmul_ref(x, w), **tol)
    x, w = mm_inputs(*SWEEP_SHAPE, torch.float32)
    errs["streamed_matmul_f32"] = check_close(f"streamed_matmul {SWEEP_SHAPE} float32 (the sweep's)",
                                              streamed_matmul(x, w), matmul_ref(x, w), **F32_TOL)
    (m, k, n), (d, sl) = LISTING4_SHAPE, LISTING4_RING
    x, w = mm_inputs(m, k, n, torch.float32)
    check_close(f"streamed_matmul listing 4 ({m},{k})@({k},{n}) float32 ring {LISTING4_RING}",
                streamed_matmul(x, w, spec=PrefetchSpec(sl, 1, d)), matmul_ref(x, w), **F32_TOL)
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
    mlp = [(*shape, torch.bfloat16) for shape in mlp_shapes(cfg)]
    f32 = [(64, 256, 192), SWEEP_SHAPE, (130, 130, 130)]  # the last by cp.async
    for m, k, n, dt in [*((*shape, torch.float32) for shape in f32), *mlp]:
        x, w = mm_inputs(m, k, n, dt)
        route = ops.route(x, w)
        tc_before = streamed_matmul.launches_tc
        outs = [streamed_matmul(x, w, spec=sp) for sp in specs]
        tc = streamed_matmul.launches_tc - tc_before
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        splits = ops.split_plan(m, n, k).splits if dt == torch.float32 else 1
        log(f"  streamed_matmul ({m},{k})@({k},{n}) {dt} on {route}, {splits} split(s) of K "
            f"({tc} tensor-core launches) "
            f"bitwise equal across {[(sp.distance, sp.buffer_size) for sp in specs]} "
            f"(distance, buffer_size): {same}")
        if not same:
            raise SystemExit("streamed_matmul: value depends on the PrefetchSpec")
        if dt == torch.bfloat16 and tc != len(specs):
            raise SystemExit(f"streamed_matmul: the bf16 MLP shape took {tc} of {len(specs)} "
                             "launches on the tensor cores")
    return errs


def serving_kernels() -> dict:
    """The serving paths' kernel wrappers, by name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import linear_recurrence

    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rglru_scan": linear_recurrence}


def phase_serve(cfg, prompt: int, phase: str, expect: tuple) -> tuple[dict, dict]:
    """Serve ``cfg`` through the entry point; every serving kernel's count
    is zeroed just before and read just after, and each of ``expect``
    must have launched."""
    from repro_torch.launch.serve import serve

    log(f"phase {phase} serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, attn_impl={cfg.attn_impl}; batch {BATCH}, prompt {prompt}, gen {GEN}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    res = serve(cfg, batch=BATCH, prompt_len=prompt, gen=GEN, kv_kind="device",
                kv_page_len=0, seed=SEED)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {res['prefill_s'] * 1e3:.3f} ms for {BATCH} requests "
        f"({res['prefill_s'] * 1e3 / BATCH:.3f} ms each), decode {res['decode_s'] * 1e3:.3f} ms "
        f"for {res['n_steps']} steps = {res['tokens_per_s']:.1f} tok/s, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  launches during serve: {launches}")
    if min(launches[k] for k in expect) <= 0:
        raise SystemExit(f"a kernel of the path was not launched: {launches}")
    return res, launches


def phase_check(cfg, res: dict, prompt: int, phase: str) -> None:
    from repro_torch.launch.serve import step_pos
    from repro_torch.train import steps as st

    log(f"phase {phase} output checks ({cfg.name})")
    gen = res["generated"]
    if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"generated tokens malformed: shape {gen.shape}, "
                         f"range [{gen.min()}, {gen.max()}]")
    log(f"  generated {gen.shape} int32 in [0, {cfg.vocab_size}); first request {gen[0, :8].tolist()}...")
    # the kernel path against the plain path on the full-width model
    params = st.init_params(cfg, SEED, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=g, device="cuda")
    pos = step_pos(cfg, 1, prompt, "cuda")  # the serve loop's, on its schedule
    out = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        logits, caches = st.make_prefill_step(c, 1, prompt + 2)(params, {"tokens": tokens})
        nxt = logits[:, -1].argmax(-1)
        logits2, _ = st.make_decode_step(c)(params, caches, {"tokens": nxt[:, None]}, pos)
        out[impl] = (logits.float(), logits2.float())
        del caches
    del params
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


def phase_paper(cfg) -> tuple[dict, list]:
    """The paper's offload path; returns ``streamed_matmul``'s launches on
    each route and the kernel sweep's rows."""
    import shutil

    from repro_torch.benchmarks import common as C
    from repro_torch.benchmarks import kernel_streaming, offload_modes, offload_modes_full
    from repro_torch.examples import quickstart
    from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul

    log("phase 4 the paper's offload path")
    streamed_matmul.launches = streamed_matmul.launches_tc = 0

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

    # full width: smollm-360m's MLP projections at the serving token count,
    # on the tensor cores
    (m, d, f), _ = mlp_shapes(cfg)
    x, w_up = mm_inputs(m, d, f, torch.bfloat16, seed=5)
    w_down = mm_inputs(1, f, d, torch.bfloat16, seed=6)[1]
    tc_before = streamed_matmul.launches_tc
    up = streamed_matmul(x, w_up)
    y = streamed_matmul(up, w_down)
    tc = streamed_matmul.launches_tc - tc_before
    check_close(f"full-width MLP up ({m},{d})@({d},{f}) bf16", up, matmul_ref(x, w_up))
    check_close(f"full-width MLP down ({m},{f})@({f},{d}) bf16, on the kernel's up", y,
                matmul_ref(up, w_down))
    check_mlp_chain(x, w_up, w_down, y)
    torch.cuda.synchronize()
    launches = {"tensor_cores": streamed_matmul.launches_tc,
                "cuda_cores": streamed_matmul.launches - streamed_matmul.launches_tc}
    log(f"  streamed_matmul launches during the paper path: {launches} "
        f"(the full-width MLP's 2 calls on the tensor cores: {tc})")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a route of streamed_matmul was not launched on the paper path: {launches}")
    if tc != 2:
        raise SystemExit(f"the full-width bf16 MLP took {tc} of 2 calls on the tensor cores")
    return launches, ks


def check_mlp_chain(x, w_up, w_down, y, margin: float = 1.1) -> None:
    """The two-product chain against float64 (no intermediate rounding):
    the kernel's chain must be as close to it as the plain chain, within
    ``margin`` on the mean error.

    The chain is not held to the plain chain itself: the tensor cores sum
    in another order than f32 cuBLAS, so the bf16 intermediate rounds
    differently in a few elements in ten thousand, and an output near zero
    then moves by more than the bf16 tolerance of its own size, on both
    chains alike."""
    from repro_torch.kernels.streamed_matmul import matmul_ref

    exact = (x.double() @ w_up.double()) @ w_down.double()
    plain = matmul_ref(matmul_ref(x, w_up), w_down)
    err_k, err_p = ((a.double() - exact).abs() for a in (y, plain))
    log(f"  full-width MLP chain vs float64: kernel mean |err| {err_k.mean().item():.4e} (max "
        f"{err_k.max().item():.4e}), plain mean {err_p.mean().item():.4e} (max {err_p.max().item():.4e})")
    if err_k.mean().item() > margin * err_p.mean().item():
        raise SystemExit("full-width MLP: the kernel's chain is farther from float64 than the plain chain")


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


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the peak rate for their type, in ms, and which."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def flash_row(cell, b, s, n, kh, h, window, launches, err, flush) -> dict:
    """Prefill attention of ``b`` prompts of ``s`` tokens."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    grp = n // kh
    q, k, v = flash_inputs(b, s, s, n, kh, h)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)))
    pos = torch.arange(s, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    pairs = int(mask.sum())  # (query, key) pairs the causal band holds
    flop = 4 * b * pairs * n * h
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), flop)
    if window:
        library = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    else:
        library = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:32", cell=cell,
        shape=[b, s, n, kh, h, window], launches=launches, max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, window=window), flush),
        plain_ms=time_ms(lambda: attention_ref(q, k, v, window=window), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, flush), flop=flop,
    )


def decode_row(cell, t, n, kh, h, lens, launches, err, flush) -> dict:
    """One decode step of the batch against its caches.  ``launches``
    counts both kernels of a call (the split kernel and the combine)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    grp = n // kh
    q, k, v, lengths = decode_inputs(len(lens), t, n, kh, h, lens)
    qs = q[:, :, None, :]
    ks, vs = (x.repeat_interleave(grp, 2).transpose(1, 2) for x in (k, v))
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    valid = sum(lens)
    b_ms, b_by = bound(2 * 2 * q.numel() + 4 * len(lens) + 2 * 2 * valid * kh * h, 4 * valid * n * h)
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:36", cell=cell,
        shape=[len(lens), t, n, kh, h], launches=launches, max_abs_err=err,
        ms=time_ms(lambda: decode_attention(q, k, v, lengths), flush),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, lengths), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), flush),
    )


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call that only enqueues work (no synchronise), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def host_cost(cfg) -> None:
    """What a launch costs the host, at the serving shapes: the tensor-core
    wrappers encode their TMA tensor maps on every call (flash three,
    streamed_matmul two); decode encodes none (log only)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.streamed_matmul import streamed_matmul

    q, k, v = flash_inputs(1, PROMPT, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    dq, dk, dv, lengths = decode_inputs(BATCH, PROMPT + GEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                        [PROMPT + GEN] * BATCH)
    x, w = mm_inputs(*mlp_shapes(cfg)[0], torch.bfloat16)
    costs = {"flash_attention": host_us(lambda: flash_attention(q, k, v)),
             "decode_attention": host_us(lambda: decode_attention(dq, dk, dv, lengths)),
             "streamed_matmul": host_us(lambda: streamed_matmul(x, w))}
    log("  host time per call (enqueue only, us): " + ", ".join(f"{n} {c:.1f}" for n, c in costs.items()))


def phase_times(cfg, hcfg, errs: dict, launches: dict, hlaunches: dict, sweep: list) -> list:
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.kernels.rglru_scan import linear_recurrence, linear_recurrence_ref
    from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    smol, hyb = cfg.name, hcfg.name
    log("phase 5 times (CUDA events, L2 flushed before each launch)")
    rows = [
        # prefill attention of one request / of the lock-step batch
        flash_row(smol, 1, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0,
                  launches["flash_attention"], errs["flash_attention"], flush),
        flash_row(hyb, BATCH, HYB_PROMPT, hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim, hcfg.window,
                  hlaunches["flash_attention"], errs["flash_attention_256"], flush),
        # one decode step: per-slot lengths; the hybrid's full 2048-slot rings
        decode_row(smol, PROMPT + GEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   [PROMPT + GEN, 300, 77, 1], launches["decode_attention"], errs["decode_attention"],
                   flush),
        decode_row(hyb, hcfg.window, hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim,
                   [hcfg.window] * BATCH, hlaunches["decode_attention"], errs["decode_attention_256"],
                   flush),
    ]
    # the recurrence of one rec layer's prefill: read a and b, write h, f32
    shape = (BATCH, HYB_PROMPT, hcfg.lru_width)
    a, b = lru_inputs(*shape)
    b_ms, b_by = bound(3 * 4 * a.numel(), 2 * a.numel(), F32_FLOP_PER_S)
    rows.append(dict(
        name="rglru_scan", route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:30", cell=hyb, shape=list(shape),
        launches=hlaunches["rglru_scan"], max_abs_err=errs["rglru_scan"],
        ms=time_ms(lambda: linear_recurrence(a, b), flush),
        plain_ms=time_ms(lambda: linear_recurrence_ref(a, b), flush, reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del a, b
    # the full-width MLP projections, bf16: tensor-core bound
    for i, (m, k, n) in enumerate(mlp_shapes(cfg)):
        x, w = mm_inputs(m, k, n, torch.bfloat16)
        flop = 2 * m * k * n
        b_ms, b_by = bound(2 * (m * k + k * n + m * n), flop)
        rows.append(dict(
            name="streamed_matmul", route="cuda", source="src/repro_torch/csrc/streamed_matmul.cu",
            replaces="src/repro/kernels/streamed_matmul/kernel.py:38", cell="lung-NN Fig 4",
            shape=[m, k, n], launches=launches["streamed_matmul"]["tensor_cores"],
            max_abs_err=errs[f"streamed_matmul_{i}"],
            ms=time_ms(lambda: streamed_matmul(x, w), flush),
            plain_ms=time_ms(lambda: matmul_ref(x, w), flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.matmul(x, w), flush), flop=flop,
        ))
    # the sweep's f32 product on the CUDA cores; torch.matmul with TF32 off
    # (resolve_device), as the route's f32 tolerance needs
    m, k, n = SWEEP_SHAPE
    x, w = mm_inputs(m, k, n, torch.float32)
    flop = 2 * m * k * n
    b_ms, b_by = bound(4 * (m * k + k * n + m * n), flop, F32_FLOP_PER_S)
    rows.append(dict(
        name="streamed_matmul", route="cuda", source="src/repro_torch/csrc/streamed_matmul.cu",
        replaces="src/repro/kernels/streamed_matmul/kernel.py:38", cell="lung-NN Fig 4",
        shape=[m, k, n], launches=launches["streamed_matmul"]["cuda_cores"],
        max_abs_err=errs["streamed_matmul_f32"],
        ms=time_ms(lambda: streamed_matmul(x, w), flush),
        plain_ms=time_ms(lambda: matmul_ref(x, w), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(x, w), flush), flop=flop,
    ))
    host_cost(cfg)
    # each route by ring depth (log only): the tensor cores at the first MLP
    # shape, f32 at the sweep's 512^3 and at listing 4's shape (the listing's
    # own ring); the kernel sweep's rings as phase 4 timed them
    m, k, n = mlp_shapes(cfg)[0]
    x, w = mm_inputs(m, k, n, torch.bfloat16)
    by_ring = {(d, s): round(time_ms(lambda: streamed_matmul(x, w, spec=PrefetchSpec(s, 1, d)), flush), 5)
               for d, s in [(0, 1), (1, 2), (2, 3), (3, 4), (5, 6)]}
    log(f"  streamed_matmul ({m},{k})@({k},{n}) bf16 ms by ring (distance, slots): {by_ring}")
    m, k, n = SWEEP_SHAPE
    x, w = mm_inputs(m, k, n, torch.float32)
    by_ring = {(d, s): round(time_ms(lambda: streamed_matmul(x, w, spec=PrefetchSpec(s, 1, d)), flush), 5)
               for d, s in TIMED_RINGS}
    log(f"  streamed_matmul ({m},{k})@({k},{n}) f32 ms by ring (distance, slots): {by_ring}")
    (m, k, n), (d, s) = LISTING4_SHAPE, LISTING4_RING
    x, w = mm_inputs(m, k, n, torch.float32)
    log(f"  streamed_matmul listing 4 ({m},{k})@({k},{n}) f32 ring {LISTING4_RING}: kernel "
        f"{time_ms(lambda: streamed_matmul(x, w, spec=PrefetchSpec(s, 1, d)), flush):.5f} ms, torch.matmul "
        f"{time_ms(lambda: torch.matmul(x, w), flush):.5f} ms")
    log("  kernel sweep (phase 4, 512^3 f32, 20 calls back to back, L2 warm) ms by ring: "
        + str({(r["distance"], r["ring_slots"]): round(r["ms"], 5) for r in sweep}))
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        flop = r.pop("flop", None)  # operations on the tensor cores, for the log only
        rate = "" if flop is None else f", {flop / r['ms'] / 1e9:.1f} TFLOP/s"
        log(f"  {r['name']} {r['cell']} {r['shape']}: kernel {r['ms']:.4f} ms{rate}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off: the plain versions are f32-exact references
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="pallas")
    hcfg = dataclasses.replace(get_config("recurrentgemma-2b"), attn_impl="pallas")
    t0 = time.perf_counter()
    phase_build()
    errs = phase_kernels(cfg, hcfg)
    res, launches = phase_serve(cfg, PROMPT, "2", ("flash_attention", "decode_attention"))
    phase_check(cfg, res, PROMPT, "3")
    del res
    hres, hlaunches = phase_serve(hcfg, HYB_PROMPT, "2b",
                                  ("rglru_scan", "flash_attention", "decode_attention"))
    phase_check(hcfg, hres, HYB_PROMPT, "3b")
    del hres
    launches["streamed_matmul"], sweep = phase_paper(cfg)
    rows = phase_times(cfg, hcfg, errs, launches, hlaunches, sweep)
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
