#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths, the paper's offload path,
training (with the weights on the card and streamed from the host or
disk) and the paper's tables on one NVIDIA card.

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
2p. serve the same model, weights and prompts through the paged
   ``ServeSession`` (32-token pages, one hot page, ``distance="auto"``),
   each run with the launch counts zeroed just before and read just after:
   (a) device pages, tokens bitwise phase 2's and the same flash and decode
   launches; (b) pinned-host and disk pages, tokens bitwise (a)'s, one H2D
   request and one page (1,310,720 bytes) per fetched page group, one disk
   request per group, the device retaining less than the 89,128,960-byte
   cache; (c) the unpaged pinned-host round trip, tokens bitwise (a)'s, one
   H2D and one D2H request per cache leaf a step; (d) 8 requests on 4
   slots sharing a 256-token prefix at pinned host, with and without
   copy-on-write sharing: the same tokens, shared hits, fewer H2D bytes;
   (e) the load generator's bursty trace (prompts 128/256/512, outputs
   8/16/32, a 64-token shared prefix) through the SLO scheduler at pinned
   host under the virtual clock, every offered request completed or
   rejected, then again over the trace cut to its first phase, whose
   requests must get the same stamps and tokens as in the whole run; then
   one wall-clock run;
2w. serve the same model, weights and prompts with the weights homed off
   the card and streamed group by group (``param_kind``), each run with the
   launch counts zeroed just before and read just after: (a) unpaged at
   pinned host under ``device_budget_mb=160`` (34 groups, 818,014,080
   bytes a pass): tokens bitwise phase 2's, the same flash and decode
   launches, one H2D request and the plan's bytes per fetched group,
   streamed plus cached bytes within the budget, ``max_memory_allocated``
   logged beside phase 2's; (b) the same at disk, gen 8; (c) the paged
   session at pinned-host pages and weights under 176 MB (the hot window's
   cut first): tokens bitwise, the schedule verified; (d) no budget, then
   ``param_cache_mb=0``, gen 8: 0 and all groups fetched each decode step;
   (e) (a) under the hazard sanitizer, bitwise, and a 100 MB budget (under
   the distance-1 floor) refused before any thread exists;
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

6. train full-width smollm-360m (361,821,120 parameters, bf16, random
   weights from seed 0, ``attn_impl="xla"``, ``remat="full"``, loss chunks of
   512; batch 8, sequence 1024, AdamW with peak lr 1e-3, 2 warmup steps, 8
   total) through the launcher's ``build_trainer``: (a)'s first run and
   (e) through its driver's ``run()`` (checkpoints included), the others
   through the same trainer's state, loader and step: (a) the AdamW state
   on the card, 8 steps, twice from the same init (finite losses, the
   second run bitwise the first); the step wall (median of steps 2-7), tokens/s, model FLOP/s
   (6 N T) and its share of 989 TFLOP/s, ``max_memory_allocated``, and one
   profiled step's device busy time, idle share, launches and top kernels;
   the same steps with ``torch.use_deterministic_algorithms`` on (the
   default path runs with it off); (b) bulk ``HOST_OPT`` (the state pinned
   between steps) and (c) ``--stream-opt`` (4 groups through the transfer
   engine, ``distance="auto"``, the moments numpy between steps, 4 H2D
   requests and 4,341,853,440 bytes a step, the wait and writeback drain of
   each step logged), losses and parameters bitwise (a)'s; (d) ``DISK_OPT``
   under 2000 MB of host, 1 step: bitwise (a)'s, one disk request a
   spilled group; (e) the driver with a failure injected at step 3
   and checkpoints every 2 steps: one restart, the restored state bitwise
   the saved one, every loss bitwise the unfailed run's, the time from the
   failure to the first resumed step logged; (f) ``forward_train`` under
   ``attn_impl="pallas"`` with gradients off, the kernel counts zeroed just
   before and read just after: ``flash_attention`` launched once a layer
   (32), the logits within 5e-2 of the xla path's relative to the largest
   logit, a gradient step raising; the kernel against its plain version at
   the training shape.  (a)-(e) launch no hand-written kernel, as in the
   JAX package, whose gradient path runs none.  Phase 6 runs after phase 4,
   and phase 5 times its flash shape beside the serving ones.
6w. train the same model on phase 6's batches through the streamed-weight
   train step (``make_weight_streamed_train_step``), the weights, gradients
   and AdamW moments homed off the card under ``device_budget_mb=160``, one
   layer a group (34 groups), from the group-wise init (no whole model on
   the card), the schedule analyzed first: (a) the device home, 2 steps,
   its step-0 loss within 2e-2 of phase 6 (a)'s; (b) pinned host, 2 steps
   each at distance 0, 1 and ``auto``; (c) disk (``wp/`` and ``wopt/``
   chunks, fsync'd), 1 step.  Every home's losses, parameters and moments
   bitwise (a)'s; each step's H2D, D2H and disk requests and bytes, of the
   weight passes and of the optimizer pass, the plan's; the peak streamed
   bytes the plan's window at 0 and 1 (94,373,760 and 114,038,400), within
   the budget's window at ``auto``, under the analyzed peak and the budget,
   plus the cached bytes within the budget and the cache; the head's
   ``ln_f`` the one residency hit a step after the first; each run's step
   walls, wait, drain, bytes each way and ``max_memory_allocated`` (beside
   phase 6 (a)'s) logged with the card's name and power limit.  No
   hand-written kernel runs here, as in phase 6.
7. the paper's tables and the engine studies at full size, through the
   port's runner (``repro_torch.benchmarks.run.run_suites``), after phase 5:
   ``HwSpec`` H100's ``hbm_bytes`` within 10% of the card's total memory;
   Table 2 (stall a transfer at 128 B-1 MiB, pinned and pageable on demand,
   prefetched); Table 1 (``a @ a`` at n = 1024 f32 and 8192 f32 and bf16
   with ``nvidia-smi``'s watts, idle draw, GFLOP/W); the engine A/B (one
   request a group against the seed's seven, values bitwise across configs
   and links) with the pack/link split of this workload's group, Fig 4's
   and smollm-360m's embed, layers and tied-head groups (summed over its
   pass of 34); the disk tier's gates.  Every gate is fatal but one: the
   engine's paper-link speedup (>= 1.20x over the per-leaf schedule) fails
   on the card and is logged as found until ROADMAP queue 1 item 8, with its
   request counts held and the speedup above 0.9x, else fatal too.  Each
   table and line carries the card's name and power limit.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
# phase 2p: the JAX package's default page length, one hot page; 8 requests
# sharing a 256-token prefix; the load generator's trace
PAGE_LEN, HOT_PAGES, SHARED_PREFIX = 32, 1, 256
LG_PROMPTS, LG_GENS, LG_SHARED = (128, 256, 512), (8, 16, 32), 64
# phase 2w: the weights streamed under 160 MB (34 groups, 818,014,080 bytes a
# pass: the tied head re-reads the embedding); the paged session's 176 MB
# leaves the same ~160 MB once the hot window (15.7 MB) is cut; a budget under
# the distance-1 floor; the disk and residency runs' shorter generation
W_BUDGET_MB, W_PAGED_BUDGET_MB, W_FLOOR_MB = 160, 176, 100
W_GROUPS, W_PASS_BYTES, W_SHORT_GEN = 34, 818_014_080, 8
# the recurrentgemma-2b cell: a prompt longer than the 2048-token window
HYB_PROMPT = 3072
# phase 6: full-width smollm-360m training at the JAX package's train defaults
# (remat "full", loss chunks of 512 positions), its AdamW settings; the
# streamed optimizer's groups; the DISK_OPT host budget and its steps; the
# failure the driver recovers from
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PARAMS = 8, 1024, 8, 361_821_120
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_GROUPS, TRAIN_STATE_BYTES = 4, 4_341_853_440  # 12 bytes a parameter
# (d) takes one step: its fsync'd disk writes cost ~10-15 s a step, and
# phase 6 keeps within ~110 s (the CPU tests hold several disk steps)
TRAIN_HOST_MB, TRAIN_DISK_STEPS = 2000, 1
TRAIN_FAIL_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 4, 3, 2
# phase 6w: phase 6's model and batches through the streamed-weight train step
# under 160 MB, one layer a group (34 groups); the steps of each run (the disk
# run's fsync'd writeback of ~5.8 GB costs ~10-20 s a step, so it takes one)
W_TRAIN_BUDGET_MB, W_TRAIN_GROUPS, W_TRAIN_STEPS, W_TRAIN_DISK_STEPS = 160, 34, 2, 1
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


def phase_serve(cfg, prompt: int, phase: str, expect: tuple, params=None) -> tuple[dict, dict]:
    """Serve ``cfg`` through the entry point (with ``params``, or weights
    from ``SEED``); every serving kernel's count is zeroed just before and
    read just after, and each of ``expect`` must have launched."""
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
                kv_page_len=0, seed=SEED, params=params)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"  prefill {res['prefill_s'] * 1e3:.3f} ms for {BATCH} requests "
        f"({res['prefill_s'] * 1e3 / BATCH:.3f} ms each), decode {res['decode_s'] * 1e3:.3f} ms "
        f"for {res['n_steps']} steps = {res['tokens_per_s']:.1f} tok/s, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  launches during serve: {launches}")
    if min(launches[k] for k in expect) <= 0:
        raise SystemExit(f"a kernel of the path was not launched: {launches}")
    return res, launches


def tail_wait(step_waits: list) -> float:
    """Median compute-blocked wait a step over the second half of the steps
    (the steady state; the JAX package's ``serve_paged`` benchmark's)."""
    tail = sorted(step_waits[len(step_waits) // 2:])
    return tail[len(tail) // 2] if tail else 0.0


def paged_run(cfg, params, name: str, **kw) -> tuple[dict, dict]:
    """One serve through the entry point with the launch counts zeroed just
    before and read just after; logs the run's end-to-end numbers."""
    from repro_torch.launch.serve import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    kw = {"batch": BATCH, "prompt_len": PROMPT, "gen": GEN, "seed": SEED, **kw}
    res = serve(cfg, params=params, **kw)
    launches = {k: w.launches for k, w in wrappers.items()}
    st = res["stats"]
    resident = (f", peak resident {res['peak_resident_bytes']} of {res['total_cache_bytes']} B"
                if res["paged"] else "")
    log(f"  {name}: prefill {res['prefill_s'] * 1e3:.3f} ms, decode "
        f"{res['decode_s'] * 1e3 / max(res['n_steps'], 1):.3f} ms a step ({res['n_steps']} steps), "
        f"{res['tokens_per_s']:.1f} tok/s, transfer_wait_s {st.transfer_wait_s:.6f}, tail step "
        f"wait {tail_wait(res['step_waits']) * 1e3:.3f} ms; h2d {st.h2d_requests} req / "
        f"{st.bytes_h2d} B over {st.n_groups} groups, d2h {st.d2h_requests} req, disk "
        f"{st.disk_requests} req{resident}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches {launches}")
    return res, launches


def phase_paged(cfg, params, unpaged: dict, unpaged_launches: dict) -> None:
    """Phase 2p: the paged session at full width against phase 2's unpaged
    run on the same weights and prompts."""
    import numpy as np

    from repro_torch.launch.serve import ServeSession
    from repro_torch.serve import SLO, LoadGenConfig, SLOScheduler, generate

    log(f"phase 2p paged serve {cfg.name}: pages of {PAGE_LEN} tokens, {HOT_PAGES} hot page, "
        f"distance auto; batch {BATCH}, prompt {PROMPT}, gen {GEN}")
    t0 = t_sub = time.perf_counter()

    def sub_s() -> float:
        """Seconds since the last sub-phase ended."""
        nonlocal t_sub
        t, t_sub = t_sub, time.perf_counter()
        return t_sub - t

    def same(name, a, b):
        if not np.array_equal(a, b):
            raise SystemExit(f"{name}: tokens differ from the run they must equal bitwise")

    page = dict(kv_page_len=PAGE_LEN, hot_pages=HOT_PAGES, distance="auto")
    dev, launches = paged_run(cfg, params, "(a) device pages", kv_kind="device", **page)
    same("(a) device pages", dev["generated"], unpaged["generated"])
    kernels = ("flash_attention", "decode_attention")
    if any(launches[k] != unpaged_launches[k] for k in kernels):
        raise SystemExit(f"(a) launches {launches} differ from phase 2's {unpaged_launches}")
    if dev["stats"].h2d_requests or dev["stats"].d2h_requests:
        raise SystemExit("(a) device pages moved over the link")
    log(f"  (a) done ({sub_s():.1f} s)")

    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    page_bytes = 2 * cfg.n_layers * PAGE_LEN * cfg.n_kv_heads * cfg.head_dim * itemsize  # k and v
    total = BATCH * ((PROMPT + GEN) // PAGE_LEN) * page_bytes
    cold = BATCH * (PROMPT // PAGE_LEN - HOT_PAGES)  # cold pages fetched each step
    groups = cold * (GEN - 1)
    for kind in ("pinned_host", "disk_host"):
        res, launches = paged_run(cfg, params, f"(b) {kind} pages", kv_kind=kind, **page)
        same(f"(b) {kind}", res["generated"], dev["generated"])
        st = res["stats"]
        checks = {
            "n_groups": (st.n_groups, groups),
            "h2d_requests": (st.h2d_requests, st.n_groups),
            "bytes_h2d": (st.bytes_h2d, st.n_groups * page_bytes),
            "total_cache_bytes": (res["total_cache_bytes"], total),
            "disk_requests": (st.disk_requests, st.n_groups if kind == "disk_host" else 0),
            "per_tier disk requests": (st.per_tier()["disk"]["requests"], st.disk_requests),
        }
        for what, (got, want) in checks.items():
            if got != want:
                raise SystemExit(f"(b) {kind}: {what} {got}, expected {want}")
        if not res["peak_resident_bytes"] < res["total_cache_bytes"]:
            raise SystemExit(f"(b) {kind}: the device retained the whole cache")
        if min(launches[k] for k in kernels) <= 0:
            raise SystemExit(f"(b) {kind}: a kernel of the path was not launched: {launches}")
        log(f"  (b) {kind} done ({sub_s():.1f} s)")

    res, _ = paged_run(cfg, params, "(c) unpaged pinned_host round trip", kv_kind="pinned_host",
                       kv_page_len=0)
    same("(c) unpaged pinned_host", res["generated"], dev["generated"])
    st, leaves = res["stats"], 2  # k and v
    if not st.h2d_requests == st.d2h_requests == (GEN - 1) * leaves:
        raise SystemExit(f"(c) h2d {st.h2d_requests} / d2h {st.d2h_requests} requests, "
                         f"expected {(GEN - 1) * leaves} each")
    log(f"  (c) done ({sub_s():.1f} s)")

    runs = {}
    for sharing in (True, False):
        runs[sharing], _ = paged_run(cfg, params, f"(d) {2 * BATCH} requests, {SHARED_PREFIX} shared tokens, sharing "
                                     f"{sharing}", kv_kind="pinned_host", n_requests=2 * BATCH,
                                     shared_prefix_len=SHARED_PREFIX, prefix_sharing=sharing,
                                     **page)
    same("(d) shared vs unshared", runs[True]["generated"], runs[False]["generated"])
    on, off = runs[True]["stats"], runs[False]["stats"]
    if not (on.shared_hits > 0 and on.bytes_h2d < off.bytes_h2d):
        raise SystemExit(f"(d) sharing saved nothing: {on.shared_hits} hits, "
                         f"{on.bytes_h2d} against {off.bytes_h2d} B")
    log(f"  (d) done ({sub_s():.1f} s)")

    trace = LoadGenConfig(seed=0, prompt_lens=LG_PROMPTS, prompt_mix=(1.0,) * len(LG_PROMPTS),
                          gen_lens=LG_GENS, gen_mix=(1.0,) * len(LG_GENS),
                          shared_prefix_len=LG_SHARED, vocab_size=cfg.vocab_size)
    offered = generate(trace)

    def slo_run(offered, virtual_step_s):
        """The SLO report, each request's latency record and its tokens."""
        with ServeSession(cfg, slots=BATCH, max_len=PROMPT + GEN, kv_kind="pinned_host",
                          page_len=PAGE_LEN, hot_pages=HOT_PAGES, params=params) as session:
            sched = SLOScheduler(session, offered, slo=SLO(), max_queue=32,
                                 virtual_step_s=virtual_step_s)
            rep = sched.run()
            tokens = {rid: req.emitted for rid, req in session.requests.items()}
        if rep["offered"] != rep["completed"] + rep["rejected_oversize"] + rep["rejected_overload"]:
            raise SystemExit(f"(e) offered {rep['offered']} is not completed + rejected: {rep}")
        return rep, sched.tracked, tokens

    # the virtual clock, twice: the whole trace, then the trace cut to its
    # first phase.  Under that clock a request's stamps and tokens depend
    # only on the requests that arrived before it (the queue is first in,
    # first out), so the first phase's must come out equal in both runs.
    r, tracked, tokens = slo_run(offered, 0.01)
    first = [o for o in offered if o.arrival_s < trace.phases[0].duration_s]
    _, tracked1, tokens1 = slo_run(first, 0.01)
    if not tracked1 or any(tracked1[rid] != tracked[rid] or tokens1[rid] != tokens[rid]
                           for rid in tracked1):
        raise SystemExit("(e) two virtual-clock runs of the first phase disagree")
    log(f"  (e) SLO trace, virtual clock (10 ms a step): offered {r['offered']}, completed "
        f"{r['completed']}, rejected {r['rejected_oversize']} + {r['rejected_overload']}, "
        f"{r['n_steps']} steps, {r['shared_hits']} shared hits, {r['prefill_compiles']} prefill "
        f"widths; again over the first phase's {len(first)} requests, equal "
        f"({sub_s():.1f} s)")
    r, _, _ = slo_run(offered, None)
    log(f"  (e) SLO trace, wall clock, on the card: offered {r['offered']}, completed "
        f"{r['completed']} over {r['makespan_s']:.3f} s; TTFT p50 {r['ttft_s']['p50'] * 1e3:.3f} "
        f"ms p99 {r['ttft_s']['p99'] * 1e3:.3f} ms; TPOT p50 {r['tpot_s']['p50'] * 1e3:.3f} ms "
        f"p99 {r['tpot_s']['p99'] * 1e3:.3f} ms; SLO attainment {r['slo_attainment']:.3f} "
        f"({sub_s():.1f} s)")
    log(f"  phase 2p done in {time.perf_counter() - t0:.1f} s")


def streamed_run(cfg, params, name: str, engine=None, **kw) -> tuple[dict, dict]:
    """One serve through the entry point with the weights at a host home,
    launch counts zeroed just before and read just after; logs the weight
    stream's numbers."""
    from repro_torch.launch.serve import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    kw = {"batch": BATCH, "prompt_len": PROMPT, "gen": GEN, "seed": SEED, "kv_page_len": 0,
          **kw}
    res = serve(cfg, params=params, engine=engine, **kw)
    launches = {k: w.launches for k, w in wrappers.items()}
    ps, plan, rc = res["param_stats"], res["param_plan"], res["param_residency"]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"  {name}: {plan.n_groups} groups, prefill {res['prefill_s'] * 1e3:.3f} ms, decode "
        f"{res['decode_s'] * 1e3 / max(res['n_steps'], 1):.3f} ms a step ({res['n_steps']} steps); "
        f"weights: {ps.n_runs} passes, {ps.unique_group_fetches} groups fetched, "
        f"{ps.h2d_requests} H2D req / {ps.bytes_h2d} B, {ps.disk_requests} disk req, wait "
        f"{ps.transfer_wait_s:.6f} s, peak streamed {ps.peak_inflight_bytes} B + cached "
        f"{rc['peak_resident_bytes']} B (residency {rc['hits']} hits, {rc['entries']} entries); "
        f"max_memory_allocated {res['max_memory_allocated']} B; launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    return res, launches


def phase_streamed(cfg, params, unpaged: dict, unpaged_launches: dict) -> None:
    """Phase 2w: the weights homed at pinned host or disk and streamed group
    by group under a device budget, on phase 2's model, weights and prompts."""
    import os
    import threading

    import numpy as np

    from repro_torch.core.engine import EngineConfig, TransferEngine
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.launch.serve import ServeSession, serve
    from repro_torch.train.steps import abstract_params

    log(f"phase 2w streamed weights {cfg.name}: budget {W_BUDGET_MB} MB (unpaged), "
        f"{W_PAGED_BUDGET_MB} MB (paged); batch {BATCH}, prompt {PROMPT}, gen {GEN} "
        f"(disk and residency: gen {W_SHORT_GEN})")
    t0 = time.perf_counter()
    kernels = ("flash_attention", "decode_attention")
    want = unpaged["generated"]
    plan = WeightStreamPlan(cfg, abstract_params(cfg), device_budget_mb=W_BUDGET_MB)
    total = sum(plan.fetch_sequence_bytes())

    def same(name, got, ref):
        if not np.array_equal(got, ref):
            raise SystemExit(f"2w {name}: tokens differ from the run they must equal bitwise")

    def check_stream(name, res, disk: bool):
        """One request per fetched group; the bytes of the groups fetched; the
        plan's groups; streamed + cached bytes within the budget."""
        ps, rc = res["param_stats"], res["param_residency"]
        # at this budget only the head's home (ln_f) fits the cache, so every
        # pass after the first fetches the tied table without it; from disk a
        # head fetch whose own chunk is not resident reads two chunks (its
        # own and the embedding's), one more disk request than groups
        checks = {
            "n_groups": (res["param_plan"].n_groups, W_GROUPS),
            "bytes a pass": (total, W_PASS_BYTES),
            "h2d_requests": (ps.h2d_requests, ps.unique_group_fetches),
            "groups fetched": (ps.unique_group_fetches, ps.n_runs * W_GROUPS),
            "residency hits": (rc["hits"], ps.n_runs - 1),
            "bytes_h2d": (ps.bytes_h2d, ps.n_runs * total - rc["hits"] * plan.head_home_bytes),
            "disk_requests": (ps.disk_requests,
                              ps.unique_group_fetches + ps.n_runs - rc["hits"] if disk else 0),
        }
        for what, (got, exp) in checks.items():
            if got != exp:
                raise SystemExit(f"2w {name}: {what} {got}, expected {exp}")
        held = ps.peak_inflight_bytes + rc["peak_resident_bytes"]
        if not held <= W_BUDGET_MB * 1e6 < total:
            raise SystemExit(f"2w {name}: streamed + cached {held} B against the budget "
                             f"{W_BUDGET_MB} MB and {total} B a pass")

    stream = dict(param_kind="pinned_host", device_budget_mb=W_BUDGET_MB)
    res, launches = streamed_run(cfg, params, "(a) pinned_host", **stream)
    same("(a)", res["generated"], want)
    if any(launches[k] != unpaged_launches[k] for k in kernels):
        raise SystemExit(f"2w (a) launches {launches} differ from phase 2's {unpaged_launches}")
    check_stream("(a)", res, disk=False)
    log(f"  (a) max_memory_allocated {res['max_memory_allocated']} B against phase 2's "
        f"{unpaged['max_memory_allocated']} B")

    res, launches = streamed_run(cfg, params, "(b) disk_host", param_kind="disk_host",
                                 device_budget_mb=W_BUDGET_MB, gen=W_SHORT_GEN)
    same("(b)", res["generated"], want[:, :W_SHORT_GEN])
    check_stream("(b)", res, disk=True)
    if min(launches[k] for k in kernels) <= 0:
        raise SystemExit(f"2w (b): a kernel of the path was not launched: {launches}")

    # (c) the paged session: the hot window's cut of the budget first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    t1 = time.perf_counter()
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, (BATCH, PROMPT),
                                                      dtype=np.int32)  # serve()'s
    with ServeSession(cfg, slots=BATCH, max_len=PROMPT + GEN, kv_kind="pinned_host",
                      page_len=PAGE_LEN, hot_pages=HOT_PAGES, params=params,
                      param_kind="pinned_host", device_budget_mb=W_PAGED_BUDGET_MB) as session:
        rids = [session.submit(p, GEN) for p in prompts]
        out = session.run()
        report, ps, splan = session.schedule_report, session.param_stats, session._wplan
        pages = session.stats.n_groups
    launches = {k: w.launches for k, w in wrappers.items()}
    same("(c) paged", np.stack([out[r] for r in rids]), want)
    if not report.ok or min(launches[k] for k in kernels) <= 0:
        raise SystemExit(f"2w (c): schedule {report.ok}, launches {launches}")
    if ps.h2d_requests != ps.unique_group_fetches:
        raise SystemExit(f"2w (c): {ps.h2d_requests} H2D requests for "
                         f"{ps.unique_group_fetches} groups fetched")
    log(f"  (c) paged, pinned pages and weights at {W_PAGED_BUDGET_MB} MB: {splan.n_groups} "
        f"groups, weights {ps.unique_group_fetches} groups / {ps.bytes_h2d} B, pages {pages} "
        f"groups; max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches "
        f"{launches}\n{report} ({time.perf_counter() - t1:.1f} s)")

    # (d) residency: no budget = an unbounded cache, the model stays on the
    # card; param_cache_mb=0 = the uncached schedule
    for name, kw, each in (("(d) no budget", {}, lambda n: 0),
                           ("(d) param_cache_mb=0", {"param_cache_mb": 0.0}, lambda n: n)):
        res, _ = streamed_run(cfg, params, name, param_kind="pinned_host", gen=W_SHORT_GEN, **kw)
        same(name, res["generated"], want[:, :W_SHORT_GEN])
        n = res["param_plan"].n_groups
        fetches = res["param_step_fetches"]
        if not fetches or any(f != each(n) for f in fetches):
            raise SystemExit(f"2w {name}: groups fetched a step {fetches}, expected {each(n)} "
                             f"of {n}")
        log(f"  {name}: groups fetched a decode step {fetches} of {n}")

    # (e) the hazard sanitizer on (a): the engine's and the residency cache's
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        engine = TransferEngine(EngineConfig(max_distance=plan.max_distance_for_budget()),
                                device="cuda")
        with engine:
            res, _ = streamed_run(cfg, params, "(e) sanitized", engine=engine, **stream)
        checks = engine.sanitizer.checks
    finally:
        del os.environ["REPRO_SANITIZE"]
    same("(e) sanitized", res["generated"], want)
    if not checks:
        raise SystemExit("2w (e): the sanitizer checked nothing")
    n_threads = threading.active_count()
    for what, build in (
        ("serve", lambda: serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=SEED,
                                params=params, kv_page_len=0, device_budget_mb=W_FLOOR_MB,
                                param_kind="pinned_host")),
        ("ServeSession", lambda: ServeSession(cfg, slots=BATCH, max_len=PROMPT + GEN,
                                              kv_kind="pinned_host", params=params,
                                              param_kind="pinned_host",
                                              device_budget_mb=W_FLOOR_MB)),
    ):
        try:
            build()
        except ValueError as e:
            if threading.active_count() != n_threads:
                raise SystemExit(f"2w (e): the refused {what} left a thread behind") from e
            log(f"  (e) {what} at {W_FLOOR_MB} MB refused before any thread: "
                f"{str(e).splitlines()[0]}")
        else:
            raise SystemExit(f"2w (e): {what} accepted a {W_FLOOR_MB} MB budget")
    log(f"  (e) sanitized run bitwise, {checks} sanitizer checks")
    log(f"  phase 2w done in {time.perf_counter() - t0:.1f} s")


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


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as integers of its width (bitwise comparisons)."""
    return t.reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                               8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    """Two trees of tensors or host arrays, bit for bit (on the card)."""
    from repro_torch.core import tree as tr
    from repro_torch.core.arrays import host_tensor

    la, lb = tr.leaves(a), tr.leaves(b)
    on = lambda x: host_tensor(x).to("cuda")  # noqa: E731
    return len(la) == len(lb) and all(
        on(x).dtype == on(y).dtype and torch.equal(bits(on(x)), bits(on(y))) for x, y in zip(la, lb))


def train_cfg(cfg, **kw):
    return dataclasses.replace(cfg, attn_impl="xla", remat="full", loss_chunk=512, **kw)


def train_batch(cfg, step: int, device="cuda") -> dict:
    """The launcher's batch for ``step``, on the card."""
    from repro_torch.data import SyntheticConfig, synthetic_batch

    sc = SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    return {k: v.to(device) for k, v in synthetic_batch(cfg, sc, step).items()}


def train_run(cfg, ckpt_dir: Path, *, steps: int = TRAIN_STEPS, run: bool = False,
              keep_after=(), setup=None, checkpoint_every: int = 100, **kw) -> dict:
    """Train ``cfg`` through the launcher's ``build_trainer``: with ``run``,
    its driver's ``run()`` (the restart loop and checkpoints, the final one
    included); else the trainer's own state, loader and step for ``steps``
    steps (no checkpoint).  Each step's wall ends with a synchronise of the
    card; the stream counters are read around each step; the parameters
    after ``keep_after`` steps are cloned."""
    import shutil

    from repro_torch.core import tree as tr
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.driver import DriverConfig

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    driver = build_trainer(
        cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, opt_cfg=AdamWConfig(**TRAIN_OPT),
        driver_cfg=DriverConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                                checkpoint_dir=str(ckpt_dir), log_every=0),
        seed=SEED, device="cuda", **kw)
    inner, st = driver.step_fn, driver.stream_stats
    out = dict(walls=[], spans=[], waits=[], drains=[], h2d=[], kept={}, driver=driver)
    fields = ("transfer_wait_s", "writeback_drain_s", "h2d_requests", "bytes_h2d",
              "disk_requests")

    def step(state, batch):
        before = [getattr(st, f) for f in fields] if st else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = inner(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["walls"].append(t1 - t0)
        out["spans"].append((t0, t1))
        if st:
            d = [getattr(st, f) - b for f, b in zip(fields, before)]
            out["waits"].append(d[0])
            out["drains"].append(d[1])
            out["h2d"].append(tuple(d[2:]))
        if len(out["walls"]) in keep_after:
            out["kept"][len(out["walls"])] = tr.tree_map(torch.clone, new["params"])
        return new, metrics

    driver.step_fn = step
    if setup is not None:
        setup(driver)
    t0 = time.perf_counter()
    if run:
        out["state"] = driver.run()
        out["losses"] = [(h["step"], h["loss"]) for h in driver.history]
    else:
        try:
            state, out["losses"] = driver.init_state(), []
            for i in range(steps):
                state, m = step(state, driver.make_batch(i))
                out["losses"].append((i, float(m["loss"])))
            out["state"] = state
        finally:
            for owned in (driver.engine, driver.spill_store):  # run()'s close order
                if owned is not None:
                    owned.close()
    out["seconds"] = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def phase_train(cfg) -> dict:
    """Phase 6: train full-width smollm-360m on the card through the
    launcher's driver, the AdamW state on the card, at pinned host (in bulk
    and streamed) and spilled to disk; restart after a failure; the training
    forward through the flash kernel.  Returns the flash kernel's launches
    and error for the kernel table."""
    import warnings

    from repro_torch.core import memkind as mk
    from repro_torch.core import tree as tr
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.launch.profile_serve import _breakdown
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    tcfg = train_cfg(cfg)
    n_params = sum(p.numel() for p in tr.leaves(st.abstract_train_state(tcfg)[0]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 6 train {tcfg.name}: {tcfg.n_layers} layers, d_model {tcfg.d_model}, {n_params:,} "
        f"parameters, {tcfg.dtype}, attn_impl={tcfg.attn_impl}, remat={tcfg.remat}, loss_chunk "
        f"{tcfg.loss_chunk}; batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, AdamW {TRAIN_OPT}; "
        f"deterministic algorithms {torch.are_deterministic_algorithms_enabled()}")
    if n_params != TRAIN_PARAMS:
        raise SystemExit(f"smollm-360m has {n_params} parameters, not {TRAIN_PARAMS}")
    ckpt = ROOT / "build" / "train-ckpt"
    since = [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        dt, since[0] = now - since[0], now
        return dt

    # (a) the state on the card, twice from the same init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = train_run(tcfg, ckpt, run=True, keep_after={TRAIN_DISK_STEPS})
    peak = torch.cuda.max_memory_allocated()
    a2 = train_run(tcfg, ckpt)
    losses = [loss for _, loss in a["losses"]]
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"(a) losses not finite: {losses}")
    if a2["losses"] != a["losses"] or not same_bits(a2["state"]["params"], a["state"]["params"]):
        raise SystemExit("(a) a second run from the same init differs from the first")
    wall = median(a["walls"][2:])
    flops = 6 * n_params * tokens  # model FLOPs a step (6 N T; the attention's not counted)
    log(f"  (a) device: losses {[round(x, 4) for x in losses]}; a second run from the same init "
        f"bitwise equal (losses, parameters)")
    log(f"  (a) step wall {wall * 1e3:.3f} ms (median of steps 2-7; runs {[round(w * 1e3, 3) for w in a['walls']]} "
        f"/ {[round(w * 1e3, 3) for w in a2['walls']]} ms), {tokens / wall:.1f} tok/s, model "
        f"{flops / wall / 1e12:.2f} TFLOP/s = {flops / wall / BF16_FLOP_PER_S:.4f} of 989 TFLOP/s; "
        f"max_memory_allocated {peak} B; the driver's run {a['seconds']:.1f} s (its final "
        f"checkpoint included), the second run's {a2['seconds']:.1f} s")
    # one profiled step on (a)'s state: device busy, idle share, launches, top kernels
    step_fn = st.make_train_step(tcfg, AdamWConfig(**TRAIN_OPT))
    params, opt = a2["state"]["params"], a2["state"]["opt"]
    del a2
    batch = train_batch(tcfg, 0)
    params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    # the step's two halves on the card (CUDA events): forward + backward, the AdamW update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, _, grads = st.make_grad_step(tcfg)(params, batch)
    ev[1].record()
    params, opt, _ = adamw_update(AdamWConfig(**TRAIN_OPT), grads, opt, compute_dtype=tcfg.compute_dtype)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    log(f"  (a) one step's halves on the card: forward + backward {ev[0].elapsed_time(ev[1]):.3f} ms, "
        f"AdamW update {ev[1].elapsed_time(ev[2]):.3f} ms")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
    r = _breakdown(prof, wall, 1, 10_000)
    idle = r["device_idle_share"]
    classes: dict = {}
    for k in r["top_kernels"]:
        name = k["name"].lower()
        cls = ("matmul" if any(w in name for w in ("gemm", "cutlass", "xmma", "cublas", "nvjet"))
               else "softmax" if "softmax" in name
               else "reduction" if "reduce" in name
               else "elementwise and copies")
        classes[cls] = classes.get(cls, 0.0) + k["ms_per_unit"]
    log(f"  (a) profiled step: device busy {r['device_busy_ms_per_unit']:.3f} ms of the "
        f"{wall * 1e3:.3f} ms wall, idle share {'not measured' if idle is None else f'{idle:.4f}'}, "
        f"{r['kernel_launches_per_unit']:.0f} kernel launches; device ms by kind "
        f"{ {c: round(v, 3) for c, v in sorted(classes.items(), key=lambda kv: -kv[1])} }; top kernels:")
    for k in r["top_kernels"][:10]:
        log(f"    {k['ms_per_unit']:.3f} ms  {k['share_of_busy']:.3f}  x{k['calls_per_unit']:.0f}  "
            f"{k['name']}")
    del params, opt, prof
    # the same steps with torch.use_deterministic_algorithms on
    params, opt = st.init_train_state(tcfg, SEED, "cuda")
    walls_det, losses_det = [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i in range(4):
                b = train_batch(tcfg, i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, b)
                losses_det.append(float(m["loss"]))
                walls_det.append(time.perf_counter() - t0)
    finally:
        torch.use_deterministic_algorithms(False)
    del params, opt
    log(f"  (a) deterministic algorithms on: step wall {median(walls_det[2:]) * 1e3:.3f} ms (steps 2-3; "
        f"off: {wall * 1e3:.3f} ms), losses {'bitwise equal to' if losses_det == losses[:4] else 'DIFFER from'}"
        f" the default path's ({lap():.1f} s)")

    # (b) bulk HOST_OPT: the state at pinned host between steps
    b_run = train_run(tcfg, ckpt, policy=mk.HOST_OPT)
    pinned = all(x.device.type == "cpu" and x.is_pinned() for x in tr.leaves(b_run["state"]["opt"]))
    if b_run["losses"] != a["losses"] or not same_bits(b_run["state"]["params"], a["state"]["params"]):
        raise SystemExit("(b) bulk HOST_OPT differs from the device run")
    if not pinned:
        raise SystemExit("(b) the optimizer state is not at pinned host between steps")
    log(f"  (b) bulk HOST_OPT: losses and parameters bitwise (a)'s, the state pinned between steps; "
        f"step wall {median(b_run['walls'][2:]) * 1e3:.3f} ms ({lap():.1f} s)")
    del b_run

    # (c) --stream-opt: 4 groups through the transfer engine, distance "auto"
    c = train_run(tcfg, ckpt, policy=mk.HOST_OPT, stream_opt=True, opt_stream_groups=TRAIN_GROUPS)
    moments_numpy = all(isinstance(x, np.ndarray) for x in tr.leaves(c["state"]["opt"]))
    if c["losses"] != a["losses"] or not same_bits(c["state"]["params"], a["state"]["params"]):
        raise SystemExit("(c) the streamed optimizer differs from the device run")
    if not moments_numpy:
        raise SystemExit("(c) the optimizer state is not numpy between steps")
    if any(h[:2] != (TRAIN_GROUPS, TRAIN_STATE_BYTES) for h in c["h2d"]):
        raise SystemExit(f"(c) (H2D requests, bytes) a step {c['h2d']}, not "
                         f"({TRAIN_GROUPS}, {TRAIN_STATE_BYTES})")
    log(f"  (c) --stream-opt, {TRAIN_GROUPS} groups, distance auto: losses and parameters bitwise (a)'s, "
        f"moments numpy between steps; {TRAIN_GROUPS} H2D requests and {TRAIN_STATE_BYTES:,} B a step; "
        f"step wall {median(c['walls'][2:]) * 1e3:.3f} ms; per step: wall "
        f"{[round(w * 1e3, 1) for w in c['walls']]} ms, transfer wait "
        f"{[round(w * 1e3, 1) for w in c['waits']]} ms, writeback drain "
        f"{[round(w * 1e3, 1) for w in c['drains']]} ms ({lap():.1f} s)")
    del c

    # (d) DISK_OPT under a host budget: groups past it spill to disk
    spill = ROOT / "build" / "spill-train"
    import shutil

    shutil.rmtree(spill, ignore_errors=True)
    try:
        d = train_run(tcfg, ckpt, steps=TRAIN_DISK_STEPS, policy=mk.DISK_OPT, stream_opt=True,
                      opt_stream_groups=TRAIN_GROUPS, spill_dir=str(spill),
                      host_budget_mb=TRAIN_HOST_MB)
        n_spilled = len(list(d["driver"].spill_store.keys()))
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    if d["losses"] != a["losses"][:TRAIN_DISK_STEPS] or not same_bits(
            d["state"]["params"], a["kept"][TRAIN_DISK_STEPS]):
        raise SystemExit("(d) DISK_OPT differs from the device run")
    if not n_spilled or any(h[2] != n_spilled for h in d["h2d"]):
        raise SystemExit(f"(d) disk requests a step {[h[2] for h in d['h2d']]}, not one per spilled "
                         f"group ({n_spilled})")
    log(f"  (d) DISK_OPT under {TRAIN_HOST_MB} MB of host: {n_spilled} of {TRAIN_GROUPS} groups "
        f"spilled, one disk request each a step; losses and parameters bitwise (a)'s after "
        f"{TRAIN_DISK_STEPS} step(s); step walls {[round(w * 1e3, 1) for w in d['walls']]} ms, transfer "
        f"wait {[round(w * 1e3, 1) for w in d['waits']]} ms ({lap():.1f} s)")
    del d

    # (e) the driver's restart: a failure at step 3, restored from step 1's checkpoint
    saved, restored, marks = {}, [], {}

    def setup(drv):
        real_save, real_restore, real_start = drv.ckpt.save, drv.ckpt.restore, drv.monitor.start_step

        def save(step, tree, **kw):
            saved[step] = tr.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)
            t0 = time.perf_counter()
            real_save(step, tree, **kw)
            marks.setdefault("saves", []).append((step, time.perf_counter() - t0))

        def restore(template, **kw):
            marks["restore"] = time.perf_counter()
            out = real_restore(template, **kw)
            marks["restored"] = time.perf_counter()
            restored.append(out)
            return out

        def start(step):
            if step == TRAIN_FAIL_AT and "fail" not in marks:
                marks["fail"] = time.perf_counter()
            return real_start(step)

        drv.ckpt.save, drv.ckpt.restore, drv.monitor.start_step = save, restore, start

    e = train_run(tcfg, ckpt, steps=TRAIN_FAIL_STEPS, run=True, fail_at={TRAIN_FAIL_AT},
                  setup=setup, checkpoint_every=TRAIN_CKPT_EVERY)
    ref = dict(a["losses"])
    if e["driver"].restarts != 1 or len(restored) != 1:
        raise SystemExit(f"(e) {e['driver'].restarts} restarts, {len(restored)} restores")
    step_r, state_r = restored[0]
    if not same_bits(state_r, saved[step_r]):
        raise SystemExit(f"(e) the state restored at step {step_r} differs from the one saved")
    if any(loss != ref[s] for s, loss in e["losses"]):
        raise SystemExit(f"(e) losses after the restart differ: {e['losses']}")
    resumed = next(span for span in e["spans"] if span[0] > marks["fail"])
    log(f"  (e) TrainDriver, failure injected at step {TRAIN_FAIL_AT}: 1 restart, restored step {step_r} "
        f"bitwise as saved; every loss ({[s for s, _ in e['losses']]}) bitwise the unfailed run's; "
        f"failure to the first resumed step's start {(resumed[0] - marks['fail']) * 1e3:.1f} ms (the "
        f"in-flight save joined by {(marks['restore'] - marks['fail']) * 1e3:.1f} ms, the restore "
        f"{(marks['restored'] - marks['restore']) * 1e3:.1f} ms), to its end "
        f"{(resumed[1] - marks['fail']) * 1e3:.1f} ms; save calls (step, ms: the async one returns "
        f"after its D2H snapshot, the final one blocks until committed) "
        f"{[(s, round(t * 1e3, 1)) for s, t in marks['saves']]}; the driver's run "
        f"{e['seconds']:.1f} s ({lap():.1f} s)")
    del e, saved, restored

    # (f) the training forward through the flash kernel, gradients off
    pcfg = dataclasses.replace(tcfg, attn_impl="pallas")
    params, _ = st.init_train_state(tcfg, SEED, "cuda")
    batch = train_batch(tcfg, 0)
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        logits, _ = transformer.forward_train(pcfg, params, batch)
    launches = {name: w.launches for name, w in wrappers.items()}
    with torch.no_grad():
        ref_logits, _ = transformer.forward_train(tcfg, params, batch)
    rel = (max_err(logits, ref_logits) / ref_logits.float().abs().max().item())
    log(f"  (f) forward_train under pallas, gradients off: launches {launches}; logits vs the xla "
        f"path's: max |diff| / max |logit| = {rel:.3e} (bound {LOGIT_RTOL})")
    if launches["flash_attention"] != tcfg.n_layers:
        raise SystemExit(f"(f) flash_attention launched {launches['flash_attention']} times, not "
                         f"{tcfg.n_layers}")
    if rel > LOGIT_RTOL:
        raise SystemExit("(f) the kernel path's logits are too far from the plain path's")
    try:
        st.make_grad_step(pcfg)(params, batch)
    except NotImplementedError as err:
        log(f"  (f) with gradients on the step raises: {err}")
    else:
        raise SystemExit("(f) a gradient step through the forward-only flash kernel did not raise")
    del params, logits, ref_logits
    q, k, v = flash_inputs(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, tcfg.n_heads, tcfg.n_kv_heads,
                           tcfg.head_dim)
    err = check_close(f"flash_attention at the training shape {tuple(q.shape)}",
                      flash_attention(q, k, v), attention_ref(q, k, v))
    log(f"  phase 6 done in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches["flash_attention"], "err": err,
            "losses": [loss for _, loss in a["losses"]], "peak": peak}


#: the stream counters phase 6w reads around each step
STREAM_FIELDS = ("h2d_requests", "bytes_h2d", "d2h_requests", "bytes_d2h", "disk_requests",
                 "unique_group_fetches", "cache_hits", "transfer_wait_s", "writeback_drain_s")


def host_bits(tree) -> list:
    """Every leaf of ``tree`` (tensors anywhere, numpy, spill views) as a
    flat CPU byte tensor, in leaf order."""
    from repro_torch.core import tree as tr
    from repro_torch.core.arrays import host_tensor

    return [host_tensor(x).detach().to("cpu", copy=True).reshape(-1).view(torch.uint8)
            for x in tr.leaves(tree)]


def state_bits(state) -> dict:
    return {part: {k: host_bits(t) for k, t in state[part]["groups"].items()}
            for part in ("params", "opt")}


def same_state(state, ref: dict) -> bool:
    """``state``'s parameters and moments bit for bit ``ref``'s (state_bits)."""
    from repro_torch.core import tree as tr
    from repro_torch.core.arrays import host_tensor

    for part in ("params", "opt"):
        for key, leaves in ref[part].items():
            got = tr.leaves(state[part]["groups"][key])
            if len(got) != len(leaves):
                return False
            for x, want in zip(got, leaves):
                t = host_tensor(x).detach()
                if not torch.equal(t.to("cpu").reshape(-1).view(torch.uint8), want):
                    return False
    return True


def phase_train_streamed(cfg, ref: dict, smi: str, device="cuda",
                         budget_mb: float = W_TRAIN_BUDGET_MB, groups: int = W_TRAIN_GROUPS,
                         spill: Path = ROOT / "build" / "spill-6w") -> None:
    """Phase 6w: phase 6's model and batches through the streamed-weight train
    step, the weights, gradients and moments homed on the card, at pinned
    host and on disk under ``budget_mb``, one layer a group."""
    import gc
    import shutil

    from repro_torch.core import schedcheck as sc
    from repro_torch.core import tree as tr
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.spillstore import SpillStore
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    tcfg = train_cfg(cfg)
    plan = WeightStreamPlan(tcfg, st.abstract_params(tcfg), layers_per_group=1,
                            device_budget_mb=budget_mb)
    n, budget = plan.n_groups, plan.device_budget_bytes
    cap = plan.residency_capacity_bytes()
    max_d = plan.max_distance_for_budget(cached_bytes=cap)
    report = sc.analyze_train_schedule(plan, distance=max_d, cache_capacity=cap, spill=True)
    log(f"phase 6w streamed-weight train {tcfg.name} on {smi}: {n} groups (one layer each), "
        f"budget {budget} B, residency cache {cap} B, max distance {max_d}; batch {TRAIN_BATCH}, "
        f"seq {TRAIN_SEQ}\n{report}")
    if n != groups or not report.ok or report.peak_bytes > budget:
        raise SystemExit(f"6w: {n} groups (expected {groups}), schedule ok {report.ok}, "
                         f"analyzed peak {report.peak_bytes} B against the budget {budget} B")
    # the closed-form traffic below holds while the cache can hold the head's
    # home (ln_f) and no other group
    if [g.key for g in plan.groups if plan.group_bytes(g, fetch=False) <= cap] != [
            plan.groups[-1].key]:
        raise SystemExit(f"6w: a {cap} B cache holds other groups than the head's home")
    bwd = list(reversed(plan.groups[1:-1])) + [plan.groups[0]]
    seqs = ([plan.group_bytes(g) for g in plan.groups], [plan.group_bytes(g) for g in bwd])

    def window(d: int) -> int:
        """Peak streamed bytes at distance ``d``: the executor holds groups
        i..i+d in flight."""
        return max(sum(q[i:i + d + 1]) for q in seqs for i in range(len(q)))

    total, head_home = plan.total_param_bytes, plan.head_home_bytes
    pass_bytes = sum(seqs[0]) + sum(seqs[1])

    def expected(kind: str, k: int) -> dict:
        """Step ``k``'s counters at ``kind``: the weight passes, then the
        optimizer pass ({grads, moments} in; {params, moments} out)."""
        if kind == "device":  # every group passes through by reference
            w = dict(h2d_requests=0, bytes_h2d=0, disk_requests=0, unique_group_fetches=0,
                     cache_hits=2 * n - 1)
        else:
            hit = 1 if k else 0  # the head's ln_f, cached from step 0's forward
            w = dict(h2d_requests=2 * n - 1, bytes_h2d=pass_bytes - hit * head_home,
                     disk_requests=(2 * n - hit) if kind == "disk_host" else 0,
                     unique_group_fetches=2 * n - 1, cache_hits=0)
        # one D2H request a leaf: the backward's gradients, then the
        # optimizer's parameters and their master, m and v
        w.update(d2h_requests=sum(leaves[g.key] for g in bwd), bytes_d2h=total - head_home)
        # on the card the head's gradients and moments are both resident
        o = dict(h2d_requests=n - (kind == "device"), d2h_requests=4 * sum(leaves.values()),
                 bytes_d2h=7 * total,
                 bytes_h2d=(total - head_home) + (6 * total if kind != "device" else 0),
                 disk_requests=n if kind == "disk_host" else 0)
        return {"param": w, "opt": o}

    leaves = {k: len(tr.leaves(t)) for k, t in
              plan.init_home(st.abstract_params(tcfg))["groups"].items()}

    t0 = time.perf_counter()
    state0 = st.init_weight_streamed_state(tcfg, plan, SEED, device)
    log(f"  group-wise init of the state at the host: {time.perf_counter() - t0:.1f} s")

    def profiled(step, state, k: int) -> None:
        """One more step under the profiler: the device's kernel and copy
        time against the wall (copies on the engine's stream overlap the
        compute, so the two may sum past the wall)."""
        from repro_torch.launch.profile_serve import _breakdown

        batch = train_batch(tcfg, k, device)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        r = _breakdown(prof, wall, 1, 10_000)
        by: dict = {}
        for kname, c in r["launches_by_kernel"].items():
            by.setdefault("copies" if kname.startswith("Memcpy") else "kernels", [0.0, 0])[1] += c
        for k_ in r["top_kernels"]:
            cls = "copies" if k_["name"].startswith("Memcpy") else "kernels"
            by.setdefault(cls, [0.0, 0])[0] += k_["ms_per_unit"]
        log(f"    profiled step {k}: wall {wall * 1e3:.1f} ms; device kernels "
            f"{by.get('kernels', [0, 0])[0]:.1f} ms ({by.get('kernels', [0, 0])[1]:.0f} launches), "
            f"copies {by.get('copies', [0, 0])[0]:.1f} ms ({by.get('copies', [0, 0])[1]:.0f}); "
            f"1 - kernel ms / wall = {1 - by.get('kernels', [0, 0])[0] / (wall * 1e3):.4f}; top: "
            + "; ".join(f"{k_['ms_per_unit']:.1f} ms x{k_['calls_per_unit']:.0f} {k_['name'][:50]}"
                        for k_ in r["top_kernels"][:6]))

    def run(name: str, kind: str, distance, steps: int, store=None, keep=(),
            profile: bool = False) -> dict:
        gc.collect()  # the last run's state must not count in this one's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = st.make_weight_streamed_train_step(
            tcfg, AdamWConfig(**TRAIN_OPT), plan=plan, param_kind=kind, spill_store=store,
            prefetch=PrefetchSpec(buffer_size=n + 2, distance=distance), device=device)
        t0 = time.perf_counter()
        s = (st.device_weight_streamed_state(plan, state0, device) if kind == "device" else
             st.spill_weight_streamed_state(plan, state0, store) if kind == "disk_host" else
             state0)
        out = dict(name=name, home_s=time.perf_counter() - t0, losses=[], walls=[], steps=[],
                   kept={})
        stats = {"param": step.param_stats, "opt": step.opt_stats}
        try:
            for k in range(steps):
                batch = train_batch(tcfg, k, device)
                before = {w: {f: getattr(s_, f) for f in STREAM_FIELDS} for w, s_ in stats.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, m = step(s, batch)
                out["losses"].append(float(m["loss"]))
                torch.cuda.synchronize()
                out["walls"].append(time.perf_counter() - t0)
                out["steps"].append({w: {f: getattr(s_, f) - before[w][f] for f in STREAM_FIELDS}
                                     for w, s_ in stats.items()})
                if k + 1 in keep:
                    out["kept"][k + 1] = state_bits(s)
            out["state"] = s
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            out["param_stats"], out["residency"] = step.param_stats, step.residency
            out["hits"] = step.residency.hits if step.residency is not None else 0
            if profile:  # after the counters are read: its traffic is not checked
                profiled(step, s, steps)
        finally:
            step.close()
        return out

    def check(r: dict, kind: str, distance, want_state: dict) -> None:
        name = r["name"]
        steps = len(r["losses"])
        if r["losses"] != a["losses"][:steps]:
            raise SystemExit(f"6w {name}: losses {r['losses']} differ from (a)'s {a['losses']}")
        if not same_state(r["state"], want_state):
            raise SystemExit(f"6w {name}: parameters or moments differ from (a)'s after {steps} "
                             "step(s)")
        for k, got in enumerate(r["steps"]):
            want = expected(kind, k)
            for w in ("param", "opt"):
                for f, v in want[w].items():
                    if got[w][f] != v:
                        raise SystemExit(f"6w {name} step {k}: {w} {f} {got[w][f]}, expected {v}")
        ps = r["param_stats"]
        peak = ps.peak_inflight_bytes
        rc = {"hits": r["hits"], "peak_resident_bytes": (
            r["residency"].peak_resident_bytes if r["residency"] is not None else 0)}
        if kind == "device":
            want_peak = 0
        elif distance == "auto":
            want_peak = None
            if not window(1) <= peak <= window(max_d) or max(ps.distance_trace) > max_d:
                raise SystemExit(f"6w {name}: peak streamed {peak} B outside "
                                 f"[{window(1)}, {window(max_d)}] or a distance above {max_d}")
        else:
            want_peak = window(distance)
        if want_peak is not None and peak != want_peak:
            raise SystemExit(f"6w {name}: peak streamed {peak} B, the plan's {want_peak} B")
        held = peak + rc["peak_resident_bytes"]
        if not (peak <= report.peak_bytes <= budget and held <= budget + cap):
            raise SystemExit(f"6w {name}: streamed {peak} B + cached {rc['peak_resident_bytes']} B "
                             f"against the budget {budget} B and the cache {cap} B")
        if kind != "device" and rc["hits"] != steps - 1:
            raise SystemExit(f"6w {name}: {rc['hits']} residency hits, expected {steps - 1}")
        per = r["steps"]
        log(f"  {name}: losses {r['losses']} bitwise (a)'s, parameters and moments too; step walls "
            f"{[round(w * 1e3, 1) for w in r['walls']]} ms; wait "
            f"{[round((x['param']['transfer_wait_s'] + x['opt']['transfer_wait_s']) * 1e3, 1) for x in per]}"
            f" ms, drain "
            f"{[round((x['param']['writeback_drain_s'] + x['opt']['writeback_drain_s']) * 1e3, 1) for x in per]}"
            f" ms a step; H2D {per[-1]['param']['bytes_h2d']:,} + {per[-1]['opt']['bytes_h2d']:,} B "
            f"({per[-1]['param']['h2d_requests']} + {per[-1]['opt']['h2d_requests']} requests), D2H "
            f"{per[-1]['param']['bytes_d2h']:,} + {per[-1]['opt']['bytes_d2h']:,} B, disk "
            f"{per[-1]['param']['disk_requests']} + {per[-1]['opt']['disk_requests']} requests a "
            f"step (weights + optimizer); peak streamed {peak} B (plan: "
            f"{'bounded' if want_peak is None else want_peak}), cached "
            f"{rc['peak_resident_bytes']} B, {rc['hits']} residency hits; max_memory_allocated "
            f"{r['max_memory_allocated']} B against phase 6 (a)'s {ref['peak']} B; home placed in "
            f"{r['home_s']:.1f} s ({smi})")

    # (a) the device home: the bitwise baseline
    a = run("(a) device", "device", "auto", W_TRAIN_STEPS, keep={1, W_TRAIN_STEPS})
    if not math.isclose(a["losses"][0], ref["losses"][0], rel_tol=RTOL, abs_tol=ATOL):
        raise SystemExit(f"6w (a): step-0 loss {a['losses'][0]} not within 2e-2 of phase 6 (a)'s "
                         f"{ref['losses'][0]}")
    log(f"  (a) step-0 loss {a['losses'][0]} against phase 6 (a)'s monolithic "
        f"{ref['losses'][0]} (|diff| {abs(a['losses'][0] - ref['losses'][0]):.3e}); step 1 "
        f"{a['losses'][1]} against {ref['losses'][1]}")
    check(a, "device", "auto", a["kept"][W_TRAIN_STEPS])
    del a["state"]

    # (b) pinned host at distance 0, 1 and auto (last: the pinned buffers the
    # drains allocate are then warm)
    for dist in (0, 1, "auto"):
        r = run(f"(b) pinned_host d={dist}", "pinned_host", dist, W_TRAIN_STEPS,
                profile=dist == "auto")
        check(r, "pinned_host", dist, a["kept"][W_TRAIN_STEPS])
        del r

    # (c) disk, one step: the fsync'd writeback of every group
    shutil.rmtree(spill, ignore_errors=True)
    store = SpillStore(spill)
    try:
        r = run("(c) disk_host", "disk_host", "auto", W_TRAIN_DISK_STEPS, store=store)
        check(r, "disk_host", "auto", a["kept"][W_TRAIN_DISK_STEPS])
        del r
    finally:
        store.close(delete=True)
        shutil.rmtree(spill, ignore_errors=True)
    log(f"  phase 6w done in {time.perf_counter() - t_phase:.1f} s")


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


def phase_times(cfg, hcfg, errs: dict, launches: dict, hlaunches: dict, sweep: list,
                train: dict) -> list:
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
        # phase 6 (f)'s training forward, gradients off
        flash_row(f"{smol} train", TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                  0, train["launches"], train["err"], flush),
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


# phase 7: the paper's tables and the engine studies, through the port's runner
TABLE_SUITES = ["table2", "table1", "engine", "disk"]
HBM_TOLERANCE = 0.10  # H100.hbm_bytes against the card's total memory
#: the one gate phase 7 lets fail, and what removes the exception: the
#: engine's paper-link speedup over the per-leaf schedule is >= 1.20x in the
#: JAX package and read 1.017-1.16x in five runs on the card.  At or below
#: the floor, the lowest reading less the spread of those runs, it is fatal.
ENGINE_GATE_EXCEPTION = "ROADMAP queue 1 item 8"
ENGINE_CARD_FLOOR = 0.9


def phase_tables(smi: str) -> None:
    """Phase 7: Table 2, Table 1, the engine A/B with its pack/link split and
    the disk tier, each at full size on the card through the runner's
    ``run_suites``; every gate and table check fatal."""
    from repro_torch.benchmarks import common as C
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.roofline.hw import H100

    t0 = time.perf_counter()
    log(f"phase 7 the paper's tables on the card ({smi})")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  HwSpec {H100.name}: hbm_bytes {H100.hbm_bytes:,.0f} against the card's "
        f"total_memory {total:,} B ({H100.hbm_bytes / total - 1:+.2%}; {smi})")
    if abs(H100.hbm_bytes - total) > HBM_TOLERANCE * total:
        raise SystemExit(f"phase 7: H100.hbm_bytes is not within 10% of the card's {total} B")
    failed = bench_run.run_suites(TABLE_SUITES, "cuda")

    def rows(name):
        return json.loads((C.RESULTS_DIR / f"{name}.json").read_text())

    by = {(r["link"], r["config"]): r for r in rows("BENCH_engine")}
    eng = by[("paper", "engine")]
    speedup = max(eng["speedup_vs_seed"], eng["speedup_min_vs_seed"])
    reading = (f"{speedup:.3f}x (median {eng['speedup_vs_seed']:.3f}x, min "
               f"{eng['speedup_min_vs_seed']:.3f}x; gate 1.20x, floor {ENGINE_CARD_FLOOR:.2f}x)")
    if "engine" not in failed:
        log(f"  engine: the paper-link gate holds on the card, {reading}: the exception for it "
            f"here can go with {ENGINE_GATE_EXCEPTION} ({smi})")
    else:
        # the engine's request counts must hold (run() has held the values
        # bitwise), and its speedup must stay above the floor
        counts = (by[("real", "engine")]["h2d_requests_per_group"],
                  by[("real", "seed")]["h2d_requests_per_group"])
        if counts != (1.0, 7.0):
            raise SystemExit(f"phase 7: engine requests a group (engine, seed) are {counts}")
        if not speedup > ENGINE_CARD_FLOOR:
            raise SystemExit(f"phase 7: the engine's paper-link speedup is {reading}")
        log(f"  engine: the paper-link speedup gate FAILS on the card, {reading}; reported as "
            f"found until {ENGINE_GATE_EXCEPTION}; requests a group engine 1, seed 7 ({smi})")
        failed = [f for f in failed if f != "engine"]
    if failed:
        raise SystemExit(f"phase 7: gates failed in {failed}")

    t2 = {(r["size"], r["mode"]): r for r in rows("table2_stall")}
    want = {(s, m) for s in (128, 1024, 8192, 262144, 2**20)
            for m in ("on_demand", "prefetch", "on_demand_pageable")}
    if set(t2) != want:
        raise SystemExit(f"phase 7: Table 2 rows {sorted(t2)} are not {sorted(want)}")
    mib = 2**20
    log(f"  Table 2 at 1 MiB, mean stall: on demand pinned {t2[(mib, 'on_demand')]['mean_ms']:.4f} ms, "
        f"pageable {t2[(mib, 'on_demand_pageable')]['mean_ms']:.4f} ms, prefetch "
        f"{t2[(mib, 'prefetch')]['mean_ms']:.4f} ms ({smi})")
    measured = [r for r in rows("table1_power") if r["technology"].startswith("H100 (measured")]
    if sorted((r["n"], r["dtype"]) for r in measured) != [(1024, "f32"), (8192, "bf16"),
                                                          (8192, "f32")]:
        raise SystemExit(f"phase 7: Table 1's measured rows are {measured}")
    for r in measured:
        if not (r["watts"] > 0 and r["gflops"] > 0 and r["n_samples"] >= 20):
            raise SystemExit(f"phase 7: Table 1 row {r['technology']} has no measured watts: {r}")
        log(f"  Table 1 {r['technology']}: {r['gflops']:.1f} GFLOP/s, {r['watts']:.1f} W "
            f"({r['power_field']}, {r['n_samples']} samples, SM {r['sm_mhz']:.0f} MHz, idle "
            f"{r['idle_watts']:.1f} W), {r['gflops_per_watt']:.2f} GFLOP/W ({smi})")
    split = rows("BENCH_engine_split")
    for r in split:
        if not (r["pack_s"] > 0 and r["link_s"] > 0):
            raise SystemExit(f"phase 7: the pack/link split of {r['group']} is not positive: {r}")
        log(f"  pack/link split, {r['group']} ({r['bytes']:,} B, {r['leaves']} leaves, "
            f"{r['per_pass']} a pass): pack "
            f"{r['pack_s'] * 1e3:.4f} ms ({r['pack_GBps']:.2f} GB/s), link {r['link_s'] * 1e3:.4f} ms "
            f"({r['link_GBps']:.2f} GB/s; the bare copy {r['dma_s'] * 1e3:.4f} ms, "
            f"{r['dma_GBps']:.2f} GB/s), packing share {r['pack_share']:.3f}, whole staged "
            f"transfer {r['whole_s'] * 1e3:.4f} ms ({smi})")
    smollm = [r for r in split if r["group"].startswith("smollm-360m")]
    if sum(r["per_pass"] * r["bytes"] for r in smollm) != W_PASS_BYTES:
        raise SystemExit(f"phase 7: the smollm-360m split groups do not make a pass: {smollm}")
    pack, link, whole = (sum(r["per_pass"] * r[k] for r in smollm) for k in ("pack_s", "link_s",
                                                                          "whole_s"))
    log(f"  pack/link split, smollm-360m's pass of {W_GROUPS} groups ({W_PASS_BYTES:,} B), the "
        f"per-group medians summed: pack {pack * 1e3:.3f} ms, link {link * 1e3:.3f} ms, whole "
        f"{whole * 1e3:.3f} ms, packing share {pack / (pack + link):.3f} ({smi})")
    log(f"  phase 7 done in {time.perf_counter() - t0:.1f} s")


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
    from repro_torch.train.steps import init_params

    params = init_params(cfg, SEED, "cuda")  # phases 2 and 2p share them
    res, launches = phase_serve(cfg, PROMPT, "2", ("flash_attention", "decode_attention"),
                                params=params)
    phase_paged(cfg, params, res, launches)
    phase_streamed(cfg, params, res, launches)
    del params
    phase_check(cfg, res, PROMPT, "3")
    del res
    hres, hlaunches = phase_serve(hcfg, HYB_PROMPT, "2b",
                                  ("rglru_scan", "flash_attention", "decode_attention"))
    phase_check(hcfg, hres, HYB_PROMPT, "3b")
    del hres
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    launches["streamed_matmul"], sweep = phase_paper(cfg)
    train = phase_train(cfg)
    phase_train_streamed(cfg, train, smi)
    rows = phase_times(cfg, hcfg, errs, launches, hlaunches, sweep, train)
    phase_tables(smi)
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
