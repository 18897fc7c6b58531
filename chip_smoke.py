#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (dense, hybrid, MoE, xLSTM and
audio codebooks), the paper's offload path, training (dense, xLSTM, MoE,
audio and vision-language, with the weights on the card and streamed from
the host or disk) and the paper's tables on one NVIDIA card.

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
   query heads per KV head and a window, and at mixtral-8x7b's prefill
   (batch 2, prompt 512, 32 heads over 8, window 4096) and decode (its
   520-slot ring), at musicgen-medium's prefill and decode (24 heads over
   24 KV heads, head_dim 64) and at qwen2-vl-72b's training forward (1152
   positions, 64 heads over 8, head_dim 128); both at qwen3-moe-235b-a22b's
   64 heads over 4 (16 a KV head, the top of both contracts: flash's
   prefill at batch 2 and 1, and at 300 positions with a q_offset of 20;
   decode over its 520 slots at lengths (520, 517) and (1, 0)) and at the
   dense configs' one-request prefill and decode, head_dim 128: olmo-1b's
   16 over 16, minitron-4b's 24 over 8, internlm2-20b's 48 over 8; the
   attention kernels also at the
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
   slots sharing a 256-token prefix at pinned host, gen 8 (32 until phase
   8c, 16 until 2q and 2d), with and without
   copy-on-write sharing: the same tokens, shared hits, fewer H2D bytes;
   (e) the load generator's bursty trace (prompts 128/256/512, outputs
   4/8/16, a 64-token shared prefix, steady phases of 1 s; 8/16/32 and 4 s
   until phase 8c, 2 s until its (e)-(g)) through the SLO scheduler at pinned
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
   logged beside phase 2's; (b) the same at disk, gen 4 (8 until 2q and 2d); (c) the paged
   session at pinned-host pages and weights under 176 MB (the hot window's
   cut first): tokens bitwise, the schedule verified; (d) no budget, then
   ``param_cache_mb=0``, gen 4: 0 and all groups fetched each decode step;
   (e) (a) under the hazard sanitizer, gen 4 (32 until phase 8c, 8 until 2q and 2d), bitwise,
   and a 100 MB budget (under
   the distance-1 floor) refused before any thread exists;
2m. serve full-width mixtral-8x7b (d_model 4096, 32 heads over 8, head_dim
   128, 8 experts of d_ff 14336 top-2, window 4096, bf16; random weights
   from seed 0) through ``serve`` with ``attn_impl="pallas"``: batch 2,
   prompt 512, gen 8 (16 until phase 8c), unpaged, each run with the launch
   counts zeroed just
   before and read just after and the decode routing recorded: (a) 4
   layers on the card (6.07 B parameters), the bitwise baseline; its
   prefill logits and first decode step within 5e-2 of the plain
   attention path's, the routing decisions that differ counted; (b) the same
   4 layers with ``expert_stream=True`` at pinned host under 9,000 MB (above
   the plan's distance-1 floor of three MoE units, 8,707,620,864 bytes),
   routed, at distance 1 (``param_cache_mb=0``) and ``auto`` (the default
   cache, too small for an expert group; distance 0 too until phases 2q and
   2d took its time); (c) all experts (``route_experts=False``), auto, gen
   2 (8 until phase 8c, 4 until 2q and 2d); (d) disk, routed, gen 2 (4
   until 2q and 2d), spilled under
   ``build/spill-moe/`` (deleted after); (e) 4 layers (12.1 GB; all 32,
   93.41 GB, more than the card, ran here until phases 2x, 6x and 6m took
   their time, 16 until 2a, 6a and 6v, 8 until 8c), routed, gen 4, at
   pinned host,
   initialized group by
   group, run after (f0) and before any spill, and refused before it starts
   unless the host's MemAvailable holds the home with 3 GB to spare; (f)
   the paged ``ServeSession`` at pinned-host pages with (b)'s weights and
   routed experts, against (f0), the same session with the weights on the
   card (mixtral's ring does not page, and at 520 positions its window
   never binds, so the session serves the same weights with full
   attention).  Gates: (b), (c), (d) tokens bitwise (a)'s, (f) (f0)'s; one
   H2D request a fetched group; every expert request and byte the recorded
   routing's distinct experts times the plan's expert group, and at
   ``param_cache_mb=0`` every pipeline request and byte the plan's; streamed
   plus cached bytes within the analyzer's peak and the budget; routed
   expert bytes a layer a decode step at most half (c)'s, (e) too;
2q. serve full-width qwen3-moe-235b-a22b (d_model 4096, 64 heads over 4,
   head_dim 128, qk-norm, 128 experts of d_ff 1536 top-8, vocab 151,936,
   untied; random weights from seed 0) cut to 4 of its 94 layers (11.2 B
   parameters, 22.4 GB) through ``serve`` with ``attn_impl="pallas"`` at
   2m's batch 2, prompt 512 and gen 8, unpaged, the launch counts zeroed
   just before and read just after each run and the decode routing
   recorded: (a) on the card, the weights built group by group there
   (``init_params``; the init's peak allocation under the weights plus
   twice the larger f32 unit, a layer or the shell), flash and decode
   launched, its peak allocation against the weights', its prefill logits
   and first decode step within 5e-2 of the plain attention path's with
   the plain path's routing held (the free-routing difference and the
   routing flips logged beside: among 128 experts top-8 a flipped near tie
   swaps an expert); (b) the experts routed from a pinned-host home built
   group by group (``init_weight_streamed_params``, refused unless
   MemAvailable holds it with 3 GB to spare) under the plan's distance-1
   floor rounded up to 10 MB, so the cache is smaller than one 37.7 MB
   expert group, the schedule verified first; distance auto, 4 decode
   steps: tokens bitwise (a)'s, every request and byte the plan's and the
   routing's (2m's count check), at most 16 experts (top-8 x batch 2),
   0.125 of the plan's all-expert bytes, a layer a decode step;
2d. serve full-width olmo-1b (16 layers, d_model 2048, 16 heads over 16),
   minitron-4b (32 layers, d_model 3072, 24 over 8, vocab 256,000, untied)
   and internlm2-20b (48 layers, d_model 6144, 48 over 8; 19.86 B
   parameters, 39.7 GB), all at head_dim 128 and full depth, one after
   another, each built group by group on the card (its init's peak held as
   2q's) and freed before the next: phase 2's batch, prompt and gen,
   unpaged device caches, flash and decode launched, a ``roofline`` line;
   then its tokens checked and the kernel path's logits held to the plain
   path's at 2 layers (phase 3's check);
3. check the output: shapes, token range, finite logits, and the kernel
   path's logits against the plain path's (``attn_impl="xla"``) on the same
   full-width model and prompt;
2b. serve full-width recurrentgemma-2b (26 layers, random bf16 weights from
   seed 0) the same way in lock-step: batch 4, prompt 3072 (longer than its
   2048 window, so prefill places the ring and decode wraps it), gen 32;
   ``rglru_scan``, ``flash_attention`` and ``decode_attention`` must all
   have been launched;
3b. check its output as in phase 3, on one 3072-token prompt;
2x. serve full-width xlstm-1.3b (48 layers: 6 periods of 7 mLSTM and an
   sLSTM; d_model 2048, 4 heads of 512, vocab 50,304, tied; 1,741,275,472
   parameters, bf16, random weights from seed 0) cut to 24 layers, 3
   periods (all 48 until phases 2q and 2d took the time), in lock-step through
   ``serve``: batch 4, prompt 512 (4 chunks of 128), gen 32, twice, the
   launch counts zeroed just before and read just after each (no
   hand-written kernel is on this path, as none is in the JAX package's):
   the tokens of the two runs bitwise equal; (b) a prefill of 384 tokens and
   128 decode steps against a prefill of 512, the last logits within 5e-2 of
   the largest; (c) layer 0's mLSTM cell at full width in f32, the chunkwise
   form against the sequential one (rtol 2e-4, atol 2e-3), outputs and
   final states; (d) the batch's prefill and one decode step under the
   profiler (the card alone): device busy against the unprofiled wall,
   idle share, launches (``profile_serve --arch xlstm-1.3b`` is
   :func:`phase_xlstm_profile`'s, which ``main`` skips);
2a. serve full-width musicgen-medium (48 layers, d_model 1536, 24 heads
   over 24, d_ff 6144, 4 codebooks of 2048, sinusoidal positions; 1.38 B
   parameters, bf16, random weights from seed 0) through ``serve`` at batch
   4, prompt 512, gen 32, each run with the launch counts zeroed just
   before and read just after: (a) unpaged, device caches, the baseline,
   its prefill logits (1, 4, 1, 2048) and first decode step within 5e-2
   of the plain attention path's and its first token that prefill's; (b)
   the paged session at device, pinned-host and disk pages (the pinned
   run's gen 8, 32 until 2q and 2d; the disk run's gen 2: 32 until phase
   8c, 4 until 2q and 2d), tokens bitwise (a)'s, one
   H2D request a fetched page group; (c) the weights homed at
   pinned host (gen 8; 32 until phase 8c's (e)-(g)), then disk (gen 2; 4
   until 2q and 2d),
   streamed one pass a prefill or step
   under the one-layer plan's distance-1 floor rounded up to 100 MB with
   the residency cache off: tokens bitwise (a)'s, every request and byte
   the plan's (the codebook heads' group reads the embedding's);
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
   the serving paths' shapes (mixtral's from phase 2m (a), qwen3-moe's from
   2q (a), internlm2-20b's from 2d) and
   ``streamed_matmul`` on both routes (the
   MLP in bf16, the sweep's 512³ in f32), beside the least time the card
   could take (bytes at 3.35 TB/s; FLOPs at 989 TFLOP/s bf16 on the tensor
   cores, or 67 TFLOP/s f32 on the CUDA cores); it also logs the host time
   of one call of each serving-path wrapper, ``streamed_matmul`` by ring
   depth on both routes, listing 4's product beside ``torch.matmul``, and
   phase 4's kernel sweep by ring.

6. train full-width smollm-360m (361,821,120 parameters, bf16, random
   weights from seed 0, ``attn_impl="xla"``, ``remat="full"``, loss chunks of
   512; batch 8, sequence 1024, AdamW with peak lr 1e-3, 2 warmup steps, 6
   total, 8 until phases 2q and 2d) through the launcher's ``build_trainer``: (a)'s first run and
   (e) through its driver's ``run()`` (checkpoints included), the others
   through the same trainer's state, loader and step: (a) the AdamW state
   on the card, 8 steps, twice from the same init (finite losses, the
   second run bitwise the first); the step wall (median of steps 2-7),
   tokens/s, model FLOP/s (``model_flops``: 6 N T) and its share of 989
   TFLOP/s, ``max_memory_allocated``, and one profiled step's device busy
   time, idle share, launches and top kernels;
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
6dry. right after 6 (a): 6 (a)'s step lowered on the meta device by the
   dry-run (``launch/dryrun.py::lower_step``, no mesh: the one-card
   program, the config as 6 (a) runs it; nothing is allocated and no
   kernel runs) and held against one step of (a) on the card: the
   dry-run's ``argument_size_in_bytes`` equal to the bytes the step's
   parameters, AdamW state and batch occupy on the card, exactly, and
   its ``argument + output + temp - alias`` within 15% of the step's
   measured peak of allocated bytes (net of what the card held before the
   step but for those arguments); its FLOPs, ``model_flops_ratio`` and the
   FLOP/s they give over (a)'s measured wall logged beside (a)'s
   ``roofline`` line, with the card's name and power limit.
6w. train the same model on phase 6's batches through the streamed-weight
   train step (``make_weight_streamed_train_step``), the weights, gradients
   and AdamW moments homed off the card under ``device_budget_mb=160``, one
   layer a group (34 groups), from the group-wise init (no whole model on
   the card), the schedule analyzed first: (a) the device home, 2 steps,
   its step-0 loss within 2e-2 of phase 6 (a)'s; (b) pinned host, 1 step
   at distance 1 (and 0 until phases 2q and 2d) and 2 at ``auto``; (c) disk (``wp/`` and ``wopt/``
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
6x. train full-width xlstm-1.3b at phase 6's batch and AdamW settings, at
   sequence 512 (phase 6's 1024 until phases 2q and 2d took the time; the
   loss still falls within 3 steps): (a) the state on the card, 3 steps
   through ``build_trainer``,
   finite and falling losses, the step wall, tokens/s, model FLOP/s and
   ``max_memory_allocated`` (one profiled step and the sLSTM loop's part of
   it are :func:`phase_xlstm_profile`'s, which ``main`` skips: profiling
   ~770,000 launches takes minutes); (b) the streamed-weight step on the
   period layout, cut to 24 layers (5 groups: embed, 3 periods of 7 mLSTM
   and an sLSTM, head; 48 layers and 2 steps a home until phases 2a, 6a and
   6v) under a budget of its distance-1 floor rounded up to 100 MB, 1 step
   at the device home, then 1 at pinned host (distance
   auto): losses, parameters and moments bitwise, every request and byte
   of the weight passes and the optimizer pass the plan's, one H2D request
   a fetched group; walls, tokens/s, waits, drains and peak memory logged.
   Runs right after 6m, in 6m's child process.
6m. train full-width mixtral-8x7b (d_model 4096, 32 heads over 8, 8 experts
   of d_ff 14336 top-2; cut to one layer, 1,713,418,240 parameters) with
   ``expert_stream=True`` (a non-expert group and 8 expert groups of
   352,321,536 bytes), batch 2, sequence 512, 1 step at the device home
   and 1 at pinned host with the residency cache off, so every group is
   fetched in both passes: losses, parameters and moments bitwise, every
   request and byte the plan's (each expert group's bytes twice a step),
   one H2D request a fetched group.  Runs right after 6v, in a child
   process with 6x and 6a after it (its host memory goes back when the
   child exits: the later phases leave the host's MemAvailable low; the
   child logs MemAvailable before each phase), and refuses to start unless
   the host holds two homes of weights and moments with 3 GB to spare.  The disk
   home of this step is held on the CPU (tests/test_torch_moe_train.py).
6a. train full-width musicgen-medium at phase 6's batch, sequence and AdamW
   settings: (a) the state on the card, 4 steps, finite losses, the step
   wall, tokens/s, model FLOP/s, one profiled step's idle share and
   ``max_memory_allocated``; (b) the streamed-weight step cut to 12 layers
   (24 until phase 8c; 14 groups, one layer each, under the distance-1
   floor rounded up to 100 MB, the residency cache off) 1 step at the
   device home and 1 at pinned host: losses, parameters and moments bitwise, every request and
   byte the plan's, the step-0 loss bitwise the monolithic ``lm_loss`` on
   the same weights.  Runs after 6x, in 6m's child process.
6v. full-width qwen2-vl-72b (d_model 8192, 64 heads over 8, head_dim 128,
   d_ff 29568, vocab 152,064, M-RoPE sections (16, 24, 24), qkv bias,
   untied) on one sequence of 1024 text positions behind a 128-position
   vision prefix: (a) 2 layers on the card (4.3 B parameters), ``lm_loss``
   and the logits with no gradients through ``flash_attention`` (a launch
   a layer each, zeroed just before and read just after) within 5e-2 of the
   plain path, the prefix's targets ignored; (b) 1 layer (3.44 B
   parameters) through one streamed-weight step at the pinned-host home if
   MemAvailable holds it (the home, the largest group's state, the
   gradients and 8 GB; the step donates its state, so the old and new
   homes overlap by one group), else at disk: its loss bitwise the
   monolithic ``lm_loss`` on the same weights, every request and byte the
   plan's, on demand with the cache off.  Runs first, in a child process.
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

8s. the sharding plan on one card (``repro_torch.parallel``,
   ``repro_torch.launch.mesh``): a one-rank NCCL group over a
   ``HashStore``, ``make_local_mesh()`` on ``cuda``; phase 2's weights
   (smollm-360m, seed 0) placed as DTensors by the train plan's
   ``param_specs``, every local shard bitwise its source;
   ``sharding_report``'s per-device bytes equal to the tree's; the
   Sharder's ``block`` (its gradient through autograd), ``acts`` and
   ``grads`` over layer 0, values bitwise unchanged; the group destroyed.
8c. the sharding plan's consumers on a one-rank NCCL mesh ``(data 1,
   model 1)``, in a child process started as ``torchrun --standalone
   --nproc-per-node 1`` (the launchers' ``init_from_env``,
   ``elastic_local_mesh``), full-width smollm-360m from seed 0: (a) two
   train steps at batch 8 x 1024 through ``build_trainer(mesh=...)``
   (params and AdamW moments DTensors by the train plan, the Sharder in the
   layer body) in lock-step with the same two steps without a mesh: losses,
   parameters and moments bitwise after each step; the step-1 state
   checkpointed (the mesh fingerprint in its meta) and restored, its step 2
   bitwise; the step walls and the kernel launches of a step beside the
   no-mesh ones; (b) one streamed-weight step at pinned host under 160 MB
   (34 groups) with the train plan's ``param_shardings``: every group
   staged through ``ShardedGroupLayout``, the loss phase 6w's bits, its
   H2D requests 6w's (one a (rank, group)); (c) ``serve`` through the
   paged ``ServeSession`` with the serve plan (pinned-host pages of 32,
   batch 4, prompt 512, gen 8): the tokens phase 2p's pinned run's over the
   same steps, ``flash_attention`` and ``decode_attention`` launched on the
   local shards as often a step as there; (d) ``--model-parallel 2`` on
   the one card, both launchers at smoke size in parallel processes
   (started before the build, read after phase 1; both time nothing):
   ``train`` degrades with the warning and exits 0, ``serve`` exits 2 with
   the divisibility reason; (e) full-width mixtral-8x7b cut to one layer
   (1.71 B parameters, 8 experts of d_ff 14336 top-2) trained two steps at
   batch 2 x 512 through ``build_trainer(mesh=...)`` under
   ``moe_impl="sorted_ep"`` (each rank's experts on its capacity buffer,
   the partial outputs summed over ``model``): finite losses, the step
   walls, kernel launches and peak memory logged, ``moe_sorted_ep`` reached
   and the dispatch not; the layer's ``y`` and ``aux`` bitwise
   ``moe_sorted_local`` on full tensors without a mesh; at a capacity
   factor of ``n_experts / top_k`` (nothing can drop) the step's loss
   within 2e-2 of the same step under ``moe_impl="dispatch"``; (f)
   ``pod_allreduce_int8`` over the one-rank ``data`` group on the
   gradients of (a)'s grad step: ``out + err`` within 1e-5 of each gradient
   and ``out`` bitwise the codec's round trip ``q * s`` at the rank's own
   scale; (g) the ``shard`` suite's body in place on the child's group
   (one request a (rank, group), the per-leaf schedule's 13 a group, a
   steady-wait collapse of at least 2x, bitwise equal to eager sharded
   placement).

Every full-width step wall of phases 2, 2b, 2m (a), 2q (a), 2d, 2x, 2a (prefill a
request, or the lock-step batch, and the mean decode step), 6 (a), 6x (a),
6a (a) (the median train step) and 6v (a) (the kernel path's ``lm_loss``,
no gradients) is read against the JAX package's analytic roofline on the
port's ``H100`` (``roofline_line``): a ``roofline`` line with
``model_flops`` (6 N T or 2 N T over the config's active parameters, its
depth cut included), ``analytic_hbm_bytes`` on one device,
``residual_inner_scan_flops``, the compute and memory terms (the compute
term's FLOPs are the analytic ones plus the residual; phase 6dry counts
6 (a)'s lowered step beside them), the dominant term, ``mfu`` (model
FLOPs over 989 TFLOP/s and the wall) and ``bound_share`` (the dominant
term over the wall; the bytes count the plain attention's (B, S, S)
scores, which the flash kernel never writes, so a share above 1 is logged
as found, not failed).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

from typing import Optional

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
#: (d)'s generation (the session's 32 until phase 8c needed the time, 16
#: until phases 2q and 2d did)
SHARED_GEN = 8
#: (e)'s trace: its output lengths the load generator's defaults, its phases
#: (seconds, requests a second) steady, burst, steady ((8, 16, 32) and steady
#: phases of 4 s until phase 8c needed the time, 2 s until its (e)-(g) did:
#: 18 requests, 4 of them in the first phase)
LG_PROMPTS, LG_GENS, LG_SHARED = (128, 256, 512), (4, 8, 16), 64
LG_PHASES = ((1.0, 2.0), (1.0, 8.0), (1.0, 2.0))
# phase 2w: the weights streamed under 160 MB (34 groups, 818,014,080 bytes a
# pass: the tied head re-reads the embedding); the paged session's 176 MB
# leaves the same ~160 MB once the hot window (15.7 MB) is cut; a budget under
# the distance-1 floor; the disk, residency and sanitized runs' shorter
# generation (8 until phases 2q and 2d needed the time)
W_BUDGET_MB, W_PAGED_BUDGET_MB, W_FLOOR_MB = 160, 176, 100
W_GROUPS, W_PASS_BYTES, W_SHORT_GEN = 34, 818_014_080, 4
# phase 2m: full-width mixtral-8x7b, cut to 4 layers for the runs that have a
# device-resident twin; the budget above the expert plan's distance-1 floor
# (three MoE units, 8,707,620,864 bytes) with a residency cache (292 MB) that
# holds no expert group (352,321,536 bytes); the all-expert and disk runs'
# and the whole model's shorter generation (the first two's 4 until phases
# 2q and 2d needed the time); the deep run's depth (4 of 32 layers, drawn
# and homed apart from (a)'s: the whole model's 93.4 GB ran until phases 2x,
# 6x and 6m needed the time, 16 layers until phases 2a, 6a and 6v did, 8
# until phase 8c did) and
# the host memory it must leave free (the H100 host this was sized on:
# MemTotal 105,906,176 kB, 80.2 GB of free disk); the runs' generation (16
# until phase 8c needed the time: the ring and the kernels' decode shape are
# prompt + gen, 520 slots)
MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 2, 512, 8
MOE_BUDGET_MB, MOE_DISK_GEN, MOE_FULL_GEN = 9000, 2, 4
MOE_FULL_LAYERS, MOE_HOST_MARGIN = 4, 3_000_000_000
# phase 2q: full-width qwen3-moe-235b-a22b (64 heads over 4, 128 experts of
# d_ff 1536 top-8, qk-norm) cut to 4 of its 94 layers, served at 2m's batch,
# prompt and gen; (b) routes the experts from a pinned-host home under the
# plan's distance-1 floor rounded up to 10 MB (so the residency cache stays
# smaller than one 37.7 MB expert group), 4 decode steps, where a layer's
# routed step may fetch at most top-8 x batch 2 = 16 of its 128 experts
Q_ARCH, Q_LAYERS, Q_STREAM_GEN, Q_BUDGET_ROUND, Q_EXPERT_SHARE = (
    "qwen3-moe-235b-a22b", 4, 5, 10_000_000, 0.125)
# phase 2d: the dense configs served at full width and depth, each one's
# kernel-vs-plain logit check at 2 layers
DENSE_ARCHS, DENSE_CHECK_LAYERS = ("olmo-1b", "minitron-4b", "internlm2-20b"), 2
# the recurrentgemma-2b cell: a prompt longer than the 2048-token window
HYB_PROMPT = 3072
# phase 2x: full-width xlstm-1.3b served (a prompt of 4 mLSTM chunks); phase
# 6x: trained at phase 6's batch and sequence (3 steps; 4 until phases 2a, 6a
# and 6v needed the time; at 24 layers its loss does not fall within 4), then
# streamed 1 step a home cut to 3 of its 6 periods (all 48 layers and 2
# steps a home before then; at 2 periods the budget of its floor would hold
# the whole model)
XL_BATCH, XL_PROMPT, XL_GEN, XL_PARAMS = 4, 512, 32, 1_741_275_472
#: phase 2x's depth: 3 of the 6 periods (all 48 layers until phases 2q and
#: 2d needed the time; its prefill, decode and profiled steps are host-bound,
#: so its time follows the layer count)
XL_SERVE_LAYERS = 24
XL_TRAIN_STEPS, XL_W_LAYERS, XL_W_STEPS = 3, 24, 1
#: 6x's sequence (phase 6's 1024 until phases 2q and 2d needed the time: its
#: steps are host-bound on the sLSTM loop, one pass of it a position)
XL_SEQ = 512
# phase 2a: full-width musicgen-medium served at phase 2's batch, prompt and
# gen (the disk-homed weights' run at a shorter gen); phase 6a: trained at
# phase 6's batch and sequence, AdamW on the card for 4 steps, then the
# streamed-weight step 1 step a home (2 until phase 8c needed the time), cut
# to 12 of its 48 layers (24 until phase 8c needed the time); the disk-homed
# pages' and weights' runs at a shorter gen (4 until phases 2q and 2d needed
# the time), and the pinned-host weights' and pages' runs too (phase 2's 32
# until phase 8c's (e)-(g) needed the time; the pages' until 2q and 2d did)
AU_DISK_GEN, AU_TRAIN_STEPS, AU_W_LAYERS, AU_W_STEPS = 2, 4, 12, 1
AU_W_GEN = 8
# phase 6v: full-width qwen2-vl-72b cut to 2 layers for the no-gradient
# forward and to 1 for the streamed-weight step (whose home, 14 B a
# parameter, is 48 GB); one sequence of 1024 text positions behind its
# 128-position vision prefix; the host memory the chosen home leaves free
VL_LAYERS, VL_W_LAYERS, VL_BATCH, VL_TEXT = 2, 1, 1, 1024
VL_HOST_MARGIN = 8_000_000_000
# phase 6m: full-width mixtral-8x7b trained with its experts streamed, cut to
# one layer: the streamed step holds a home's old and new state until it
# returns, so the device home needs twice its 16 B a parameter on the card
# (~55 GB at one layer; two layers, 3.16 B parameters, would need ~101 GB)
MT_LAYERS, MT_BATCH, MT_SEQ, MT_STEPS = 1, 2, 512, 1
# phase 6: full-width smollm-360m training at the JAX package's train defaults
# (remat "full", loss chunks of 512 positions), its AdamW settings; the
# streamed optimizer's groups; the DISK_OPT host budget and its steps; the
# failure the driver recovers from.  6 steps a run (8 until phases 2q and 2d
# needed the time)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PARAMS = 8, 1024, 6, 361_821_120
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_GROUPS, TRAIN_STATE_BYTES = 4, 4_341_853_440  # 12 bytes a parameter
# (d) takes one step: its fsync'd disk writes cost ~10-15 s a step, and
# phase 6 keeps within ~110 s (the CPU tests hold several disk steps)
TRAIN_HOST_MB, TRAIN_DISK_STEPS = 2000, 1
#: phase 6dry: the dry-run's peak against the measured step's, relative
DRYRUN_PEAK_BAND = 0.15
TRAIN_FAIL_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 4, 3, 2
# phase 6w: phase 6's model and batches through the streamed-weight train step
# under 160 MB, one layer a group (34 groups); the steps of each run (the disk
# run's fsync'd writeback of ~5.8 GB costs ~10-20 s a step, so it takes one);
# the pinned-host runs' distances (0 too until phases 2q and 2d needed the
# time)
W_TRAIN_BUDGET_MB, W_TRAIN_GROUPS, W_TRAIN_STEPS, W_TRAIN_DISK_STEPS = 160, 34, 2, 1
W_TRAIN_DISTANCES = (1, "auto")
# phase 8c: its gen and train steps; it reads what phases 2p and 6w wrote: the tokens and launches of the
# pinned-host paged run, and 6w's first loss and step-0 request counts
P2_RESULT = ROOT / "build" / "phase-2p.json"
W6_RESULT = ROOT / "build" / "phase-6w.json"
MESH_GEN, MESH_TRAIN_STEPS = 8, 2
# phase 8c (e): full-width mixtral-8x7b cut to one layer, trained under
# moe_impl="sorted_ep" at phase 6m's batch and sequence; (f): the int8
# all-reduce's reconstruction tolerance (tests/test_runtime.py's)
EP_LAYERS, EP_STEPS, GC_TOL = 1, 2, dict(rtol=1e-5, atol=1e-5)
#: the torchrun environment a child must not inherit (its own launches open
#: no group)
TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "ROLE_RANK", "ROLE_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "TORCHELASTIC_RUN_ID", "TORCHELASTIC_RESTART_COUNT",
                 "TORCHELASTIC_MAX_RESTARTS", "TORCHELASTIC_USE_AGENT_STORE",
                 "TORCHELASTIC_ERROR_FILE", "TORCH_NCCL_ASYNC_ERROR_HANDLING", "GROUP_WORLD_SIZE",
                 "ROLE_NAME")
# the JAX package's rglru_scan test shapes (tests/test_rglru_kernel.py)
LRU_SHAPES = [(2, 128, 256), (1, 64, 128), (3, 100, 130), (2, 8, 512), (1, 256, 64)]
LRU_TILINGS = [(8, 128), (64, 128), (128, 256)]


def write_p2_result(res: dict, launches: dict) -> None:
    """Phase 2p's pinned-host paged run, as phase 8c (c) reads it."""
    P2_RESULT.write_text(json.dumps({
        "generated": res["generated"].tolist(), "launches": launches,
        "n_steps": res["n_steps"], "decode_step_ms": res["decode_s"] * 1e3 / res["n_steps"]}))


def write_w6_result(loss: float, wall: float, groups: int, h2d: dict) -> None:
    """Phase 6w's first pinned-host step, as phase 8c (b) reads it."""
    W6_RESULT.write_text(json.dumps({"loss": loss, "wall": wall, "groups": groups, "h2d": h2d}))


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
    from repro_torch.configs import get_config
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    log("phase 1 kernels vs plain versions on the card")
    errs = {}
    # the serving path's shapes first, then edges of the wrappers' contract;
    # a named case's error goes to phase 5's row of that cell
    qc = get_config(Q_ARCH)
    qn, qk_ = qc.n_heads, qc.n_kv_heads
    dn = {a: (get_config(a).n_heads, get_config(a).n_kv_heads) for a in DENSE_ARCHS}
    flash_cases = [
        ("flash_attention", (1, PROMPT, PROMPT, n, kh, h, 0, 0)),
        (None, (2, 100, 100, 4, 4, 64, 0, 0)),
        (None, (1, 256, 256, 4, 2, 64, 64, 0)),
        (None, (2, 64, 192, 4, 2, 64, 0, 128)),
        (None, (1, 128, 128, 4, 2, 128, 0, 0)),
        (None, (1, 300, 300, 8, 8, 128, 100, 0)),
        (None, (2, 300, 300, 8, 1, 128, 100, 20)),
        # mixtral-8x7b's prefill: head_dim 128, 4 query heads a KV head, window 4096
        ("flash_attention_moe", (MOE_BATCH, MOE_PROMPT, MOE_PROMPT, 32, 8, 128, 4096, 0)),
        # musicgen-medium's prefill (one request): 24 heads over 24 KV heads, head_dim 64
        ("flash_attention_audio", (1, PROMPT, PROMPT, 24, 24, 64, 0, 0)),
        # qwen2-vl-72b's training forward: 1024 text + 128 vision positions, 64 over 8
        ("flash_attention_vlm", (VL_BATCH, VL_TEXT + VL_TEXT // 8, VL_TEXT + VL_TEXT // 8, 64, 8,
                                 128, 0, 0)),
        # qwen3-moe-235b-a22b's prefill, 64 heads over 4 (G 16, the top of
        # both kernels' contracts: a warpgroup's 64 rows hold 4 queries):
        # both requests in one call, one request (the path's), a q_offset
        (None, (MOE_BATCH, MOE_PROMPT, MOE_PROMPT, qn, qk_, 128, 0, 0)),
        ("flash_attention_qwen3", (1, MOE_PROMPT, MOE_PROMPT, qn, qk_, 128, 0, 0)),
        (None, (1, 300, 300, qn, qk_, 128, 0, 20)),
    ] + [  # phase 2d's prefills (one request): G 1, 6 and 3 at head_dim 128
        (f"flash_attention_{a}", (1, PROMPT, PROMPT, nn, kk, 128, 0, 0))
        for a, (nn, kk) in dn.items()]
    for name, (b, s, t, nn, kk, hh, window, qo) in flash_cases:
        q, k, v = flash_inputs(b, s, t, nn, kk, hh)
        out = flash_attention(q, k, v, window=window, q_offset=qo)
        ref = attention_ref(q, k, v, window=window, q_offset=qo)
        err = check_close(f"flash_attention B={b} S={s} T={t} N={nn} KH={kk} H={hh} "
                          f"window={window} q_offset={qo}", out, ref)
        if name:
            errs[name] = err
    t = PROMPT + GEN
    tm = MOE_PROMPT + MOE_GEN  # mixtral's ring: min(window, context) slots; qwen3's cache
    decode_cases = [
        ("decode_attention", (BATCH, t, n, kh, h, [t, 300, 77, 1])),
        (None, (2, 1024, 8, 2, 64, [1, 777])),
        (None, (1, 300, 4, 1, 128, [300])),
        (None, (2, 256, 10, 5, 64, [0, 129])),
        ("decode_attention_moe", (MOE_BATCH, tm, 32, 8, 128, [tm, tm - 3])),
        # musicgen-medium's decode: 24 heads over 24 KV heads, head_dim 64
        ("decode_attention_audio", (BATCH, t, 24, 24, 64, [t, t - 1, 300, 1])),
        # qwen3-moe-235b-a22b's decode, G 16: the mma A tile's 16 rows all
        # heads, no padding row; then a row of one key beside an empty one
        ("decode_attention_qwen3", (MOE_BATCH, tm, qn, qk_, 128, [tm, tm - 3])),
        (None, (MOE_BATCH, tm, qn, qk_, 128, [1, 0])),
    ] + [  # phase 2d's decode: G 1, 6 and 3 at head_dim 128
        (f"decode_attention_{a}", (BATCH, t, nn, kk, 128, [t, t - 1, 300, 1]))
        for a, (nn, kk) in dn.items()]
    for i, (name, (b, tt, nn, kk, hh, lens)) in enumerate(decode_cases):
        q, k, v, lengths = decode_inputs(b, tt, nn, kk, hh, lens)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        err = check_close(f"decode_attention B={b} T={tt} N={nn} KH={kk} H={hh} lengths={lens}",
                          out, ref)
        if i == 0:
            specs = [PrefetchSpec(1, 1, 0), PrefetchSpec(2, 1, 1), PrefetchSpec(4, 1, 3)]
            outs = [decode_attention(q, k, v, lengths, spec=sp) for sp in specs]
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            log(f"  decode_attention bitwise equal across {[(s.buffer_size, s.distance) for s in specs]}"
                f" (buffer_size, distance): {same}")
            if not same:
                raise SystemExit("decode_attention: value depends on the PrefetchSpec")
        if name:
            errs[name] = err
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


def roofline_line(phase: str, cfg, kind: str, seq: int, batch: int, wall_s: float,
                  smi: str) -> float:
    """Read one full-width step's measured wall against the JAX package's
    analytic roofline on the port's ``H100`` (``repro_torch.roofline``):
    ``model_flops``, ``analytic_hbm_bytes`` on one device and
    ``residual_inner_scan_flops``; the terms of a ``RooflineResult`` whose
    ``hlo_flops`` is the analytic model FLOPs (phase 6dry counts 6 (a)'s
    lowered step beside it) and whose ``hlo_bytes`` is 0, so the
    memory term is the analytic bytes'; MFU against 989 TFLOP/s and the
    dominant term's share of the wall.  ``cfg`` is the config that ran, its
    depth cut included.  The analytic bytes count the (B, S, S) scores of
    the plain attention, which the flash kernel never writes, so a step
    through it can read a share above 1: logged as found.  Returns the
    model FLOPs."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import (H100, RooflineResult, analytic_hbm_bytes, model_flops,
                                      residual_inner_scan_flops)

    mf = model_flops(cfg, kind, seq, batch)
    nbytes = analytic_hbm_bytes(cfg, kind, seq, batch, data=1, model=1, n_devices=1)
    resid = residual_inner_scan_flops(cfg, kind, seq, batch, 1)
    res = RooflineResult(arch=cfg.name, shape=f"B {batch} x S {seq}", mesh="1", step_kind=kind,
                         n_devices=1, hlo_flops=mf, hlo_bytes=0.0, coll_bytes_by_class={},
                         coll_bytes_weighted=0.0, residual_flops=resid, model_flops_global=mf,
                         analytic_bytes=nbytes)
    t = res.terms(H100)
    mfu = mf / (H100.peak_flops_bf16 * wall_s)
    share = t["t_dominant_s"] / wall_s
    depth = get_config(cfg.name).n_layers
    log(f"  roofline {phase} {cfg.name} {kind}, {cfg.n_layers} of {depth} layers, B {batch} x S "
        f"{seq}: wall {wall_s * 1e3:.3f} ms; model_flops {mf:.6e}, analytic_hbm_bytes {nbytes:.6e} "
        f"(one device), residual_inner_scan_flops {resid:.6e}; terms on {H100.name} (hlo_flops := "
        f"model_flops, analytic, + the residual): compute "
        f"{t['t_compute_s'] * 1e3:.3f} ms, memory {t['t_memory_s'] * 1e3:.3f} ms, dominant "
        f"{t['dominant']} {t['t_dominant_s'] * 1e3:.3f} ms; mfu {mfu:.4f}, bound_share {share:.4f}"
        f"{' (above 1: the analytic bytes over-count this step)' if share > 1 else ''} ({smi})")
    return mf


def serve_rooflines(phase: str, cfg, res: dict, prompt: int, smi: str) -> None:
    """:func:`roofline_line` for a serve's prefill (a request, or the
    lock-step batch) and its mean decode step (the mean context: the prompt
    and half the generation)."""
    from repro_torch.launch.serve import lock_step

    batch, gen = res["generated"].shape[:2]
    pb = batch if lock_step(cfg) else 1
    roofline_line(phase, cfg, "prefill", prompt, pb, res["prefill_s"] * pb / batch, smi)
    roofline_line(phase, cfg, "decode", prompt + gen // 2, batch,
                  res["decode_s"] / max(res["n_steps"], 1), smi)


def phase_serve(cfg, prompt: int, phase: str, expect: tuple, smi: str,
                params=None, device: str = "cuda") -> tuple[dict, dict]:
    """Serve ``cfg`` through the entry point (with ``params``, or weights
    from ``SEED``); every serving kernel's count is zeroed just before and
    read just after, and each of ``expect`` must have launched (on the
    card: the plain versions on the CPU count none)."""
    from repro_torch.launch.serve import serve

    log(f"phase {phase} serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, attn_impl={cfg.attn_impl}; batch {BATCH}, prompt {prompt}, gen {GEN}")
    reset_peak(device)
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    res = serve(cfg, batch=BATCH, prompt_len=prompt, gen=GEN, kv_kind="device",
                kv_page_len=0, seed=SEED, params=params, device=device)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = res["max_memory_allocated"] = peak_allocated(device)
    log(f"  prefill {res['prefill_s'] * 1e3:.3f} ms for {BATCH} requests "
        f"({res['prefill_s'] * 1e3 / BATCH:.3f} ms each), decode {res['decode_s'] * 1e3:.3f} ms "
        f"for {res['n_steps']} steps = {res['tokens_per_s']:.1f} tok/s, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  launches during serve: {launches}")
    if device == "cuda":
        if min(launches[k] for k in expect) <= 0:
            raise SystemExit(f"a kernel of the path was not launched: {launches}")
        serve_rooflines(phase, cfg, res, prompt, smi)
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
    from repro_torch.serve import SLO, LoadGenConfig, Phase, SLOScheduler, generate

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
        if kind == "pinned_host":  # what phase 8c holds its mesh run against
            write_p2_result(res, launches)
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
                                     gen=SHARED_GEN,
                                     shared_prefix_len=SHARED_PREFIX, prefix_sharing=sharing,
                                     **page)
    same("(d) shared vs unshared", runs[True]["generated"], runs[False]["generated"])
    on, off = runs[True]["stats"], runs[False]["stats"]
    if not (on.shared_hits > 0 and on.bytes_h2d < off.bytes_h2d):
        raise SystemExit(f"(d) sharing saved nothing: {on.shared_hits} hits, "
                         f"{on.bytes_h2d} against {off.bytes_h2d} B")
    log(f"  (d) done ({sub_s():.1f} s)")

    trace = LoadGenConfig(seed=0, phases=tuple(Phase(d, r) for d, r in LG_PHASES),
                          prompt_lens=LG_PROMPTS, prompt_mix=(1.0,) * len(LG_PROMPTS),
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
            res, _ = streamed_run(cfg, params, "(e) sanitized", engine=engine,
                                  **dict(stream, gen=W_SHORT_GEN))
        checks = engine.sanitizer.checks
    finally:
        del os.environ["REPRO_SANITIZE"]
    same("(e) sanitized", res["generated"], want[:, :W_SHORT_GEN])
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


# ---------------------------------------------------------------------------
# phase 2m: full-width mixtral-8x7b through the MoE layers and route-aware
# expert streaming
# ---------------------------------------------------------------------------


class RouteLog:
    """Counts the distinct experts each decode routing picks (the routed
    set a streamed MoE stage fetches): wraps ``moe.decode_route`` while in
    use.  Its ``torch.unique`` reads the routing on the host, which the
    streamed step does at the same point anyway."""

    def __init__(self):
        self.unique: list = []

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = orig = moe.decode_route

        def decode_route(cfg, p, x):
            top_w, top_i = orig(cfg, p, x)
            self.unique.append(int(torch.unique(top_i).numel()))
            return top_w, top_i

        moe.decode_route = decode_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.decode_route = self._orig


def moe_logit_check(cfg, params, prompts: torch.Tensor, device: str, phase: str = "2m",
                    hold_routing: bool = False) -> None:
    """(a)'s prefill logits and first decode step, kernel path against the
    plain path on the same layers, within LOGIT_RTOL of the largest logit;
    the routing decisions that differ between the two are counted (bf16
    attention differences can flip a near tie in a later layer).

    With ``hold_routing`` the gate reads a third run: the kernel path with
    every router call's choices and weights replaced by the plain path's,
    so both run the same experts and differ by the attention's rounding
    alone.  Among 128 experts top-8 a flipped near tie swaps a whole expert
    of a token's FFN, and the free-routing difference (logged beside) then
    measures the flips more than the kernels."""
    from repro_torch.launch.serve import step_pos
    from repro_torch.models import moe
    from repro_torch.train import steps as st

    b, s = prompts.shape
    out, routes = {}, {}
    orig = moe._router
    nxt = None
    runs = [("pallas", False), ("xla", False)] + ([("pallas", True)] if hold_routing else [])
    for impl, held in runs:
        c = dataclasses.replace(cfg, attn_impl=impl)
        calls = routes[impl, held] = []
        replay = iter(routes["xla", False]) if held else None

        def router(cfg_, p, x, calls=calls, replay=replay):
            r = orig(cfg_, p, x)
            if replay is not None:
                r = next(replay) + r[2:]
            calls.append(r[:2])
            return r

        moe._router = router
        try:
            logits, caches = st.make_prefill_step(c, b, s + 2)(params, {"tokens": prompts})
            if nxt is None:
                nxt = logits[:, -1].argmax(-1)  # every run decodes the same token
            logits2, _ = st.make_decode_step(c)(params, caches, {"tokens": nxt[:, None]},
                                                step_pos(c, b, s, device))
        finally:
            moe._router = orig
        out[impl, held] = (logits.float(), logits2.float())
        del caches
    free, ref = routes["pallas", False], routes["xla", False]
    flips = sum(int((a[1] != b_[1]).sum()) for a, b_ in zip(free, ref))
    total = sum(a[1].numel() for a in free)
    gated = runs[-1]
    for i, step in enumerate(("prefill", "decode")):
        r = out["xla", False][i]
        rels = {}
        for run in (("pallas", False), gated):
            a = out[run][i]
            if not (torch.isfinite(a).all() and torch.isfinite(r).all()):
                raise SystemExit(f"{phase} {step} logits are not finite")
            rels[run] = max_err(a, r) / r.abs().max().item()
        a = out[gated][i]
        same = bool((a.argmax(-1) == r.argmax(-1)).all())
        held = (f" with the plain path's routing held (free routing: "
                f"{rels['pallas', False]:.3e})" if hold_routing else "")
        log(f"  (a) {step} logits, kernel path vs plain path{held}: max |diff| / max |logit| = "
            f"{rels[gated]:.3e} (limit {LOGIT_RTOL}), same greedy token: {same}")
        if rels[gated] > LOGIT_RTOL:
            raise SystemExit(f"{phase} {step} logits of the kernel path disagree with the plain path")
    log(f"  (a) routing decisions that differ between the paths: {flips} of {total}")


def reset_peak(device: str) -> None:
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_allocated(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def moe_run(cfg, params, name: str, smi: str, *, gen: int, expect=None, device: str = "cuda",
            **kw) -> dict:
    """One serve of ``cfg`` through the entry point, unpaged, the launch
    counts zeroed just before and read just after, the decode routing
    recorded; logs the run's numbers beside the card's."""
    from repro_torch.launch.serve import serve

    reset_peak(device)
    wrappers = serving_kernels()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with RouteLog() as routes:
        res = serve(cfg, batch=MOE_BATCH, prompt_len=MOE_PROMPT, gen=gen, kv_page_len=0,
                    seed=SEED, params=params, device=device, **kw)
    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    res["routes"] = routes.unique
    res["max_memory_allocated"] = peak_allocated(device)
    walls = sorted(res["step_walls"])
    line = (f"  {name}: prefill {res['prefill_s'] * 1e3:.3f} ms, decode step "
            f"{res['decode_s'] * 1e3 / max(res['n_steps'], 1):.3f} ms (median host "
            f"{walls[len(walls) // 2] * 1e3:.3f} ms) over {res['n_steps']} steps")
    es, ps = res["expert_stats"], res["param_stats"]
    if es is not None:
        plan, steps = res["param_plan"], res["n_steps"]
        rc = res["param_residency"]
        line += (f"; transfer wait {(ps.transfer_wait_s + es.transfer_wait_s) / max(steps, 1) * 1e3:.3f}"
                 f" ms a step ({es.transfer_wait_s / max(steps, 1) * 1e3:.3f} on experts); "
                 f"experts {res['expert_decode_bytes'] / steps:.0f} B a decode step "
                 f"({res['expert_decode_bytes'] / steps / cfg.n_layers:.0f} B a layer), "
                 f"{sum(routes.unique) / max(len(routes.unique), 1):.3f} distinct experts a "
                 f"layer; weight pipeline (non-expert groups) {ps.bytes_h2d} B over "
                 f"{ps.n_runs} passes; residency "
                 f"{rc['hits']} hits ({es.cache_hits} of them experts), {plan.n_groups} groups")
    line += (f"; max_memory_allocated {res['max_memory_allocated']} B; launches "
             f"{res['launches']} ({time.perf_counter() - t0:.1f} s; {smi})")
    log(line)
    if expect is not None and not np.array_equal(res["generated"], expect):
        raise SystemExit(f"{name}: tokens differ from the run they must equal bitwise")
    return res


def check_moe_counts(name: str, res: dict, budget_bytes: int, *, disk: bool = False,
                     cached: bool = True) -> None:
    """The expert and weight-pipeline traffic of one streamed run against the
    plan and the recorded routing: one H2D request a fetched group; expert
    bytes the distinct routed experts of every decode call times the plan's
    expert group bytes (an expert group is larger than the cache, so never
    resident); with ``cached=False`` (``param_cache_mb=0``) the pipeline's
    groups and bytes the plan's closed form too; streamed plus cached bytes
    within the budget and the analyzer's peak.  Prefill streams every group
    once a prefill call: once for a lock-step batch (mixtral's ring), once a
    request where requests prefill one at a time (qwen3-moe's pages)."""
    from repro_torch.launch.serve import lock_step

    ps, es, plan = res["param_stats"], res["expert_stats"], res["param_plan"]
    rc = res["param_residency"]
    calls = len(res["routes"]) // plan.n_layers  # decode steps, the warm-up's too
    prefills = 1 if lock_step(plan.cfg) else res["generated"].shape[0]
    routed = sum(res["routes"])
    per_step = plan.embed_bytes + plan.n_layers * plan.nonexpert_layer_bytes + plan.head_fetch_bytes
    checks = {
        "expert groups fetched": (es.unique_group_fetches, routed),
        "expert H2D requests": (es.h2d_requests, routed),
        "expert bytes": (es.bytes_h2d, routed * plan.per_expert_bytes),
        "expert resident hits": (es.cache_hits, 0),
        "pipeline H2D requests": (ps.h2d_requests, ps.unique_group_fetches),
        "pipeline groups": (ps.unique_group_fetches + ps.cache_hits,
                            prefills * plan.n_groups + calls * (plan.n_layers + 2)),
    }
    if not cached:
        checks["pipeline bytes"] = (ps.bytes_h2d,
                                    prefills * sum(plan.fetch_sequence_bytes()) + calls * per_step)
        checks["pipeline hits"] = (ps.cache_hits, 0)
    if disk:
        checks["expert disk requests"] = (es.disk_requests, routed)
        checks["pipeline disk requests"] = (ps.disk_requests, ps.unique_group_fetches)
    for what, (got, want) in checks.items():
        if got != want:
            raise SystemExit(f"{name}: {what} {got}, the plan and routing give {want}")
    for st_ in (ps, es):
        if st_.per_tier()["h2d"]["requests_per_fetched_device_group"] != 1.0:
            raise SystemExit(f"{name}: not one H2D request a fetched group")
    held = ps.peak_inflight_bytes + es.peak_inflight_bytes + rc["peak_resident_bytes"]
    if not held <= res["schedule_peak"] <= budget_bytes:
        raise SystemExit(f"{name}: streamed + cached {held} B, the analyzer's peak "
                         f"{res['schedule_peak']} B, the budget {budget_bytes} B")


def expert_bytes_per_layer_step(res: dict) -> float:
    return res["expert_decode_bytes"] / res["n_steps"] / res["param_plan"].n_layers


def rss_bytes() -> int:
    """This process's resident set (``/proc/self/status``'s VmRSS), B."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return 0


def mem_available() -> int:
    """The host's available memory (``/proc/meminfo``'s MemAvailable), B."""
    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return int(info["MemAvailable"].split()[0]) * 1024


def host_pinned_cached() -> int:
    """Pinned host bytes the CUDA caching host allocator holds (0 off the
    card or where the allocator reports none)."""
    if not torch.cuda.is_available():
        return 0
    stats = torch.cuda.memory.host_memory_stats()
    return int(stats.get("reserved_bytes.current", stats.get("allocated_bytes.current", 0)))


def moe_home_fits(plan, margin_bytes: int) -> tuple[bool, int]:
    """Whether the host's available memory holds ``plan``'s home with
    ``margin_bytes`` to spare."""
    avail = mem_available()
    return avail >= plan.total_param_bytes + margin_bytes, avail


def expert_plan(phase: str, cfg, budget_mb: float):
    """``cfg``'s expert-split plan under ``budget_mb``, which must hold the
    distance-1 floor and leave a residency cache smaller than one expert
    group (so no expert is ever resident: every routed one is fetched)."""
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.train import steps as st

    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), expert_stream=True,
                            device_budget_mb=budget_mb)
    floor = plan.peak_device_bytes(1)
    log(f"  plan: {plan.n_groups} groups ({plan.per_expert_bytes} B an expert group, "
        f"{plan.nonexpert_layer_bytes} B a non-expert group), {plan.total_param_bytes} B; "
        f"budget {int(budget_mb * 1e6)} B over the distance-1 floor {floor} B, distance cap "
        f"{plan.max_distance_for_budget()}, cache {plan.residency_capacity_bytes()} B")
    if not floor <= budget_mb * 1e6 or plan.residency_capacity_bytes() >= plan.per_expert_bytes:
        raise SystemExit(f"{phase}: the budget must hold the distance-1 floor and leave the cache "
                         "smaller than one expert group")
    return plan


def serve_schedule(plan, fan_in: int):
    """The analyzer's report of ``plan``'s serve schedule at its budget's
    distance and cache, ``fan_in`` routed experts a MoE stage."""
    from repro_torch.core import schedcheck as sc

    return sc.analyze_serve_schedule(plan, distance=plan.max_distance_for_budget(),
                                     cache_capacity=plan.residency_capacity_bytes(),
                                     fan_in=fan_in)


def phase_moe(smi: str, device: str = "cuda", full=None) -> dict:
    """Phase 2m: full-width mixtral-8x7b (or ``full``) served through the MoE
    layers with the experts streamed route-aware from pinned host and disk.
    Returns the device-resident run's kernel launches (for phase 5)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.refspec import AUTO
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.launch import serve as sv
    from repro_torch.launch.serve import ServeSession
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    log(f"  host MemAvailable {mem_available()} B, pinned cached {host_pinned_cached()} B")
    full = dataclasses.replace(full or get_config("mixtral-8x7b"), attn_impl="pallas")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    total, _ = full.param_count()
    log(f"phase 2m serve {full.name}: d_model {full.d_model}, {full.n_heads}/{full.n_kv_heads} "
        f"heads, head_dim {full.head_dim}, {full.n_experts} experts of d_ff {full.d_ff} top-"
        f"{full.moe_top_k}, window {full.window}, {full.dtype}; {total:,} parameters at "
        f"{full.n_layers} layers; batch {MOE_BATCH}, prompt {MOE_PROMPT}, gen {MOE_GEN}; {smi}")
    budget = int(MOE_BUDGET_MB * 1e6)
    plan = expert_plan("2m", cfg, MOE_BUDGET_MB)

    # (a) 4 layers on the card: the bitwise baseline
    params = st.init_params(cfg, SEED, device)
    a = moe_run(cfg, params, "(a) device-resident", smi, gen=MOE_GEN, device=device)
    want = a["generated"]
    if want.shape != (MOE_BATCH, MOE_GEN) or want.min() < 0 or want.max() >= cfg.vocab_size:
        raise SystemExit(f"2m (a): generated tokens malformed: {want.shape}")
    # (the plain versions on the CPU count no launch: a rehearsal there skips this)
    if device == "cuda" and min(a["launches"][k] for k in ("flash_attention", "decode_attention")) <= 0:
        raise SystemExit(f"2m (a): a kernel of the path was not launched: {a['launches']}")
    log(f"  (a) first request {want[0, :8].tolist()}...")
    if device == "cuda":
        serve_rooflines("2m (a)", cfg, a, MOE_PROMPT, smi)
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                                                      dtype=np.int32)  # serve()'s
    moe_logit_check(cfg, params, torch.from_numpy(prompts).long().to(device), device)

    # (f0) the paged session's device-resident twin (see (f))
    pcfg = dataclasses.replace(cfg, attn_type="full")

    def paged(name, weights, **kw):
        reset_peak(device)
        t0 = time.perf_counter()
        with ServeSession(pcfg, slots=MOE_BATCH, max_len=MOE_PROMPT + MOE_GEN,
                          kv_kind="pinned_host", page_len=PAGE_LEN, params=weights,
                          device=device, **kw) as session:
            rids = [session.submit(p, MOE_GEN) for p in prompts]
            out = session.run()
            toks = np.stack([out[r] for r in rids])
            log(f"  {name}: {session.n_steps} steps, max_memory_allocated "
                f"{peak_allocated(device)} B ({time.perf_counter() - t0:.1f} s)")
            return toks, session.expert_stats, session.param_stats, session.schedule_report

    f0, _, _, _ = paged("(f0) paged, weights on the card", params)
    log(f"  (f0) tokens equal (a)'s: {bool(np.array_equal(f0, want))}")
    del params
    reset_peak(device)
    stream = dict(param_kind="pinned_host", expert_stream=True, device_budget_mb=MOE_BUDGET_MB,
                  device=device)

    # (e) the deep run (the whole model's 32 layers are more than the card
    # holds; MOE_FULL_LAYERS says how many run), at the home this machine
    # holds; (a)'s weights leave the card first and are drawn again after
    big = dataclasses.replace(full, n_layers=MOE_FULL_LAYERS)
    bplan = WeightStreamPlan(big, st.abstract_params(big), expert_stream=True,
                             device_budget_mb=MOE_BUDGET_MB)
    # give back the pinned staging the runs above left in the caching host
    # allocator.  (e) runs before any disk spill of this phase: the H100
    # host counts a spill's file pages as used, not available, after the
    # files are gone (~11 GB after (d)'s)
    gc.collect()
    cached = host_pinned_cached()
    free_host(device)
    fits, avail = moe_home_fits(bplan, MOE_HOST_MARGIN)
    card = torch.cuda.get_device_properties(0).total_memory if device == "cuda" else 0
    log(f"  (e) {big.n_layers} layers: {bplan.total_param_bytes} B of weights, the card "
        f"{card} B, host MemAvailable {avail} B (margin {MOE_HOST_MARGIN} B; pinned cache "
        f"{cached} B before emptying, {host_pinned_cached()} B after)")
    if not fits:
        raise SystemExit(f"2m (e): this machine's host cannot hold the {bplan.total_param_bytes}"
                         f" B home with {MOE_HOST_MARGIN} B to spare ({avail} B available)")
    t0 = time.perf_counter()
    bhome = st.init_weight_streamed_params(big, bplan, SEED, device)
    log(f"  (e) group-wise init to the host: {time.perf_counter() - t0:.1f} s, host "
        f"MemAvailable then {moe_home_fits(bplan, 0)[1]} B")
    res = moe_run(big, bhome, f"(e) {big.n_layers} layers, routed, pinned host", smi,
                  gen=MOE_FULL_GEN, warmup=False, **stream)
    log(f"  (e) host MemAvailable after the run {mem_available()} B")
    del bhome
    res["schedule_peak"] = serve_schedule(bplan, full.moe_top_k * MOE_BATCH).peak_bytes
    check_moe_counts("2m (e)", res, budget)
    whole = expert_bytes_per_layer_step(res)  # held to (c)'s below
    gen = res["generated"]
    if gen.shape != (MOE_BATCH, MOE_FULL_GEN) or gen.min() < 0 or gen.max() >= big.vocab_size:
        raise SystemExit(f"2m (e): generated tokens malformed: {gen.shape}")
    log(f"  (e) tokens {gen.tolist()}")

    home = plan.init_home(st.init_params(cfg, SEED, device))  # (a)'s weights, at the host
    reset_peak(device)

    # (b) routed at pinned host, distance 1 (no cache) and auto (the default cache)
    peak = serve_schedule(plan, full.moe_top_k * MOE_BATCH).peak_bytes
    routed = {}
    for dist, cache in ((1, 0.0), (AUTO, None)):
        name = f"(b) routed, pinned host, distance {dist}"
        res = moe_run(cfg, home, name, smi, gen=MOE_GEN, expect=want, param_distance=dist,
                      param_cache_mb=cache, **stream)
        res["schedule_peak"] = peak
        check_moe_counts(f"2m {name}", res, budget, cached=cache is None)
        if any(res["launches"][k] != a["launches"][k] for k in ("flash_attention",
                                                                 "decode_attention")):
            raise SystemExit(f"2m {name}: launches {res['launches']} differ from (a)'s")
        routed[dist] = expert_bytes_per_layer_step(res)
    # (c) all-expert through the same path (every step fetches every expert:
    # its bytes a layer a step need no more steps than the disk run's)
    c = moe_run(cfg, home, "(c) all experts, pinned host, distance auto", smi, gen=MOE_DISK_GEN,
                expect=want[:, :MOE_DISK_GEN], route_experts=False, **stream)
    all_e = expert_bytes_per_layer_step(c)
    ces = c["expert_stats"]
    if (ces.unique_group_fetches != MOE_DISK_GEN * cfg.n_layers * cfg.n_experts  # + warm-up
            or ces.per_tier()["h2d"]["requests_per_fetched_device_group"] != 1.0):
        raise SystemExit(f"2m (c): {ces.unique_group_fetches} expert groups fetched in "
                         f"{ces.h2d_requests} requests")
    for dist, b in routed.items():
        if not 2 * b <= all_e:
            raise SystemExit(f"2m (b) distance {dist}: {b} expert B a layer a step against the "
                             f"all-expert {all_e}")
    if not 2 * whole <= all_e:
        raise SystemExit(f"2m (e): {whole} expert B a layer a step against the all-expert "
                         f"{all_e}")
    log(f"  routed against all experts, B a layer a decode step: {routed}, (e) {whole} vs "
        f"{all_e} ({all_e / routed[AUTO]:.2f}x)")

    # (d) disk, routed, distance auto
    spill = ROOT / "build" / "spill-moe"
    shutil.rmtree(spill, ignore_errors=True)
    try:
        res = moe_run(cfg, home, "(d) routed, disk", smi, gen=MOE_DISK_GEN,
                      expect=want[:, :MOE_DISK_GEN], spill_dir=str(spill),
                      **{**stream, "param_kind": "disk_host"})
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    res["schedule_peak"] = peak
    check_moe_counts("2m (d)", res, budget, disk=True)

    # (f) the paged session at pinned-host pages, the experts routed from the
    # pinned-host home.  A ring cache (mixtral's window) is not pageable; at
    # 520 positions the 4096-token window never binds, so the session serves
    # the same weights with full attention and must give (f0)'s tokens
    # the session's budget: (b)'s, plus the KV hot window it cuts first
    page_nbytes = sv._page_nbytes(st.abstract_caches(pcfg, 1, MOE_PROMPT + MOE_GEN), PAGE_LEN)
    hot_mb = MOE_BATCH * (1 + 2) * page_nbytes / 1e6
    toks, es, ps, report = paged("(f) paged, routed experts at pinned host", home,
                                 param_kind="pinned_host", expert_stream=True,
                                 device_budget_mb=MOE_BUDGET_MB + hot_mb)
    if not np.array_equal(toks, f0) or not report.ok:
        raise SystemExit(f"2m (f): tokens bitwise (f0)'s: {np.array_equal(toks, f0)}, "
                         f"schedule {report.ok}")
    for st_ in (ps, es):
        if st_.per_tier()["h2d"]["requests_per_fetched_device_group"] != 1.0:
            raise SystemExit("2m (f): not one H2D request a fetched group")
    log(f"  (f) experts {es.unique_group_fetches} groups / {es.bytes_h2d} B, weights "
        f"{ps.unique_group_fetches} groups / {ps.bytes_h2d} B")
    del home

    log(f"  phase 2m done in {time.perf_counter() - t_phase:.1f} s")
    return a["launches"]


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensor leaves (meta tensors too)."""
    from repro_torch.core import tree as tr

    return sum(x.numel() * x.element_size() for x in tr.leaves(tree))


def device_init(phase: str, cfg, device: str):
    """``init_params(cfg, SEED, device)``, its wall and peak allocation
    logged beside the weights' bytes.  Built group by group, it holds at
    most the finished tree and one layer's f32 slice, with one leaf's draw
    beside it (the f32 shell before the layers): the peak must stay under
    the weights plus twice the larger f32 unit (a whole f32 draw of
    internlm2-20b beside its cast, ~119 GB, is more than the card)."""
    from repro_torch.train import steps as st

    reset_peak(device)
    t0 = time.perf_counter()
    params = st.init_params(cfg, SEED, device)
    sync(device)
    wall = time.perf_counter() - t0
    weights = tree_bytes(params.as_dict())
    blocks = tree_bytes(params.as_dict()["blocks"])
    f32 = 32 / torch.finfo(cfg.compute_dtype).bits  # an f32 draw's bytes per compute-dtype byte
    unit = f32 * max(blocks / cfg.n_layers, weights - blocks)
    peak = peak_allocated(device)
    log(f"  {phase} group-wise init on {device}: {wall:.1f} s, {weights} B of weights, peak "
        f"allocated {peak} B ({peak / max(weights, 1):.3f}x the weights; bound {weights + 2 * unit:.0f}"
        f" B: the weights and twice the larger f32 unit, layer or shell)")
    if peak > weights + 2 * unit:
        raise SystemExit(f"{phase}: the group-wise init peaked at {peak} B, above {weights + 2 * unit} B")
    return params


def phase_qwen3(smi: str, device: str = "cuda", full=None) -> dict:
    """Phase 2q: full-width qwen3-moe-235b-a22b (or ``full``) cut to
    ``Q_LAYERS`` layers, served through the entry point at 2m's batch,
    prompt and gen: (a) device-resident, the weights built group by group on
    the card, both kernels launched at 64 query heads over 4, the logits
    within LOGIT_RTOL of the plain path's; (b) the experts routed from a
    pinned-host home built group by group, tokens bitwise (a)'s, at most
    ``Q_EXPERT_SHARE`` of a layer's expert bytes a decode step.  Returns
    (a)'s launches (for phase 5)."""
    from repro_torch.configs import get_config
    from repro_torch.core import schedcheck as sc
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    full = dataclasses.replace(full or get_config(Q_ARCH), attn_impl="pallas")
    cfg = dataclasses.replace(full, n_layers=Q_LAYERS)
    total, active = full.param_count()
    log(f"phase 2q serve {full.name}: d_model {full.d_model}, {full.n_heads}/{full.n_kv_heads} "
        f"heads, head_dim {full.head_dim}, qk_norm {full.qk_norm}, {full.n_experts} experts of "
        f"d_ff {full.d_ff} top-{full.moe_top_k}, vocab {full.vocab_size}, tied "
        f"{full.tie_embeddings}, {full.dtype}; {total:,} parameters ({active:,} active) at "
        f"{full.n_layers} layers, {cfg.n_layers} here; batch {MOE_BATCH}, prompt {MOE_PROMPT}, "
        f"gen {MOE_GEN}; {smi}")

    # (a) device-resident: the bitwise baseline
    params = device_init("2q (a)", cfg, device)
    a = moe_run(cfg, params, "2q (a) device-resident", smi, gen=MOE_GEN, device=device)
    want = a["generated"]
    if want.shape != (MOE_BATCH, MOE_GEN) or want.min() < 0 or want.max() >= cfg.vocab_size:
        raise SystemExit(f"2q (a): generated tokens malformed: {want.shape}")
    weights = st.abstract_params(cfg)
    wbytes = tree_bytes(weights)
    log(f"  2q (a) first request {want[0].tolist()}; peak allocated {a['max_memory_allocated']} B "
        f"against {wbytes} B of weights ({a['max_memory_allocated'] / wbytes:.3f}x)")
    if device == "cuda":
        if min(a["launches"][k] for k in ("flash_attention", "decode_attention")) <= 0:
            raise SystemExit(f"2q (a): a kernel of the path was not launched: {a['launches']}")
        serve_rooflines("2q (a)", cfg, a, MOE_PROMPT, smi)
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                                                      dtype=np.int32)  # serve()'s
    moe_logit_check(cfg, params, torch.from_numpy(prompts).long().to(device), device, phase="2q",
                    hold_routing=True)
    del params
    reset_peak(device)

    # (b) the experts routed from pinned host, under the distance-1 floor
    # rounded up to Q_BUDGET_ROUND bytes
    floor = WeightStreamPlan(cfg, weights, expert_stream=True).peak_device_bytes(1)
    budget_mb = -(-floor // Q_BUDGET_ROUND) * Q_BUDGET_ROUND / 1e6
    plan = expert_plan("2q", cfg, budget_mb)
    fan_in = full.moe_top_k * MOE_BATCH
    report = sc.verify_schedule(serve_schedule(plan, fan_in))
    log(f"  2q (b) {report}".replace("\n", "\n  "))
    free_host(device)
    fits, avail = moe_home_fits(plan, MOE_HOST_MARGIN)
    log(f"  2q (b) home {plan.total_param_bytes} B, host MemAvailable {avail} B (margin "
        f"{MOE_HOST_MARGIN} B)")
    if not fits:
        raise SystemExit(f"2q (b): this machine's host cannot hold the {plan.total_param_bytes} B "
                         f"home with {MOE_HOST_MARGIN} B to spare ({avail} B available)")
    t0 = time.perf_counter()
    home = st.init_weight_streamed_params(cfg, plan, SEED, device)
    log(f"  2q (b) group-wise init to the host: {time.perf_counter() - t0:.1f} s, host "
        f"MemAvailable then {mem_available()} B")
    name = "2q (b) routed, pinned host, distance auto"
    res = moe_run(cfg, home, name, smi, gen=Q_STREAM_GEN, expect=want[:, :Q_STREAM_GEN],
                  warmup=False, param_kind="pinned_host", expert_stream=True,
                  device_budget_mb=budget_mb, device=device)
    del home
    res["schedule_peak"] = report.peak_bytes
    check_moe_counts(name, res, int(budget_mb * 1e6))
    if device == "cuda" and min(res["launches"][k] for k in ("flash_attention",
                                                             "decode_attention")) <= 0:
        raise SystemExit(f"{name}: a kernel of the path was not launched: {res['launches']}")
    routed = expert_bytes_per_layer_step(res)
    every = cfg.n_experts * plan.per_expert_bytes  # the all-expert figure, from the plan
    log(f"  2q (b) expert bytes a layer a decode step: routed {routed:.0f} B ({routed / every:.4f} "
        f"of the plan's all-expert {every} B; at most {fan_in} x {plan.per_expert_bytes} B = "
        f"{fan_in * plan.per_expert_bytes} B, {Q_EXPERT_SHARE} of all; 2m's mixtral reads 0.435)")
    if not routed <= min(fan_in * plan.per_expert_bytes, Q_EXPERT_SHARE * every):
        raise SystemExit(f"2q (b): {routed} expert B a layer a decode step, above {fan_in} "
                         f"experts or {Q_EXPERT_SHARE} of the plan's all-expert {every} B")
    log(f"  phase 2q done in {time.perf_counter() - t_phase:.1f} s")
    return a["launches"]


def phase_dense(smi: str, device: str = "cuda", fulls=None) -> dict:
    """Phase 2d: each of ``DENSE_ARCHS`` (or the configs ``fulls``) at full
    width and depth, its weights built group by group on the card, served
    through the entry point (phase 2's batch, prompt and gen, unpaged device
    caches, both kernels launched, a ``roofline`` line), then its output
    checked and the kernel path's logits held to the plain path's at
    ``DENSE_CHECK_LAYERS`` layers; each model freed before the next.
    Returns each config's launches by name (for phase 5)."""
    from repro_torch.configs import get_config

    out = {}
    for full in fulls or [get_config(a) for a in DENSE_ARCHS]:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(full, attn_impl="pallas")
        params = device_init(f"2d {cfg.name}", cfg, device)
        res, out[cfg.name] = phase_serve(cfg, PROMPT, f"2d {cfg.name}",
                                         ("flash_attention", "decode_attention"), smi,
                                         params=params, device=device)
        del params
        reset_peak(device)
        phase_check(dataclasses.replace(cfg, n_layers=DENSE_CHECK_LAYERS), res, PROMPT,
                    f"3d {cfg.name}", device)
        log(f"  phase 2d {cfg.name} done in {time.perf_counter() - t0:.1f} s")
    return out


def phase_check(cfg, res: dict, prompt: int, phase: str, device: str = "cuda") -> None:
    """``res``'s tokens well formed, and the kernel path's prefill and first
    decode logits within LOGIT_RTOL of the plain path's on ``cfg`` (the
    served config, or its first layers) from ``SEED``, one prompt."""
    from repro_torch.launch.serve import step_pos
    from repro_torch.train import steps as st

    log(f"phase {phase} output checks ({cfg.name}, {cfg.n_layers} layers)")
    gen = res["generated"]
    if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"generated tokens malformed: shape {gen.shape}, "
                         f"range [{gen.min()}, {gen.max()}]")
    log(f"  generated {gen.shape} int32 in [0, {cfg.vocab_size}); first request {gen[0, :8].tolist()}...")
    # the kernel path against the plain path on the full-width model
    params = st.init_params(cfg, SEED, device)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    tokens = torch.randint(1, cfg.vocab_size, (1, prompt), generator=g, device=device)
    pos = step_pos(cfg, 1, prompt, device)  # the serve loop's, on its schedule
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
    dev = "cuda" if torch.cuda.is_available() else "cpu"  # a rehearsal on the CPU
    on = lambda x: host_tensor(x).to(dev)  # noqa: E731
    return len(la) == len(lb) and all(
        on(x).dtype == on(y).dtype and torch.equal(bits(on(x)), bits(on(y))) for x, y in zip(la, lb))


def train_cfg(cfg, **kw):
    return dataclasses.replace(cfg, attn_impl="xla", remat="full", loss_chunk=512, **kw)


def train_batch(cfg, step: int, device="cuda", seq: int = TRAIN_SEQ) -> dict:
    """The launcher's batch for ``step``, on the card."""
    from repro_torch.data import SyntheticConfig, synthetic_batch

    sc = SyntheticConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=SEED)
    return {k: v.to(device) for k, v in synthetic_batch(cfg, sc, step).items()}


def train_run(cfg, ckpt_dir: Path, *, steps: int = TRAIN_STEPS, run: bool = False,
              keep_after=(), setup=None, checkpoint_every: int = 100, seq: int = TRAIN_SEQ,
              **kw) -> dict:
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
        cfg, global_batch=TRAIN_BATCH, seq_len=seq, opt_cfg=AdamWConfig(**TRAIN_OPT),
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


def measured_step(step_fn, params, opt, batch) -> tuple:
    """One train step on the card, with the bytes its arguments occupy
    (their storages: parameters, AdamW state, batch) and its peak of
    allocated bytes, net of what the card held before it but for those
    arguments: ``(params, opt, {"argument_bytes", "step_peak"})``."""
    from repro_torch.core.lowering import tensor_bytes

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    args = tensor_bytes((params, opt, batch))
    torch.cuda.reset_peak_memory_stats()
    new_params, new_opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held + args
    return new_params, new_opt, {"argument_bytes": args, "step_peak": peak}


def phase_dryrun(tcfg, step: dict, wall_s: float, smi: str) -> None:
    """Phase 6dry: phase 6 (a)'s step lowered on the meta device, held
    against ``step`` (:func:`measured_step`) and read over (a)'s wall."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.roofline import analysis as ra

    t0 = time.perf_counter()
    c = lower_step(tcfg, TRAIN_SEQ, TRAIN_BATCH, "train",
                   inputs=train_batch(tcfg, 0, "meta"))  # the launcher's int64 batch
    secs = time.perf_counter() - t0
    m = c.memory_analysis()
    total = (m.argument_size_in_bytes + m.output_size_in_bytes + m.temp_size_in_bytes
             - m.alias_size_in_bytes)
    flops = ra.cost_terms(c)["flops"]
    mf = ra.model_flops(tcfg, "train", TRAIN_SEQ, TRAIN_BATCH)
    share = total / step["step_peak"]
    log(f"phase 6dry {tcfg.name} train, B {TRAIN_BATCH} x S {TRAIN_SEQ}, lowered on the meta device "
        f"in {secs:.1f} s (host CPU): argument {m.argument_size_in_bytes} B (on the card "
        f"{step['argument_bytes']} B), output {m.output_size_in_bytes} B, temp "
        f"{m.temp_size_in_bytes} B, alias {m.alias_size_in_bytes} B; argument + output + temp - "
        f"alias {total} B against (a)'s measured step peak {step['step_peak']} B: {share:.4f} "
        f"(gate 1 +- {DRYRUN_PEAK_BAND}) ({smi})")
    log(f"  6dry FLOPs {flops:.6e} (products), model_flops {mf:.6e}, model_flops_ratio "
        f"{mf / flops:.4f}; over (a)'s wall {wall_s * 1e3:.3f} ms: {flops / wall_s / 1e12:.2f} "
        f"TFLOP/s = {flops / wall_s / BF16_FLOP_PER_S:.4f} of 989 TFLOP/s ({smi})")
    if m.argument_size_in_bytes != step["argument_bytes"]:
        raise SystemExit(f"6dry: the dry-run's arguments {m.argument_size_in_bytes} B are not the "
                         f"{step['argument_bytes']} B the step's arguments occupy on the card")
    if abs(share - 1) > DRYRUN_PEAK_BAND:
        raise SystemExit(f"6dry: the dry-run's peak {total} B is {share:.4f} of the measured "
                         f"{step['step_peak']} B, outside 1 +- {DRYRUN_PEAK_BAND}")


def phase_train(cfg, smi: str) -> dict:
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
    # model FLOPs a step: the JAX package's 6 N T over the config's parameter count
    # (the attention's not counted)
    flops = roofline_line("6 (a)", tcfg, "train", TRAIN_SEQ, TRAIN_BATCH, wall, smi)
    log(f"  (a) device: losses {[round(x, 4) for x in losses]}; a second run from the same init "
        f"bitwise equal (losses, parameters)")
    log(f"  (a) step wall {wall * 1e3:.3f} ms (median of steps 2-{TRAIN_STEPS - 1}; runs {[round(w * 1e3, 3) for w in a['walls']]} "
        f"/ {[round(w * 1e3, 3) for w in a2['walls']]} ms), {tokens / wall:.1f} tok/s, model "
        f"{flops / wall / 1e12:.2f} TFLOP/s = {flops / wall / BF16_FLOP_PER_S:.4f} of 989 TFLOP/s; "
        f"max_memory_allocated {peak} B; the driver's run {a['seconds']:.1f} s (its final "
        f"checkpoint included), the second run's {a2['seconds']:.1f} s")
    # one profiled step on (a)'s state: device busy, idle share, launches, top kernels
    step_fn = st.make_train_step(tcfg, AdamWConfig(**TRAIN_OPT))
    params, opt = a2["state"]["params"], a2["state"]["opt"]
    del a2
    batch = train_batch(tcfg, 0)
    params, opt, step_mem = measured_step(step_fn, params, opt, batch)
    phase_dryrun(tcfg, step_mem, wall, smi)
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


def free_host(device: str) -> None:
    """Collect, and give back the pinned buffers the CUDA caching host
    allocator keeps (a streamed train step's drains: tens of GB)."""
    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if device == "cuda" and empty is not None:
        empty()


def streamed_step_counts(plan, leaves: dict, kind: str, hit: int) -> dict:
    """One streamed train step's counters at home ``kind`` (the plan's closed
    form): the weight passes (forward ``embed, L.., head``, backward the
    middle groups reversed and ``embed``), then the optimizer pass
    ({grads, moments} in; {params, moments} out).  ``leaves`` counts each
    home group's leaves; ``hit`` is 1 when the head's home is a residency
    hit (cached from an earlier step's forward)."""
    n, total, head_home = plan.n_groups, plan.total_param_bytes, plan.head_home_bytes
    bwd = list(reversed(plan.groups[1:-1])) + [plan.groups[0]]
    pass_bytes = sum(plan.group_bytes(g) for g in plan.groups) + sum(plan.group_bytes(g) for g in bwd)
    n_ex = len(plan.expert_groups)
    disk = kind == "disk_host"
    if kind == "device":  # every group passes through by reference
        w = dict(h2d_requests=0, bytes_h2d=0, unique_group_fetches=0, cache_hits=2 * n - 1,
                 disk_requests=0)
    else:
        # from disk each fetched group reads its chunk, and a head that reads
        # the embedding (tied, or codebook heads) the embed chunk too
        w = dict(h2d_requests=2 * n - 1, bytes_h2d=pass_bytes - hit * head_home,
                 unique_group_fetches=2 * n - 1, cache_hits=0,
                 disk_requests=(2 * n - 1 + int(plan.head_reads_embed) - hit) if disk else 0)
    # the backward's gradients, a D2H request a leaf; an expert group's
    # drain at its layer's non-expert group, a 0-d f32 placeholder at its own
    w.update(d2h_requests=sum(leaves[g.key] for g in bwd) + n_ex,
             bytes_d2h=total - head_home + 4 * n_ex)
    o = dict(h2d_requests=n - (kind == "device"), d2h_requests=4 * sum(leaves.values()),
             bytes_d2h=7 * total, disk_requests=n if disk else 0,
             bytes_h2d=(total - head_home) + (6 * total if kind != "device" else 0))
    return {"param": w, "opt": o}


def profile_streamed_step(step, state, batch) -> None:
    """One more streamed step under the profiler: the device's kernel and
    copy time against the wall (copies on the engine's stream overlap the
    compute, so the two may sum past the wall)."""
    from repro_torch.launch.profile_serve import _breakdown

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
    kern, cop = by.get("kernels", [0, 0]), by.get("copies", [0, 0])
    log(f"    profiled step: wall {wall * 1e3:.1f} ms; device kernels {kern[0]:.1f} ms "
        f"({kern[1]:.0f} launches), copies {cop[0]:.1f} ms ({cop[1]:.0f}); 1 - kernel ms / wall = "
        f"{1 - kern[0] / (wall * 1e3):.4f}; top: "
        + "; ".join(f"{k_['ms_per_unit']:.1f} ms x{k_['calls_per_unit']:.0f} {k_['name'][:50]}"
                    for k_ in r["top_kernels"][:6]))


def streamed_train(phase: str, cfg, plan, smi: str, runs: list, *, batch_fn, tokens: int,
                   residency=None, device: str = "cuda") -> list:
    """The streamed-weight train step from one group-wise init through
    ``runs``, each ``dict(name, kind, distance, steps)`` with an optional
    ``store`` (a disk home's spill store) and ``profile`` (one more step
    under the profiler).  The first run, at the device home, is the
    baseline: every other run's losses are its first ones and its
    parameters and moments its state after as many steps, bit for bit.
    Every step's requests and bytes of the weight passes and the optimizer
    pass are the plan's closed form, with one H2D request a fetched group
    and the streamed bytes within the budget; the walls, waits, drains and
    peak memory are logged.  ``residency`` (``ResidencyCache(0)``) turns the
    cache off, else the budget's cache may hold the head's home alone.  The
    last run takes the initial state over, so that its first step can free
    it.  Returns each run's record (its state dropped)."""
    from repro_torch.core import schedcheck as sc
    from repro_torch.core import tree as tr
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as st

    n = plan.n_groups
    budget = plan.device_budget_bytes
    cap = residency.capacity_bytes if residency is not None else plan.residency_capacity_bytes()
    max_d = plan.max_distance_for_budget(cached_bytes=cap or 0)
    report = sc.analyze_train_schedule(plan, distance=max_d, cache_capacity=cap,
                                       spill=any(r["kind"] == "disk_host" for r in runs))
    log(f"  {phase} plan: {n} groups ({plan.layout}{', expert-split' if plan.expert_stream else ''}), "
        f"{plan.total_param_bytes} B of weights, budget {budget} B, residency cache {cap} B, max "
        f"distance {max_d}; analyzed peak {report.peak_bytes} B, ok {report.ok}")
    if not report.ok or (budget is not None and report.peak_bytes > budget):
        raise SystemExit(f"{phase}: the schedule fails its analysis\n{report}")
    # the closed-form traffic holds while the cache holds the head's home
    # and no other group, or nothing
    fits = [g.key for g in plan.groups if cap is not None and plan.group_bytes(g, fetch=False) <= cap]
    if fits not in ([], [plan.groups[-1].key]):
        raise SystemExit(f"{phase}: a {cap} B cache holds other groups than the head's home: {fits}")
    head_cached = bool(fits)
    leaves = {k: len(tr.leaves(t)) for k, t in
              plan.init_home(st.abstract_params(cfg))["groups"].items()}
    if runs[0]["kind"] != "device":
        raise SystemExit(f"{phase}: the baseline run must be the device home's")
    keep = {r["steps"] for r in runs[1:]}

    free_host(device)
    t0 = time.perf_counter()
    box = {"state0": st.init_weight_streamed_state(cfg, plan, SEED, device)}
    log(f"  {phase} group-wise init of the state at the host: {time.perf_counter() - t0:.1f} s "
        f"(host MemAvailable {mem_available()} B)")

    def home(i: int, kind: str, store):
        state0 = box.pop("state0") if i == len(runs) - 1 else box["state0"]
        return (st.device_weight_streamed_state(plan, state0, device) if kind == "device" else
                st.spill_weight_streamed_state(plan, state0, store) if kind == "disk_host" else
                state0)

    records, kept = [], {}
    for i, spec in enumerate(runs):
        name, kind, steps = spec["name"], spec["kind"], spec["steps"]
        free_host(device)
        reset_peak(device)
        step = st.make_weight_streamed_train_step(
            cfg, AdamWConfig(**TRAIN_OPT), plan=plan, param_kind=kind,
            spill_store=spec.get("store"),
            prefetch=PrefetchSpec(buffer_size=n + 2, distance=spec["distance"]),
            residency=residency if kind != "device" else None, device=device)
        t0 = time.perf_counter()
        s = home(i, kind, spec.get("store"))
        r = dict(name=name, kind=kind, distance=spec["distance"], home_s=time.perf_counter() - t0,
                 losses=[], walls=[], steps=[], host_avail=mem_available())
        stats = {"param": step.param_stats, "opt": step.opt_stats}
        try:
            for k in range(steps):
                before = {w: {f: getattr(s_, f) for f in STREAM_FIELDS} for w, s_ in stats.items()}
                b = batch_fn(k)
                sync(device)
                t0 = time.perf_counter()
                s, m = step(s, b)
                r["losses"].append(float(m["loss"]))
                sync(device)
                r["walls"].append(time.perf_counter() - t0)
                r["steps"].append({w: {f: getattr(s_, f) - before[w][f] for f in STREAM_FIELDS}
                                   for w, s_ in stats.items()})
                if i == 0 and k + 1 in keep:  # the baseline's state after k + 1 steps
                    kept[k + 1] = s
            ps = step.param_stats
            r.update(peak=peak_allocated(device), streamed_peak=ps.peak_inflight_bytes,
                     max_distance=max(ps.distance_trace) if ps.distance_trace else 0,
                     fetched_per_request=ps.per_tier()["h2d"]["requests_per_fetched_device_group"],
                     hits=step.residency.hits if step.residency is not None else 0,
                     cached_peak=(step.residency.peak_resident_bytes
                                  if step.residency is not None else 0))
            if spec.get("profile") and device == "cuda":  # after the counters are read
                profile_streamed_step(step, s, batch_fn(steps))
        finally:
            step.close()
        for k, got in enumerate(r["steps"]):
            want = streamed_step_counts(plan, leaves, kind, int(head_cached and k > 0))
            for w in ("param", "opt"):
                for f, v in want[w].items():
                    if got[w][f] != v:
                        raise SystemExit(f"{phase} {name} step {k}: {w} {f} {got[w][f]}, "
                                         f"expected {v}")
        if not all(map(math.isfinite, r["losses"])):
            raise SystemExit(f"{phase} {name}: losses not finite: {r['losses']}")
        if i:
            base = records[0]["losses"][:steps]
            if r["losses"] != base:
                raise SystemExit(f"{phase} {name}: losses {r['losses']} differ from the device "
                                 f"home's {base}")
            for part in ("params", "opt"):
                for key, want in kept[steps][part]["groups"].items():
                    if not same_bits(s[part]["groups"][key], want):
                        raise SystemExit(f"{phase} {name}: {part} group {key} differs between "
                                         f"the homes (the device home's after {steps} step(s))")
            if r["fetched_per_request"] != 1.0:
                raise SystemExit(f"{phase} {name}: {r['fetched_per_request']} H2D requests a "
                                 "fetched group")
            if budget is not None and r["streamed_peak"] > budget:
                raise SystemExit(f"{phase} {name}: {r['streamed_peak']} B streamed over the "
                                 f"budget {budget} B")
        del s
        per = r["steps"]
        log(f"  {phase} {name}: losses {r['losses']}{' bitwise the device home' if i else ''}"
            f"{', parameters and moments too' if i else ''}; step walls "
            f"{[round(w * 1e3, 1) for w in r['walls']]} ms "
            f"({[round(tokens / w, 1) for w in r['walls']]} tok/s); wait "
            f"{[round((x['param']['transfer_wait_s'] + x['opt']['transfer_wait_s']) * 1e3, 1) for x in per]}"
            f" ms, drain "
            f"{[round((x['param']['writeback_drain_s'] + x['opt']['writeback_drain_s']) * 1e3, 1) for x in per]}"
            f" ms a step; H2D {per[-1]['param']['bytes_h2d']:,} + {per[-1]['opt']['bytes_h2d']:,} B "
            f"({per[-1]['param']['h2d_requests']} + {per[-1]['opt']['h2d_requests']} requests), D2H "
            f"{per[-1]['param']['bytes_d2h']:,} + {per[-1]['opt']['bytes_d2h']:,} B, disk "
            f"{per[-1]['param']['disk_requests']} + {per[-1]['opt']['disk_requests']} requests a "
            f"step (weights + optimizer), every count the plan's; peak streamed "
            f"{r['streamed_peak']} B, cached {r['cached_peak']} B, {r['hits']} residency hits; "
            f"max_memory_allocated {r['peak']} B; home placed in {r['home_s']:.1f} s; host "
            f"MemAvailable {r['host_avail']} B at the start ({smi})")
        records.append(r)
    kept.clear()
    free_host(device)
    return records


def home_pair(steps: int) -> list:
    """:func:`streamed_train`'s runs at the device home and at pinned host
    (distance auto), ``steps`` steps each."""
    return [dict(name="(device home)", kind="device", distance="auto", steps=steps),
            dict(name="(pinned host, distance auto)", kind="pinned_host", distance="auto",
                 steps=steps)]


def phase_train_streamed(cfg, ref: dict, smi: str, device="cuda",
                         budget_mb: float = W_TRAIN_BUDGET_MB, groups: int = W_TRAIN_GROUPS,
                         spill: Path = ROOT / "build" / "spill-6w") -> None:
    """Phase 6w: phase 6's model and batches through the streamed-weight train
    step, the weights, gradients and moments homed on the card, at pinned
    host and on disk under ``budget_mb``, one layer a group
    (:func:`streamed_train`, plus the streamed peak at each distance against
    the plan's window, the head's one residency hit a step, and (a)'s
    step-0 loss against phase 6's monolithic one)."""
    import shutil

    from repro_torch.core import schedcheck as sc
    from repro_torch.core.spillstore import SpillStore
    from repro_torch.core.weightstream import WeightStreamPlan
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
    if n != groups:
        raise SystemExit(f"6w: {n} groups (expected {groups})")
    bwd = list(reversed(plan.groups[1:-1])) + [plan.groups[0]]
    seqs = ([plan.group_bytes(g) for g in plan.groups], [plan.group_bytes(g) for g in bwd])

    def window(d: int) -> int:
        """Peak streamed bytes at distance ``d``: the executor holds groups
        i..i+d in flight."""
        return max(sum(q[i:i + d + 1]) for q in seqs for i in range(len(q)))

    shutil.rmtree(spill, ignore_errors=True)
    store = SpillStore(spill)
    # (b) pinned host at distance 1 and auto (last: the pinned buffers the
    # drains allocate are then warm); (c) disk, one step: the fsync'd
    # writeback of every group
    runs = [dict(name="(a) device", kind="device", distance="auto", steps=W_TRAIN_STEPS)]
    runs += [dict(name=f"(b) pinned_host d={d}", kind="pinned_host", distance=d,
                  steps=W_TRAIN_STEPS if d == "auto" else 1, profile=d == "auto")
             for d in W_TRAIN_DISTANCES]
    runs.append(dict(name="(c) disk_host", kind="disk_host", distance="auto",
                     steps=W_TRAIN_DISK_STEPS, store=store))
    try:
        recs = streamed_train("6w", tcfg, plan, smi, runs,
                              batch_fn=lambda k: train_batch(tcfg, k, device),
                              tokens=TRAIN_BATCH * TRAIN_SEQ, device=device)
    finally:
        store.close(delete=True)
        shutil.rmtree(spill, ignore_errors=True)
    a = recs[0]
    if not math.isclose(a["losses"][0], ref["losses"][0], rel_tol=RTOL, abs_tol=ATOL):
        raise SystemExit(f"6w (a): step-0 loss {a['losses'][0]} not within 2e-2 of phase 6 (a)'s "
                         f"{ref['losses'][0]}")
    for r in recs:
        peak, d = r["streamed_peak"], r["distance"]
        if r["kind"] == "device":
            ok = peak == 0
        elif d == "auto":
            ok = window(1) <= peak <= window(max_d) and r["max_distance"] <= max_d
        else:
            ok = peak == window(d)
        if not ok or not (peak <= report.peak_bytes <= budget
                          and peak + r["cached_peak"] <= budget + cap):
            raise SystemExit(f"6w {r['name']}: peak streamed {peak} B (distance {d}, at most "
                             f"{r['max_distance']}) against the plan's windows, cached "
                             f"{r['cached_peak']} B against the budget {budget} B and cache {cap} B")
        if r["kind"] != "device" and r["hits"] != len(r["losses"]) - 1:
            raise SystemExit(f"6w {r['name']}: {r['hits']} residency hits, expected "
                             f"{len(r['losses']) - 1}")
    auto = next(r for r in recs if r["distance"] == "auto" and r["kind"] == "pinned_host")
    # what phase 8c (b) holds its sharded step against
    write_w6_result(auto["losses"][0], auto["walls"][0], n,
                    {w: auto["steps"][0][w]["h2d_requests"] for w in ("param", "opt")})
    log(f"  6w: (a)'s step-0 loss {a['losses'][0]} against phase 6 (a)'s monolithic "
        f"{ref['losses'][0]} (|diff| {abs(a['losses'][0] - ref['losses'][0]):.3e}); peak streamed "
        f"at d=1 the plan's window {window(1)} B, at auto within "
        f"[{window(1)}, {window(max_d)}] B; the head's home one residency hit a step after the "
        f"first; max_memory_allocated beside phase 6 (a)'s {ref['peak']} B")
    log(f"  phase 6w done in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 2x, 6x, 6m: the xLSTM family served and trained, and MoE training
# with the experts streamed
# ---------------------------------------------------------------------------

def profile_ms(fn, wall_s: Optional[float] = None) -> dict:
    """``fn()`` once under the profiler, tracing the card alone (a train
    step's million launches would cost as many host-side records): device
    busy ms, kernel launches and the idle share against ``wall_s`` (else the
    profiled run's own wall)."""
    from repro_torch.launch.profile_serve import _breakdown

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        own = time.perf_counter() - t0
    r = _breakdown(prof, wall_s or own, 1, 8)
    r["profiled_wall_ms"] = own * 1e3
    return r


def phase_xlstm_serve(smi: str, device: str = "cuda", full=None) -> None:
    """Phase 2x: full-width xlstm-1.3b served in lock-step through the entry
    point (``full`` and ``device="cpu"`` rehearse it at another size)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tr
    from repro_torch.launch import serve as sv
    from repro_torch.models import xlstm
    from repro_torch.models.rglru import _causal_conv
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    whole = full or get_config("xlstm-1.3b")
    n_params = sum(x.numel() for x in tr.leaves(st.abstract_params(whole)))
    cfg = dataclasses.replace(whole, n_layers=min(XL_SERVE_LAYERS, whole.n_layers))
    log(f"phase 2x serve {cfg.name}: {cfg.n_layers} of {whole.n_layers} layers "
        f"({cfg.n_layers // cfg.slstm_every} periods of {cfg.slstm_every - 1} mLSTM + sLSTM), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"tied, {cfg.dtype}; {n_params:,} parameters at {whole.n_layers} layers; "
        f"batch {XL_BATCH}, prompt {XL_PROMPT} (chunks of {cfg.mlstm_chunk}), gen {XL_GEN}, "
        f"lock-step, device-resident; {smi}")
    if full is None and n_params != XL_PARAMS:
        raise SystemExit(f"2x: xlstm-1.3b has {n_params} parameters, not {XL_PARAMS}")
    since = [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        dt, since[0] = now - since[0], now
        return dt

    params = st.init_params(cfg, SEED, device)
    log(f"  weights drawn on the {device} in {lap():.1f} s")
    wrappers = serving_kernels()
    runs = []
    for i in range(2):
        reset_peak(device)
        for w in wrappers.values():
            w.launches = 0
        res = sv.serve(cfg, batch=XL_BATCH, prompt_len=XL_PROMPT, gen=XL_GEN, kv_page_len=0,
                       seed=SEED, params=params, device=device)
        launches = {k: w.launches for k, w in wrappers.items()}
        walls = sorted(res["step_walls"])
        log(f"  run {i + 1}: prefill {res['prefill_s'] * 1e3:.3f} ms for {XL_BATCH} requests, decode "
            f"{res['decode_s'] * 1e3 / max(res['n_steps'], 1):.3f} ms a step (median host "
            f"{walls[len(walls) // 2] * 1e3:.3f} ms) over {res['n_steps']} steps, "
            f"{res['tokens_per_s']:.1f} tok/s; max_memory_allocated {peak_allocated(device)} B; "
            f"launches {launches} (the xLSTM path reaches no hand-written kernel, as in the JAX "
            f"package) ({lap():.1f} s)")
        runs.append(res)
    gen = runs[0]["generated"]
    if gen.shape != (XL_BATCH, XL_GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"2x: generated tokens malformed: {gen.shape}")
    if not np.array_equal(gen, runs[1]["generated"]):
        raise SystemExit("2x: a second serve of the same weights and prompts gave other tokens")
    log(f"  tokens bitwise equal across the two runs; first request {gen[0, :8].tolist()}...")
    if device == "cuda":
        serve_rooflines("2x (run 2)", cfg, runs[1], XL_PROMPT, smi)

    # (b) prefill then decode against the longer prefill: the decode steps
    # carry the state across the last chunk of the prompt
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    toks = torch.randint(1, cfg.vocab_size, (XL_BATCH, XL_PROMPT), generator=g, device=device)
    head = XL_PROMPT - cfg.mlstm_chunk
    la, _ = st.make_prefill_step(cfg, XL_BATCH, XL_PROMPT + 2)(params, {"tokens": toks})
    _, caches = st.make_prefill_step(cfg, XL_BATCH, XL_PROMPT + 2)(params, {"tokens": toks[:, :head]})
    decode = st.make_decode_step(cfg)
    for t in range(head, XL_PROMPT):
        lb, caches = decode(params, caches, {"tokens": toks[:, t:t + 1]},
                            sv.step_pos(cfg, XL_BATCH, t, device))
    la, lb = la.float(), lb.float()
    if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
        raise SystemExit("2x: logits are not finite")
    rel = max_err(la, lb) / la.abs().max().item()
    same = bool((la.argmax(-1) == lb.argmax(-1)).all())
    log(f"  (b) prefill {head} + {XL_PROMPT - head} decode steps against a prefill of {XL_PROMPT}: "
        f"max |diff| / max |logit| = {rel:.3e} (limit {LOGIT_RTOL}), same greedy tokens: {same} "
        f"({lap():.1f} s)")
    if rel > LOGIT_RTOL:
        raise SystemExit("2x (b): prefill-then-decode disagrees with the longer prefill")
    del caches, la, lb

    # (c) one full-width mLSTM layer in f32: the chunkwise form against the
    # sequential oracle
    p = {k: v[0].float() for k, v in params.as_dict()["blocks"]["periods"]["pos_0"]["mlstm"].items()}
    x = torch.randn(2, XL_PROMPT, cfg.d_model, generator=g, device=device)
    u, _ = torch.chunk(x @ p["w_up"], 2, dim=-1)
    uc, _ = _causal_conv({"conv": p["conv"]}, u)
    q, k, v, li, lf = xlstm._mlstm_qkv_gates(cfg, p, u, torch.nn.functional.silu(uc))
    hc, sc_ = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk=cfg.mlstm_chunk)
    hs, ss = xlstm.mlstm_sequential(q, k, v, li, lf)
    check_close(f"2x mLSTM layer 0 chunkwise vs sequential, f32 {tuple(q.shape)} -> "
                f"{tuple(hc.shape)}", hc, hs, rtol=2e-4, atol=2e-3)
    for name in ("C", "n", "m"):
        check_close(f"2x mLSTM final state {name}", sc_[name], ss[name], rtol=2e-4, atol=2e-3)
    log(f"  (c) {lap():.1f} s")
    del p, x, u, uc, q, k, v, hc, hs, sc_, ss

    # (d) where the batch's prefill and one decode step spend the card:
    # device busy against the unprofiled wall, launches (a trace of the
    # card alone; phase_xlstm_profile runs profile_serve's fuller one)
    if device == "cuda":
        box = {}

        def prefill():
            box["first"], box["caches"] = sv.prefill_all(cfg, params, toks, XL_PROMPT + 2)

        def step():
            decode(params, box["caches"], {"tokens": box["first"].long()[:, None]},
                   sv.step_pos(cfg, XL_BATCH, XL_PROMPT, device))

        for name, fn in (("prefill (the batch, lock-step)", prefill), ("decode step", step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = profile_ms(fn, wall)
            idle = r["device_idle_share"]
            log(f"  (d) {name}: wall {wall * 1e3:.3f} ms, device busy "
                f"{r['device_busy_ms_per_unit']:.3f} ms, idle share "
                f"{'not measured' if idle is None else f'{idle:.3f}'}, "
                f"{r['kernel_launches_per_unit']:.0f} launches")
        del box
        log(f"  (d) {lap():.1f} s")
    del params

    log(f"  phase 2x done in {time.perf_counter() - t_phase:.1f} s")


def slstm_share(cfg, step_prof: dict) -> None:
    """The sLSTM layers' part of one profiled train step: one sLSTM block at
    the train shape, run as the step runs it under ``remat="full"`` (its
    forward without gradients, then the recomputed forward and the
    backward), profiled alone and scaled by the step's sLSTM layers."""
    from repro_torch.core import tree as tr
    from repro_torch.models import xlstm

    n_s = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.n_layers))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p = xlstm.init_slstm_block(cfg, generator=gen, device="cuda")
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=gen, device="cuda").to(cfg.compute_dtype)

    flat, treedef = tr.flatten(p)

    def block():
        with torch.no_grad():
            xlstm.slstm_block_train(cfg, p, x)
        leaves = [t.detach().requires_grad_(True) for t in flat]
        xi = x.detach().requires_grad_(True)
        out, _ = xlstm.slstm_block_train(cfg, tr.unflatten(treedef, leaves), xi)
        torch.autograd.grad(out.float().sum(), [xi, *leaves])

    block()  # warm-up
    r = profile_ms(block)
    launches, ms = r["kernel_launches_per_unit"] * n_s, r["device_busy_ms_per_unit"] * n_s
    log(f"  (a) the sLSTM loop: one block at ({TRAIN_BATCH}, {TRAIN_SEQ}, {cfg.d_model}) takes "
        f"{r['kernel_launches_per_unit']:.0f} launches and {r['device_busy_ms_per_unit']:.3f} device "
        f"ms (forward, recomputed forward, backward; host wall {r['profiled_wall_ms']:.1f} ms); "
        f"x {n_s} sLSTM layers = {launches:.0f} launches ({launches / step_prof['kernel_launches_per_unit']:.3f}"
        f" of the step's {step_prof['kernel_launches_per_unit']:.0f}) and {ms:.1f} device ms "
        f"({ms / step_prof['device_busy_ms_per_unit']:.3f} of the step's "
        f"{step_prof['device_busy_ms_per_unit']:.1f})")


def phase_xlstm_train(smi: str) -> None:
    """Phase 6x: full-width xlstm-1.3b trained on the card (the AdamW state on
    the card), then through the streamed-weight step on its period layout
    under a budget of its distance-1 floor rounded up."""
    from repro_torch.configs import get_config
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    tcfg = train_cfg(get_config("xlstm-1.3b"))
    tokens = TRAIN_BATCH * XL_SEQ
    since = [t_phase]

    def lap() -> float:
        now = time.perf_counter()
        dt, since[0] = now - since[0], now
        return dt

    log(f"phase 6x train {tcfg.name}: {XL_PARAMS:,} parameters, {tcfg.dtype}, remat={tcfg.remat}, "
        f"loss_chunk {tcfg.loss_chunk}; batch {TRAIN_BATCH}, seq {XL_SEQ}, AdamW {TRAIN_OPT}; "
        f"{smi}")
    reset_peak("cuda")
    a = train_run(tcfg, ROOT / "build" / "train-ckpt-x", steps=XL_TRAIN_STEPS, seq=XL_SEQ)
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in a["losses"]]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"6x (a): losses not finite or not falling: {losses}")
    wall = median(a["walls"][1:])
    flops = roofline_line("6x (a)", tcfg, "train", XL_SEQ, TRAIN_BATCH, wall, smi)
    log(f"  (a) AdamW on the card, {XL_TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}; "
        f"step walls {[round(w * 1e3, 1) for w in a['walls']]} ms, median of steps 1-"
        f"{XL_TRAIN_STEPS - 1} {wall * 1e3:.1f} ms = {tokens / wall:.1f} tok/s, model "
        f"{flops / wall / 1e12:.2f} TFLOP/s (model_flops: 6 N T); max_memory_allocated {peak} B "
        f"({lap():.1f} s)")
    del a
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the streamed-weight step on the period layout, cut in depth
    tcfg = dataclasses.replace(tcfg, n_layers=XL_W_LAYERS)
    free = WeightStreamPlan(tcfg, st.abstract_params(tcfg), layers_per_group=1)
    floor = free.peak_device_bytes(1)
    budget_mb = math.ceil(floor / 1e8) * 100
    plan = WeightStreamPlan(tcfg, st.abstract_params(tcfg), layers_per_group=1,
                            device_budget_mb=budget_mb)
    log(f"  (b) {XL_W_LAYERS} layers, budget {budget_mb} MB: the period plan's distance-1 floor "
        f"{floor} B rounded up to 100 MB, against {plan.total_param_bytes} B of bf16 weights")
    if plan.layout != "period" or not budget_mb * 1e6 < plan.total_param_bytes:
        raise SystemExit(f"6x (b): layout {plan.layout}, budget {budget_mb} MB")
    streamed_train("6x (b)", tcfg, plan, smi, home_pair(XL_W_STEPS),
                   batch_fn=lambda k: train_batch(tcfg, k, seq=XL_SEQ), tokens=tokens)
    log(f"  phase 6x done in {time.perf_counter() - t_phase:.1f} s")


def phase_xlstm_profile(smi: str) -> None:
    """Where xlstm-1.3b's time goes on the card (not run by :func:`main`:
    its profiles of a train step's ~770,000 launches take ~5 minutes; a
    script under ``build/`` that imports this module calls it): one train
    step with the AdamW state on the card under the profiler (device busy,
    idle share against the step's wall, launches, top kernels), the sLSTM
    loop's part of it (:func:`slstm_share`), and ``profile_serve --arch
    xlstm-1.3b`` (prefill and decode)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import profile_serve
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as st

    tcfg = train_cfg(get_config("xlstm-1.3b"))
    log(f"xlstm-1.3b profiles: train batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat={tcfg.remat}; {smi}")
    step_fn = st.make_train_step(tcfg, AdamWConfig(**TRAIN_OPT))
    params, opt = st.init_train_state(tcfg, SEED, "cuda")
    box = {}
    for k in range(3):  # warm, then two timed steps
        batch = train_batch(tcfg, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        box.setdefault("walls", []).append(time.perf_counter() - t0)
    wall = min(box["walls"][1:])

    def one():
        box["out"] = step_fn(params, opt, batch)

    r = profile_ms(one, wall)
    idle = r["device_idle_share"]
    log(f"  train step: walls {[round(w * 1e3, 1) for w in box['walls']]} ms; profiled: device busy "
        f"{r['device_busy_ms_per_unit']:.1f} ms of the {wall * 1e3:.1f} ms wall, idle share "
        f"{'not measured' if idle is None else f'{idle:.4f}'}, {r['kernel_launches_per_unit']:.0f} "
        f"kernel launches; top kernels: "
        + "; ".join(f"{k['ms_per_unit']:.1f} ms x{k['calls_per_unit']:.0f} {k['name'][:40]}"
                    for k in r["top_kernels"][:6]))
    del params, opt, box
    gc.collect()
    torch.cuda.empty_cache()
    slstm_share(tcfg, r)
    argv = sys.argv
    sys.argv = ["profile_serve", "--arch", tcfg.name, "--batch", str(XL_BATCH), "--prompt-len",
                str(XL_PROMPT)]
    try:
        log(f"  profile_serve --arch {tcfg.name} --batch {XL_BATCH} --prompt-len {XL_PROMPT}:")
        profile_serve.main()
    finally:
        sys.argv = argv


def phase_moe_train(smi: str, device: str = "cuda", full=None) -> None:
    """Phase 6m: full-width mixtral-8x7b, cut to ``MT_LAYERS``, trained with
    ``expert_stream=True`` at the device home and at pinned host (``full``
    and ``device="cpu"`` rehearse it at another size)."""
    from repro_torch.configs import get_config
    from repro_torch.core.residency import ResidencyCache
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.data import SyntheticConfig, synthetic_batch
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    cfg = train_cfg(dataclasses.replace(full or get_config("mixtral-8x7b"), n_layers=MT_LAYERS))
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), expert_stream=True)
    n_params = plan.total_param_bytes // 2
    log(f"phase 6m train {cfg.name} with expert_stream=True: {MT_LAYERS} layer(s) of d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts of d_ff "
        f"{cfg.d_ff} top-{cfg.moe_top_k}; {n_params:,} parameters ({16 * n_params} B of weights, "
        f"gradients, masters and moments); batch {MT_BATCH}, seq {MT_SEQ}, {MT_STEPS} steps; the "
        f"residency cache off, so every group is fetched in each pass; {smi}")
    fits, avail = moe_home_fits(plan, 14 * n_params + MOE_HOST_MARGIN)
    if not fits:
        raise SystemExit(f"6m: this machine's host cannot hold two homes of weights and moments "
                         f"({28 * n_params} B) with {MOE_HOST_MARGIN} B to spare ({avail} B available)")
    sc_ = SyntheticConfig(cfg.vocab_size, MT_SEQ, MT_BATCH, seed=SEED)

    def batch_fn(k):
        return {name: v.to(device) for name, v in synthetic_batch(cfg, sc_, k).items()}

    streamed_train("6m", cfg, plan, smi, home_pair(MT_STEPS), batch_fn=batch_fn,
                   tokens=MT_BATCH * MT_SEQ, residency=ResidencyCache(0), device=device)
    log(f"  6m expert groups: {len(plan.expert_groups)} of {plan.per_expert_bytes} B; a pinned "
        f"step fetches each twice (forward, backward), {2 * len(plan.expert_groups) * plan.per_expert_bytes} B")
    log(f"  phase 6m done in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 2a, 6a, 6v: the modality front ends (musicgen-medium's codebooks and
# sinusoidal positions, qwen2-vl-72b's vision prefix and M-RoPE)
# ---------------------------------------------------------------------------

def disk_free(path: Path) -> int:
    """Free bytes of the file system that holds ``path``."""
    import shutil

    path.mkdir(parents=True, exist_ok=True)
    return shutil.disk_usage(path).free


def phase_audio_serve(smi: str, device: str = "cuda", full=None) -> dict:
    """Phase 2a: full-width musicgen-medium (or ``full``) served through
    ``serve``: unpaged (the baseline), paged at device, pinned-host and disk
    pages, and with the weights streamed from pinned host and disk.
    Returns (a)'s kernel launches (for phase 5)."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.launch import serve as sv
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(full or get_config("musicgen-medium"), attn_impl="pallas")
    on_card = device == "cuda"
    abstract = st.abstract_params(cfg)
    n_params = sum(int(np.prod(x.shape)) for x in _leaves(abstract))
    log(f"phase 2a serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, {cfg.n_codebooks} "
        f"codebooks of {cfg.vocab_size}, {cfg.pos_type} positions, {cfg.dtype}; {n_params:,} "
        f"parameters; batch {BATCH}, prompt {PROMPT}, gen {GEN}; {smi}")
    params = st.init_params(cfg, SEED, device)
    kernels = ("flash_attention", "decode_attention")
    wrappers = serving_kernels()

    def run(name: str, gen: int = GEN, **kw) -> tuple[dict, dict]:
        """One serve through the entry point, the launch counts zeroed just
        before and read just after."""
        reset_peak(device)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = sv.serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=gen, seed=SEED, params=params,
                       device=device, **kw)
        launches = {k: wrappers[k].launches for k in kernels}
        if on_card and min(launches.values()) <= 0:
            raise SystemExit(f"2a {name}: a kernel of the path was not launched: {launches}")
        st_ = res["stats"]
        log(f"  {name}: prefill {res['prefill_s'] * 1e3:.3f} ms for {BATCH} requests, decode "
            f"{res['decode_s'] * 1e3 / max(res['n_steps'], 1):.3f} ms a step ({res['n_steps']} "
            f"steps), {res['tokens_per_s']:.1f} tok/s; KV h2d {st_.h2d_requests} req / "
            f"{st_.bytes_h2d} B over {st_.n_groups} groups, disk {st_.disk_requests} req; "
            f"max_memory_allocated {peak_allocated(device)} B; launches {launches} "
            f"({time.perf_counter() - t0:.1f} s)")
        return res, launches

    def same(name, got, want):
        if not np.array_equal(got, want):
            raise SystemExit(f"2a {name}: tokens differ from (a)'s")

    # (a) the unpaged baseline
    a, la = run("(a) unpaged, device caches", kv_kind="device", kv_page_len=0)
    gen = a["generated"]
    if gen.shape != (BATCH, GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"2a (a): generated tokens malformed: shape {gen.shape}, range "
                         f"[{gen.min()}, {gen.max()}]")
    log(f"  (a) first request's codebook-0 stream {gen[0, :8].tolist()}...")
    if on_card:
        serve_rooflines("2a (a)", cfg, a, PROMPT, smi)
    # the kernel path against the plain path on request 0 (serve's prompts)
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, (BATCH, PROMPT),
                                                      dtype=np.int32)
    prompt = torch.as_tensor(prompts[:1], device=device)
    out = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            logits, caches = st.make_prefill_step(c, 1, PROMPT + 2)(params,
                                                                  sv._prompt_batch(c, prompt))
            first = sv._greedy(logits)  # (1, K)
            logits2, _ = st.make_decode_step(c)(params, caches, sv._step_batch(c, first, device),
                                                sv.step_pos(c, 1, PROMPT, device))
            out[impl] = (logits.float(), logits2.float(), first, sv._greedy(logits2))
            del caches
    for i, step in enumerate(("prefill", "decode")):
        k_, p_ = out["pallas"][i], out["xla"][i]
        if k_.shape != (1, cfg.n_codebooks, 1, cfg.vocab_size):
            raise SystemExit(f"2a {step} logits of shape {tuple(k_.shape)}")
        if not (torch.isfinite(k_).all() and torch.isfinite(p_).all()):
            raise SystemExit(f"2a {step} logits are not finite")
        rel = max_err(k_, p_) / p_.abs().max().item()
        log(f"  (a) {step} logits (1, {cfg.n_codebooks}, 1, {cfg.vocab_size}), kernel path vs "
            f"plain path: max |diff| / max |logit| = {rel:.3e} (limit {LOGIT_RTOL}), same greedy "
            f"tokens: {bool((k_.argmax(-1) == p_.argmax(-1)).all())}")
        if rel > LOGIT_RTOL:
            raise SystemExit(f"2a {step} logits of the kernel path disagree with the plain path")
    # serve prefills request by request: its first token is this prefill's
    if int(out["pallas"][2][0, 0]) != gen[0, 0]:
        raise SystemExit(f"2a: the kernel path's first codebook-0 token "
                         f"{int(out['pallas'][2][0, 0])} is not serve's {gen[0, 0]}")
    del out

    # (b) the paged session at each page home
    spill = ROOT / "build" / "spill-audio"
    page = dict(kv_page_len=PAGE_LEN, hot_pages=HOT_PAGES, distance="auto")
    for kind, g in (("device", GEN), ("pinned_host", AU_W_GEN), ("disk_host", AU_DISK_GEN)):
        shutil.rmtree(spill, ignore_errors=True)
        res, launches = run(f"(b) paged, {kind} pages", kv_kind=kind, gen=g,
                            spill_dir=str(spill) if kind == "disk_host" else None, **page)
        shutil.rmtree(spill, ignore_errors=True)
        same(f"(b) {kind}", res["generated"], gen[:, :g])
        st_ = res["stats"]
        if kind == "device":
            if st_.h2d_requests or st_.d2h_requests or launches != la:
                raise SystemExit(f"2a (b) device pages: {st_.h2d_requests} H2D, "
                                 f"{st_.d2h_requests} D2H requests, launches {launches} against "
                                 f"(a)'s {la}")
            continue
        if not (st_.h2d_requests == st_.n_groups > 0 and st_.disk_requests == (
                st_.n_groups if kind == "disk_host" else 0)):
            raise SystemExit(f"2a (b) {kind}: {st_.h2d_requests} H2D and {st_.disk_requests} "
                             f"disk requests for {st_.n_groups} page groups")
        if not res["peak_resident_bytes"] < res["total_cache_bytes"]:
            raise SystemExit(f"2a (b) {kind}: the device retained the whole cache")

    # (c) the weights streamed from pinned host, then disk, the cache off
    floor = WeightStreamPlan(cfg, abstract, layers_per_group=1).peak_device_bytes(1)
    budget_mb = math.ceil(floor / 1e8) * 100
    log(f"  (c) budget {budget_mb} MB: the one-layer plan's distance-1 floor {floor} B rounded "
        f"up to 100 MB, the residency cache off")
    for kind, g in (("pinned_host", AU_W_GEN), ("disk_host", AU_DISK_GEN)):
        shutil.rmtree(spill, ignore_errors=True)
        res, launches = run(f"(c) weights at {kind}", gen=g, kv_kind="device", kv_page_len=0,
                            param_kind=kind, device_budget_mb=budget_mb, param_cache_mb=0,
                            spill_dir=str(spill) if kind == "disk_host" else None)
        shutil.rmtree(spill, ignore_errors=True)
        same(f"(c) {kind}", res["generated"], gen[:, :g])
        ps, plan = res["param_stats"], res["param_plan"]
        runs = BATCH + g  # a prefill a request, the warm-up step, g - 1 decode steps
        fetches = runs * plan.n_groups
        pass_bytes = sum(plan.fetch_sequence_bytes())
        checks = {
            "passes": (ps.n_runs, runs),
            "groups fetched": (ps.unique_group_fetches, fetches),
            "h2d_requests": (ps.h2d_requests, fetches),
            "bytes_h2d": (ps.bytes_h2d, runs * pass_bytes),
            "cache_hits": (ps.cache_hits, 0),
            # the codebook heads' group reads the embed chunk beside its own
            "disk_requests": (ps.disk_requests, fetches + runs if kind == "disk_host" else 0),
        }
        for what, (got, want) in checks.items():
            if got != want:
                raise SystemExit(f"2a (c) {kind}: {what} {got}, the plan's {want}")
        if not (ps.peak_inflight_bytes <= budget_mb * 1e6
                and (budget_mb * 1e6 < plan.total_param_bytes or not on_card)):
            raise SystemExit(f"2a (c) {kind}: streamed {ps.peak_inflight_bytes} B against the "
                             f"budget {budget_mb} MB and {plan.total_param_bytes} B of weights")
        log(f"    {plan.n_groups} groups ({plan.layers_per_group} layer(s) each), {runs} passes of "
            f"{pass_bytes} B: {ps.h2d_requests} H2D requests / {ps.bytes_h2d} B, "
            f"{ps.disk_requests} disk requests, the plan's; peak streamed "
            f"{ps.peak_inflight_bytes} B; transfer wait {ps.transfer_wait_s:.3f} s")
    del params
    log(f"  phase 2a done in {time.perf_counter() - t_phase:.1f} s")
    return la


def _leaves(tree) -> list:
    from repro_torch.core import tree as tr

    return tr.leaves(tree)


def phase_audio_train(smi: str, device: str = "cuda", full=None) -> None:
    """Phase 6a: full-width musicgen-medium (or ``full``) trained with the
    AdamW state on the card, then through the streamed-weight step at the
    device and pinned-host homes."""
    from repro_torch.configs import get_config
    from repro_torch.core.residency import ResidencyCache
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import model_flops
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    tcfg = train_cfg(full or get_config("musicgen-medium"))
    abstract = st.abstract_params(tcfg)
    n_params = sum(x.numel() for x in _leaves(abstract))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 6a train {tcfg.name}: {n_params:,} parameters, {tcfg.n_codebooks} codebooks, "
        f"{tcfg.dtype}, remat={tcfg.remat}, loss_chunk {tcfg.loss_chunk}; batch {TRAIN_BATCH}, "
        f"seq {TRAIN_SEQ}, AdamW {TRAIN_OPT}; {smi}")
    reset_peak(device)
    step_fn = st.make_train_step(tcfg, AdamWConfig(**TRAIN_OPT))
    params, opt = st.init_train_state(tcfg, SEED, device)
    losses, walls = [], []
    for k in range(AU_TRAIN_STEPS):
        batch = train_batch(tcfg, k, device)
        sync(device)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        sync(device)
        walls.append(time.perf_counter() - t0)
    peak = peak_allocated(device)
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"6a (a): losses not finite: {losses}")
    wall = median(walls[1:])
    idle = "not measured"
    if device == "cuda":
        batch = train_batch(tcfg, AU_TRAIN_STEPS, device)
        r = profile_ms(lambda: step_fn(params, opt, batch), wall)
        idle = (f"device busy {r['device_busy_ms_per_unit']:.1f} ms of the {wall * 1e3:.1f} ms "
                f"wall, idle share {r['device_idle_share']:.4f}, "
                f"{r['kernel_launches_per_unit']:.0f} kernel launches")
    flops = model_flops(tcfg, "train", TRAIN_SEQ, TRAIN_BATCH)
    if device == "cuda":
        roofline_line("6a (a)", tcfg, "train", TRAIN_SEQ, TRAIN_BATCH, wall, smi)
    log(f"  (a) AdamW on the card, {AU_TRAIN_STEPS} steps: losses {losses} (falling: "
        f"{losses[-1] < losses[0]}); step walls {[round(w * 1e3, 1) for w in walls]} ms, median "
        f"of steps 1-{AU_TRAIN_STEPS - 1} {wall * 1e3:.1f} ms = {tokens / wall:.1f} tok/s, model "
        f"{flops / wall / 1e12:.2f} TFLOP/s (model_flops: 6 N T); {idle}; max_memory_allocated "
        f"{peak} B ({smi})")
    del params, opt, step_fn
    gc.collect()
    reset_peak(device)

    # (b) the streamed-weight step cut in depth, one layer a group, the cache
    # off, against the monolithic loss on the same weights
    bcfg = dataclasses.replace(tcfg, n_layers=min(AU_W_LAYERS, tcfg.n_layers))
    with torch.no_grad():
        whole = st.init_params(bcfg, SEED, device)
        mono = float(transformer.lm_loss(bcfg, whole, train_batch(bcfg, 0, device))[0])
    del whole
    reset_peak(device)
    abstract = st.abstract_params(bcfg)
    floor = WeightStreamPlan(bcfg, abstract, layers_per_group=1).peak_device_bytes(1)
    budget_mb = math.ceil(floor / 1e8) * 100
    plan = WeightStreamPlan(bcfg, abstract, layers_per_group=1, device_budget_mb=budget_mb)
    log(f"  (b) {bcfg.n_layers} layers, budget {budget_mb} MB: the plan's distance-1 floor "
        f"{floor} B rounded up to 100 MB, against {plan.total_param_bytes} B of bf16 weights; "
        f"the codebook heads' group reads the embedding: {plan.head_reads_embed}")
    b = streamed_train("6a (b)", bcfg, plan, smi, home_pair(AU_W_STEPS),
                       batch_fn=lambda k: train_batch(bcfg, k, device), tokens=tokens,
                       residency=ResidencyCache(0), device=device)[0]
    if b["losses"][0] != mono:
        raise SystemExit(f"6a (b): the streamed step-0 loss {b['losses'][0]} is not the "
                         f"monolithic lm_loss {mono}")
    log(f"  (b) step-0 loss {b['losses'][0]} bitwise the monolithic lm_loss on the same weights")
    log(f"  phase 6a done in {time.perf_counter() - t_phase:.1f} s")


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


VL_RESULT = ROOT / "build" / "phase-6v.json"


def pinned(n: int) -> int:
    """Host bytes of an ``n``-byte page-locked buffer: exact from
    ``EXACT_PIN_BYTES`` up (``engine.page_locked_empty`` registers them),
    else the CUDA host allocator's power of two."""
    from repro_torch.core.engine import EXACT_PIN_BYTES

    return n if n >= EXACT_PIN_BYTES else 1 << max(n - 1, 0).bit_length()


def streamed_home_need(plan) -> tuple[dict, str]:
    """Host bytes (with ``VL_HOST_MARGIN``) a donated streamed-weight step of
    ``plan`` holds at its peak, at each home, and the disk bytes of the disk
    home; and how they were reckoned.  The optimizer pass runs one group at a
    time (head, the layers backwards, embed): at group i the host holds the
    old moments and gradients of groups i.. (the old weights went after the
    backward), group i's staging or its drains (the staging goes once the
    group has landed), and the new home of the groups before it (pinned
    host: in those drains; disk: on disk, group i's chunk copied out of its
    drains as it is written)."""
    from repro_torch.core import tree as tr
    from repro_torch.core.engine import EXACT_PIN_BYTES
    from repro_torch.train import steps as st

    home = plan.init_home(st.abstract_params(plan.cfg))["groups"]
    leaves = {k: [x.numel() * x.element_size() for x in tr.leaves(t)] for k, t in home.items()}
    order = [plan.groups[-1].key] + [g.key for g in reversed(plan.groups[:-1])]
    size = {k: sum(v) for k, v in leaves.items()}
    drains = {k: sum(pinned(b) + 3 * pinned(2 * b) for b in v) for k, v in leaves.items()}
    grads = {k: 0 if k == order[0] else sum(pinned(b) for b in v) for k, v in leaves.items()}
    staging = {k: pinned((6 if k == order[0] else 7) * size[k]) for k in order}
    peaks = {
        "pinned_host": max(sum(6 * size[j] + grads[j] for j in order[i:])
                           + max(staging[k], drains[k]) + sum(drains[j] for j in order[:i])
                           for i, k in enumerate(order)) + VL_HOST_MARGIN,
        "disk_host": max(sum(grads[j] for j in order[i:])
                         + max(staging[k] + 6 * size[k], drains[k] + 7 * size[k])
                         for i, k in enumerate(order)) + VL_HOST_MARGIN,
    }
    peaks["disk"] = 7 * plan.total_param_bytes + max(7 * n for n in size.values())
    return peaks, (f"page-locked blocks exact from {EXACT_PIN_BYTES} B, else powers of two; "
                   f"drains {sum(drains.values())} B, the largest staging "
                   f"{max(staging.values())} B; margin {VL_HOST_MARGIN} B")


def phase_vlm_train(smi: str, device: str = "cuda", full=None) -> None:
    """Phase 6v: full-width qwen2-vl-72b (or ``full``) cut in depth: the
    no-gradient forward and loss at ``VL_LAYERS`` layers, kernel path
    against plain path; one streamed-weight train step at ``VL_W_LAYERS``
    layer(s), its loss bitwise the monolithic ``lm_loss``'s under the same
    weights.  Writes the flash kernel's launches to ``VL_RESULT`` for
    phase 5."""
    import shutil

    from repro_torch.configs import get_config, vision_prefix_len
    from repro_torch.core import tree as tr
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.residency import ResidencyCache
    from repro_torch.core.spillstore import SpillStore
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.data import SyntheticConfig, synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as st

    t_phase = time.perf_counter()
    base = full or get_config("qwen2-vl-72b")
    s_img = vision_prefix_len(base, VL_TEXT)

    def batch_for(c) -> dict:
        sc_ = SyntheticConfig(c.vocab_size, VL_TEXT, VL_BATCH, seed=SEED)
        return {k: v.to(device) for k, v in synthetic_batch(c, sc_, 0).items()}

    # (a) the no-gradient forward at VL_LAYERS layers, kernel path vs plain
    c2 = dataclasses.replace(base, n_layers=VL_LAYERS, loss_chunk=512)
    n2 = sum(x.numel() for x in _leaves(st.abstract_params(c2)))
    log(f"phase 6v {base.name}: d_model {base.d_model}, {base.n_heads}/{base.n_kv_heads} heads, "
        f"head_dim {base.head_dim}, d_ff {base.d_ff}, vocab {base.vocab_size}, M-RoPE sections "
        f"{base.mrope_sections}, qkv bias {base.qkv_bias}; batch {VL_BATCH} x ({VL_TEXT} text + "
        f"{s_img} vision) positions; {smi}")
    reset_peak(device)
    t0 = time.perf_counter()
    params = st.init_params(c2, SEED, device)
    batch = batch_for(c2)
    if tuple(batch["positions_3d"].shape) != (VL_BATCH, 3, VL_TEXT + s_img):
        raise SystemExit(f"6v: positions_3d of shape {tuple(batch['positions_3d'].shape)}")
    out, walls = {}, {}
    with torch.no_grad():
        # the plain path first: the process's first lm_loss pays the caching
        # allocator's first allocations (the chunked loss's f32 logits), so the
        # kernel path's wall, read against its bound, is a warm one
        for impl in ("xla", "pallas"):
            c = dataclasses.replace(c2, attn_impl=impl)
            flash_attention.launches = 0
            logits, _ = transformer.forward_train(c, params, batch)
            sync(device)
            t_loss = time.perf_counter()
            loss, aux = transformer.lm_loss(c, params, batch)
            sync(device)
            walls[impl] = time.perf_counter() - t_loss
            out[impl] = (logits[:, -VL_TEXT:].float(), float(loss), int(aux["n_tokens"]),
                         flash_attention.launches)
            del logits
    launches = out["pallas"][3]  # the forward's and the loss's, a layer each
    if device == "cuda" and (launches != 2 * VL_LAYERS or out["xla"][3]):
        raise SystemExit(f"6v (a): flash launched {launches} times on the kernel path (expected "
                         f"{2 * VL_LAYERS}), {out['xla'][3]} on the plain path")
    lk, lp = out["pallas"][0], out["xla"][0]
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise SystemExit("6v (a): logits are not finite")
    rel = max_err(lk, lp) / lp.abs().max().item()
    dloss = abs(out["pallas"][1] - out["xla"][1]) / abs(out["xla"][1])
    log(f"  (a) {VL_LAYERS} layers, {n2:,} parameters (init {time.perf_counter() - t0:.1f} s): "
        f"lm_loss kernel path {out['pallas'][1]} vs plain {out['xla'][1]} (relative "
        f"{dloss:.3e}), text logits max |diff| / max |logit| = {rel:.3e} (limit {LOGIT_RTOL}); "
        f"{out['pallas'][2]} target tokens (the {s_img}-position prefix ignored); flash "
        f"launches {launches}; max_memory_allocated {peak_allocated(device)} B")
    if rel > LOGIT_RTOL or dloss > LOGIT_RTOL or out["pallas"][2] != VL_BATCH * VL_TEXT:
        raise SystemExit("6v (a): the kernel path disagrees with the plain path")
    log(f"  (a) lm_loss wall (the forward and the loss, no gradients): kernel path "
        f"{walls['pallas'] * 1e3:.3f} ms, plain path {walls['xla'] * 1e3:.3f} ms")
    if device == "cuda":
        roofline_line("6v (a)", c2, "prefill", VL_TEXT + s_img, VL_BATCH, walls["pallas"], smi)
    VL_RESULT.parent.mkdir(parents=True, exist_ok=True)
    VL_RESULT.write_text(json.dumps({"flash_attention": launches}))
    del params, out, lk, lp
    gc.collect()
    reset_peak(device)

    # (b) one streamed-weight step at VL_W_LAYERS layer(s): the home by the
    # host's memory, the cache off, on demand (an optimizer group of the
    # 152,064-row tables is 17-18 GB a side on the card)
    c1 = train_cfg(dataclasses.replace(base, n_layers=VL_W_LAYERS))
    plan = WeightStreamPlan(c1, st.abstract_params(c1), layers_per_group=1)
    n = plan.n_groups
    need, why = streamed_home_need(plan)
    spill = ROOT / "build" / "spill-6v"
    avail, free = mem_available(), disk_free(spill)
    home = 7 * plan.total_param_bytes  # bf16 weights + f32 master, m, v
    if avail >= need["pinned_host"]:
        kind = "pinned_host"
    elif avail >= need["disk_host"] and free >= need["disk"]:
        kind = "disk_host"
    else:
        raise SystemExit(f"6v (b): MemAvailable {avail} B holds neither home ({need}; disk "
                         f"{free} B free)")
    log(f"  (b) {VL_W_LAYERS} layer(s), {plan.total_param_bytes // 2:,} parameters in {n} groups, "
        f"home {home} B (weights and moments): {kind}; MemAvailable {avail} B, disk {free} B "
        f"free, against the pinned home's {need['pinned_host']} B and the disk home's "
        f"{need['disk_host']} B of host and {need['disk']} B of disk ({why})")
    # the monolithic loss on init_params' weights: the group-wise init draws
    # the same bits (tests/test_torch_frontends.py), group by group
    batch = batch_for(c1)
    t0 = time.perf_counter()
    whole = st.init_params(c1, SEED, device)
    with torch.no_grad():
        mono = float(transformer.lm_loss(c1, whole, batch)[0])
    del whole
    gc.collect()
    reset_peak(device)
    log(f"  (b) monolithic lm_loss: {mono} ({time.perf_counter() - t0:.1f} s)")
    store = None
    try:
        if kind == "disk_host":  # ephemeral: no fsync (a capacity tier in this phase)
            shutil.rmtree(spill, ignore_errors=True)
            store = SpillStore(spill, ephemeral=True)
        t0 = time.perf_counter()
        state = st.init_weight_streamed_state(c1, plan, SEED, device, store=store)
        avail = mem_available()
        log(f"  (b) group-wise init of the state at {kind}: {time.perf_counter() - t0:.1f} s "
            f"(host MemAvailable {avail} B, this process's resident set {rss_bytes()} B)")
        # what the step holds beyond the home it was handed
        extra = need[kind] - VL_HOST_MARGIN - (home if kind == "pinned_host" else 0)
        if avail < extra + VL_HOST_MARGIN:
            raise SystemExit(f"6v (b): MemAvailable {avail} B after the init holds not the "
                             f"step's {extra} B beyond its home with {VL_HOST_MARGIN} B to spare")
        leaves = {k: len(tr.leaves(t)) for k, t in
                  plan.init_home(st.abstract_params(c1))["groups"].items()}
        reset_peak(device)
        step = st.make_weight_streamed_train_step(
            c1, AdamWConfig(**TRAIN_OPT), plan=plan, param_kind=kind, spill_store=store,
            prefetch=PrefetchSpec(buffer_size=n + 2, distance=0), residency=ResidencyCache(0),
            donate=True, device=device)
        try:
            stats = {"param": step.param_stats, "opt": step.opt_stats}
            before = {w: {f: getattr(s_, f) for f in STREAM_FIELDS} for w, s_ in stats.items()}
            sync(device)
            t0 = time.perf_counter()
            new, m = step(state, batch)
            loss = float(m["loss"])
            sync(device)
            wall = time.perf_counter() - t0
            got = {w: {f: getattr(s_, f) - before[w][f] for f in STREAM_FIELDS}
                   for w, s_ in stats.items()}
        finally:
            step.close()
        want = streamed_step_counts(plan, leaves, kind, 0)
        for w in ("param", "opt"):
            for f, v in want[w].items():
                if got[w][f] != v:
                    raise SystemExit(f"6v (b): {w} {f} {got[w][f]}, the plan's {v}")
        if loss != mono or not math.isfinite(loss):
            raise SystemExit(f"6v (b): the streamed step-0 loss {loss} is not the monolithic "
                             f"lm_loss {mono}")
        if any(state[p]["groups"] for p in ("params", "opt")):
            raise SystemExit("6v (b): the donated state still holds groups")
        log(f"  (b) {kind}: step-0 loss {loss} bitwise the monolithic lm_loss; step wall "
            f"{wall * 1e3:.1f} ms ({VL_BATCH * (VL_TEXT + s_img) / wall:.1f} positions/s); wait "
            f"{(got['param']['transfer_wait_s'] + got['opt']['transfer_wait_s']) * 1e3:.1f} ms, "
            f"drain {(got['param']['writeback_drain_s'] + got['opt']['writeback_drain_s']) * 1e3:.1f}"
            f" ms; H2D {got['param']['bytes_h2d']:,} + {got['opt']['bytes_h2d']:,} B "
            f"({got['param']['h2d_requests']} + {got['opt']['h2d_requests']} requests), D2H "
            f"{got['param']['bytes_d2h']:,} + {got['opt']['bytes_d2h']:,} B, disk "
            f"{got['param']['disk_requests']} + {got['opt']['disk_requests']} requests (weights + "
            f"optimizer), every count the plan's; max_memory_allocated {peak_allocated(device)} B; "
            f"host MemAvailable after {mem_available()} B ({smi})")
        del new, state
    finally:
        if store is not None:
            store.close(delete=True)
        shutil.rmtree(spill, ignore_errors=True)
    log(f"  phase 6v done in {time.perf_counter() - t_phase:.1f} s")


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


def phase_times(cfg, hcfg, errs: dict, launches: dict, hlaunches: dict, mlaunches: dict,
                alaunches: dict, qlaunches: dict, dlaunches: dict, sweep: list, train: dict) -> list:
    from repro_torch.configs import get_config
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
        # mixtral-8x7b (phase 2m (a)): the lock-step prefill under the 4096
        # window, and the last decode step over its ring of prompt + gen slots
        flash_row("mixtral-8x7b", MOE_BATCH, MOE_PROMPT, 32, 8, 128, 4096,
                  mlaunches["flash_attention"], errs["flash_attention_moe"], flush),
        decode_row("mixtral-8x7b", MOE_PROMPT + MOE_GEN, 32, 8, 128,
                   [MOE_PROMPT + MOE_GEN - 1] * MOE_BATCH, mlaunches["decode_attention"],
                   errs["decode_attention_moe"], flush),
        # musicgen-medium (phase 2a (a)): one request's prefill, and the last
        # decode step of the batch over its prompt + gen slots
        flash_row("musicgen-medium", 1, PROMPT, 24, 24, 64, 0, alaunches["flash_attention"],
                  errs["flash_attention_audio"], flush),
        decode_row("musicgen-medium", PROMPT + GEN, 24, 24, 64, [PROMPT + GEN - 1] * BATCH,
                   alaunches["decode_attention"], errs["decode_attention_audio"], flush),
        # qwen2-vl-72b (phase 6v (a), in its child process): the no-gradient
        # training forward over the text and the vision prefix
        flash_row("qwen2-vl-72b", VL_BATCH, VL_TEXT + VL_TEXT // 8, 64, 8, 128, 0,
                  json.loads(VL_RESULT.read_text())["flash_attention"],
                  errs["flash_attention_vlm"], flush),
    ]
    # qwen3-moe-235b-a22b (phase 2q (a)) and internlm2-20b (phase 2d): one
    # request's prefill, and the batch's last decode step over its prompt +
    # gen slots
    for arch, b, p, g, lnch in ((Q_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN, qlaunches),
                                ("internlm2-20b", BATCH, PROMPT, GEN, dlaunches["internlm2-20b"])):
        c = get_config(arch)
        key = "qwen3" if arch == Q_ARCH else arch
        rows.append(flash_row(arch, 1, p, c.n_heads, c.n_kv_heads, c.head_dim, 0,
                              lnch["flash_attention"], errs[f"flash_attention_{key}"], flush))
        rows.append(decode_row(arch, p + g, c.n_heads, c.n_kv_heads, c.head_dim, [p + g - 1] * b,
                               lnch["decode_attention"], errs[f"decode_attention_{key}"], flush))
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


# ---------------------------------------------------------------------------
# phase 8s: the sharding plan on one card (NCCL, DTensor)
# ---------------------------------------------------------------------------

def phase_sharding(cfg, smi: str, device: str = "cuda") -> None:
    """Phase 8s: a one-rank process group (NCCL on the card, over a
    ``HashStore``) and ``make_local_mesh``; ``cfg``'s parameters from
    ``SEED`` placed as DTensors by the train plan's ``param_specs`` and each
    local shard held bitwise against its source; ``sharding_report``'s
    per-device bytes against the tree's; the Sharder's ``block`` (through
    autograd: its backward redistributes the gradient to the FSDP
    placements), ``acts`` and ``grads`` over one layer, values unchanged
    bitwise.  The group is destroyed at the end."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.core import tree as tr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.steps import init_params

    t0 = time.perf_counter()
    if dist.is_initialized():
        raise SystemExit("8s: a process group is already open")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_local_mesh(device=device)
        plan = sh.make_plan(mesh, "train")
        params = init_params(cfg, SEED, device).as_dict()  # phase 2's weights
        specs = sh.param_specs(plan, params)
        placed = sh.distribute_tree(params, mesh, specs)
        local_bytes = 0
        for x, d in zip(tr.leaves(params), tr.leaves(placed)):
            loc = d.to_local()
            if loc.device != x.device or not torch.equal(bits(loc), bits(x)):
                raise SystemExit(f"8s: a local shard of shape {tuple(loc.shape)} is not its source")
            local_bytes += loc.numel() * loc.element_size()
        tree_bytes = sum(x.numel() * x.element_size() for x in tr.leaves(params))
        per_dev = sh.per_device_bytes(plan, params, specs)
        report = sh.sharding_report(plan, params, specs)
        header = report.splitlines()[0]
        if not (per_dev == local_bytes == tree_bytes
                and header == f"per-device param bytes: {tree_bytes / 2**30:.3f} GiB (train plan)"):
            raise SystemExit(f"8s: per-device bytes {per_dev}, local shards {local_bytes}, the "
                             f"tree {tree_bytes}; report {header!r}")
        log(f"phase 8s the sharding plan on one card: a one-rank {dist.get_backend()} group, "
            f"mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} on {mesh.device_type}; "
            f"{cfg.name}'s {len(tr.leaves(params))} leaves placed by the train plan's param_specs as "
            f"DTensors, every local shard bitwise its source; sharding_report {header!r}: "
            f"{per_dev} B a device = the local shards' = the tree's")
        # one layer through the Sharder, with gradients
        sharder = sh.make_sharder(plan, placed, BATCH, seq_len=PROMPT)
        src = {k: {n: params["blocks"][k][n][0] for n in sub}
               for k, sub in params["blocks"].items() if sub}
        layer = {k: {n: distribute_tensor(v, mesh, sh.placements(mesh, sharder.fsdp_specs[k][n])
                                          ).requires_grad_()
                     for n, v in sub.items()} for k, sub in src.items()}
        blk = sharder.block(layer)
        leaves = [(k, n) for k in blk for n in blk[k]]
        if not all(isinstance(blk[k][n], DTensor)
                   and torch.equal(bits(blk[k][n].full_tensor()), bits(src[k][n]))
                   for k, n in leaves):
            raise SystemExit("8s: Sharder.block changed a value")
        sum(blk[k][n].float().sum() for k, n in leaves).backward()
        grads = {k: {n: layer[k][n].grad for n in layer[k]} for k in layer}
        one = torch.ones((), dtype=torch.bfloat16, device=device)
        if not all(tuple(grads[k][n].placements) == tuple(layer[k][n].placements)
                   and torch.equal(bits(grads[k][n].full_tensor()),
                                   bits(one.expand_as(src[k][n])))
                   for k, n in leaves):
            raise SystemExit("8s: the gradient through Sharder.block is not ones in the FSDP "
                             "placements")
        pinned = sharder.grads({"blocks": {k: {n: placed["blocks"][k][n] for n in sub}
                                           for k, sub in placed["blocks"].items()}})
        if not all(torch.equal(bits(a.full_tensor()), bits(b.full_tensor()))
                   for a, b in zip(tr.leaves(pinned), tr.leaves(placed["blocks"]))):
            raise SystemExit("8s: Sharder.grads changed a value")
        g = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device=device).to(torch.bfloat16)
        a = sharder.acts(distribute_tensor(x, mesh, sh.placements(mesh, sh.P())))
        if not torch.equal(bits(a.full_tensor()), bits(x)):
            raise SystemExit("8s: Sharder.acts changed a value")
        log(f"  Sharder over layer 0 ({len(leaves)} leaves): block, its gradient through "
            f"autograd (ones, in the FSDP placements), grads over the blocks and acts on a "
            f"({BATCH}, {PROMPT}, {cfg.d_model}) activation, all bitwise unchanged "
            f"({time.perf_counter() - t0:.1f} s; {smi})")
    finally:
        dist.destroy_process_group()


def kernel_launches(fn, device: str = "cuda") -> tuple[int, float]:
    """``(kernel launches, wall s)`` of ``fn()`` under the profiler: the
    card's kernels (copies and memsets excluded; 0 on the CPU)."""
    acts = [torch.profiler.ProfilerActivity.CUDA if device == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return n, wall


def phase_mesh(smi: str, device: str = "cuda", full=None) -> None:
    """Phase 8c, in a ``torchrun --standalone --nproc-per-node 1`` child
    (see the module docstring).  Joins the group torchrun describes, builds
    the elastic mesh and destroys the group at the end.  ``full`` (a smoke
    config) and ``device="cpu"`` rehearse it on the CPU under gloo, against
    the files a rehearsal of phases 2p and 6w wrote."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree as tr
    from repro_torch.core.engine import ShardedGroupLayout
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import serve
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.local import full_local
    from repro_torch.runtime import elastic as el
    from repro_torch.runtime.driver import DriverConfig
    from repro_torch.train import steps as st

    t_phase = t_sub = time.perf_counter()

    def sub_s() -> float:
        nonlocal t_sub
        t, t_sub = t_sub, time.perf_counter()
        return t_sub - t

    started = time.time() - float(os.environ.get("CHIP_SMOKE_LAUNCHED", time.time()))
    if not mesh_mod.init_from_env(device):
        raise SystemExit("8c: no torchrun environment")
    try:
        mesh = el.elastic_local_mesh(model=1, device=device)
        fp = el.mesh_fingerprint(mesh)
        cfg = dataclasses.replace(full or get_config("smollm-360m"), attn_impl="pallas")
        tcfg = train_cfg(cfg)
        log(f"phase 8c the sharding plan's consumers on a one-rank {dist.get_backend()} mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (torchrun, world "
            f"{dist.get_world_size()}): {cfg.name} full width; the child ran {started:.1f} s "
            f"after its launch, its group and mesh {sub_s():.1f} s later; {smi}")

        # (a) two train steps with and without the mesh, in lock-step
        ckpt_dir = ROOT / "build" / "ckpt-8c"
        shutil.rmtree(ckpt_dir, ignore_errors=True)

        def trainer(m):
            return launch_train.build_trainer(
                tcfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                opt_cfg=AdamWConfig(**TRAIN_OPT),
                driver_cfg=DriverConfig(total_steps=MESH_TRAIN_STEPS, checkpoint_dir=str(ckpt_dir),
                                        log_every=0),
                seed=SEED, device=device, mesh=m)

        plain, sharded = trainer(None), trainer(mesh)
        laps = {"trainers": sub_s()}
        states = {"plain": plain.init_state()}
        laps["init"] = sub_s()
        states["mesh"] = sharded.init_state()
        laps["init on the mesh"] = sub_s()
        if not all(type(x).__name__ == "DTensor" for x in tr.leaves(states["mesh"])):
            raise SystemExit("8c (a): a leaf of the mesh state is not a DTensor")

        def same_state(a, b) -> bool:
            la, lb = tr.leaves(a), tr.leaves(b)
            return len(la) == len(lb) and all(
                torch.equal(bits(full_local(x)), bits(full_local(y))) for x, y in zip(la, lb))

        walls, losses, counts = {"plain": [], "mesh": []}, {"plain": [], "mesh": []}, {}
        ckpt = CheckpointManager(ckpt_dir, keep=1)
        for k in range(MESH_TRAIN_STEPS):
            for name, drv in (("plain", plain), ("mesh", sharded)):
                batch = drv.make_batch(k)
                out = {}

                def one():
                    out["s"], out["m"] = drv.step_fn(states[name], batch)

                if k == MESH_TRAIN_STEPS - 1:  # the last step under the profiler
                    counts[name], wall = kernel_launches(one, device)
                else:
                    sync(device)
                    t0 = time.perf_counter()
                    one()
                    sync(device)
                    wall = time.perf_counter() - t0
                states[name] = out["s"]
                walls[name].append(wall)
                losses[name].append(float(out["m"]["loss"]))
            if losses["mesh"] != losses["plain"] or not same_state(states["mesh"],
                                                                   states["plain"]):
                raise SystemExit(f"8c (a) step {k}: losses {losses['mesh']} against "
                                 f"{losses['plain']}, or the parameters and moments differ")
            if k == 0:  # the step-1 checkpoint, rank 0 writing while step 2 runs
                laps["steps"] = sub_s()
                ckpt.save(1, states["mesh"], extra_meta=sharded.run_meta)
                laps["gather"] = sub_s()
        laps["steps"] += sub_s()
        del states["plain"], plain
        ckpt.wait()
        laps["write"] = sub_s()
        if ckpt.load_meta(1)["extra"]["mesh"] != fp:
            raise SystemExit(f"8c (a): the checkpoint's mesh {ckpt.load_meta(1)['extra']} is not "
                             f"{fp}")
        _, restored = ckpt.restore(sharded.template())
        replay, m = sharded.step_fn(restored, sharded.make_batch(1))
        if float(m["loss"]) != losses["mesh"][1] or not same_state(replay, states["mesh"]):
            raise SystemExit("8c (a): the restart from the step-1 checkpoint does not replay "
                             "step 2 bitwise")
        del replay, restored
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        laps["restore and replay"] = sub_s()
        grads = mesh_grads(tcfg, mesh, states["mesh"]["params"], sharded.make_batch(0))
        del states
        log(f"  (a) train, params and AdamW moments as DTensors by the train plan, the Sharder "
            f"in the layer body: losses {losses['mesh']} bitwise the no-mesh run's, parameters "
            f"and moments too after each step; step walls {[round(w * 1e3, 1) for w in walls['mesh']]}"
            f" ms against {[round(w * 1e3, 1) for w in walls['plain']]} ms without the mesh "
            f"(step 2 under the profiler); kernel launches a step {counts['mesh']} against "
            f"{counts['plain']}; the step-1 checkpoint carries the mesh {fp} and its restart "
            f"replays step 2 bitwise (s: { {k: round(v, 1) for k, v in laps.items()} })")
        check_pod_allreduce(grads, mesh, smi)
        del grads

        # (b) one streamed-weight step, every group staged at the plan's layouts
        w6 = json.loads(W6_RESULT.read_text())
        plan = WeightStreamPlan(tcfg, st.abstract_params(tcfg), layers_per_group=1,
                                device_budget_mb=W_TRAIN_BUDGET_MB)
        _, _, p_sh, _, sharder = launch_train._train_layouts(tcfg, mesh, TRAIN_BATCH, TRAIN_SEQ)
        state0 = st.init_weight_streamed_state(tcfg, plan, SEED, device)
        t_init = sub_s()
        step = st.make_weight_streamed_train_step(
            tcfg, AdamWConfig(**TRAIN_OPT), plan=plan, param_kind="pinned_host",
            prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance="auto"), device=device,
            mesh=mesh, sharder=sharder, param_shardings=p_sh)
        try:
            sync(device)
            t0 = time.perf_counter()
            _, m = step(state0, train_batch(tcfg, 0, device))
            sync(device)
            wall = time.perf_counter() - t0
            got = {"param": step.param_stats.h2d_requests, "opt": step.opt_stats.h2d_requests}
            layouts = list(step.engine._layouts.values())
        finally:
            step.close()
        del state0
        if plan.n_groups != w6["groups"] or float(m["loss"]) != w6["loss"] or got != w6["h2d"]:
            raise SystemExit(f"8c (b): {plan.n_groups} groups, loss {float(m['loss'])} against "
                             f"6w's {w6['loss']}, H2D requests {got} against 6w's {w6['h2d']}")
        if not layouts or not all(isinstance(lo, ShardedGroupLayout) for lo in layouts):
            raise SystemExit("8c (b): a group staged outside ShardedGroupLayout")
        log(f"  (b) streamed-weight step at pinned host under {W_TRAIN_BUDGET_MB} MB, "
            f"{plan.n_groups} groups at the train plan's param_shardings ({len(layouts)} "
            f"ShardedGroupLayouts): loss {float(m['loss'])} bitwise 6w's; H2D requests {got} = "
            f"6w's, one a (rank, group); step wall {wall * 1e3:.1f} ms against 6w's "
            f"{w6['wall'] * 1e3:.1f} ms; state built in {t_init:.1f} s ({sub_s():.1f} s)")

        # (c) the paged session under the serve plan
        p2 = json.loads(P2_RESULT.read_text())
        params = st.init_params(cfg, SEED, device)  # phase 2's weights
        wrappers = serving_kernels()
        for w in wrappers.values():
            w.launches = 0
        res = serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=MESH_GEN, seed=SEED,
                    kv_kind="pinned_host", kv_page_len=PAGE_LEN, hot_pages=HOT_PAGES,
                    distance="auto", params=params, device=device, mesh=mesh)
        launches = {k: w.launches for k, w in wrappers.items()}
        del params
        want = np.asarray(p2["generated"], np.int32)[:, :MESH_GEN]
        if not np.array_equal(res["generated"], want):
            raise SystemExit("8c (c): the tokens differ from phase 2p's pinned-host run")
        steps = res["n_steps"] + 1  # and the warm-up step
        if (launches["flash_attention"] != p2["launches"]["flash_attention"]
                or launches["decode_attention"] * (p2["n_steps"] + 1)
                != p2["launches"]["decode_attention"] * steps):
            raise SystemExit(f"8c (c): launches {launches} over {steps} decode steps against "
                             f"phase 2p's {p2['launches']} over {p2['n_steps'] + 1}")
        st_ = res["stats"]
        log(f"  (c) paged serve under the serve plan, pinned-host pages of {PAGE_LEN}: tokens "
            f"{res['generated'].shape} bitwise phase 2p's first {MESH_GEN}; flash "
            f"{launches['flash_attention']} and decode {launches['decode_attention']} launches on "
            f"the local shards ({launches['decode_attention'] // steps} a step, as 2p's); prefill "
            f"{res['prefill_s'] * 1e3:.3f} ms, decode {res['decode_s'] * 1e3 / res['n_steps']:.3f} "
            f"ms a step against 2p's {p2['decode_step_ms']:.3f} ms; h2d {st_.h2d_requests} req "
            f"over {st_.n_groups} page groups ({sub_s():.1f} s)")
        sorted_ep_train(mesh, smi, device, None if full is None else
                        get_smoke_config("mixtral-8x7b"))
        sub_s()
        shard_suite(smi, device)
        log(f"  (g) {sub_s():.1f} s")
    finally:
        dist.destroy_process_group()
    log(f"  phase 8c (a)-(c), (e)-(g) done in {time.perf_counter() - t_phase:.1f} s")


def mesh_grads(cfg, mesh, params, batch) -> dict:
    """Phase 8c (f)'s input: the gradients of one grad step of ``cfg`` at
    ``params`` (DTensors by the train plan) on ``mesh``, as full tensors."""
    from repro_torch.core import tree as tr
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel.local import full_local
    from repro_torch.train import steps as st

    sharder = launch_train._train_layouts(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ)[4]
    _, _, grads = st.make_grad_step(cfg, mesh, sharder)(params, batch)
    return tr.tree_map(full_local, grads)


def check_pod_allreduce(grads: dict, mesh, smi: str) -> None:
    """Phase 8c (f): ``pod_allreduce_int8`` over the one-rank ``data`` group
    on a full-width gradient tree.  ``out + err`` must give back each
    gradient within tests/test_runtime.py's 1e-5, and on one rank the
    all-reduce is the codec's round trip: ``out`` bit for bit ``q * s`` at
    the rank's own scale (the JAX package's compiled program's
    ``max|g| * fl(1 / 127)``; ``decompress_int8(compress_int8(g))`` divides
    by 127, so it gives these bits wherever the two scales agree, counted)."""
    from repro_torch.core import tree as tr
    from repro_torch.optim import grad_compress as gc_

    t0 = time.perf_counter()
    flat = tr.leaves(grads)
    err0 = gc_.init_error_state(grads)
    sync("cuda" if flat[0].is_cuda else "cpu")
    t1 = time.perf_counter()
    out, err = gc_.pod_allreduce_int8(grads, "data", err0, mesh)
    sync("cuda" if flat[0].is_cuda else "cpu")
    wall = time.perf_counter() - t1
    codec = gc_.decompress_int8(*gc_.compress_int8(grads)[:2])
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=flat[0].device)
    worst, same_codec, n = 0.0, 0, 0
    for g, o, e, c in zip(flat, tr.leaves(out), tr.leaves(err), tr.leaves(codec)):
        gf = g.float()
        if not torch.allclose(o + e, gf, **GC_TOL):
            raise SystemExit(f"8c (f): out + err misses a gradient by "
                             f"{float((o + e - gf).abs().max())}")
        scale = torch.clamp(gf.abs().max(), min=1e-30) * inv127
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        if not torch.equal(bits(o), bits(q.float() * scale)):
            raise SystemExit("8c (f): on one rank out is not the codec's round trip q * s")
        worst = max(worst, float((o + e - gf).abs().max()))
        same_codec += int(torch.equal(bits(o), bits(c)))
        n += g.numel()
    log(f"  (f) pod_allreduce_int8 over the one-rank 'data' group on (a)'s {len(flat)} gradient "
        f"leaves ({n:,} values): out + err within {worst:.3e} of each gradient (1e-5 allowed); out "
        f"bitwise q * s at the rank's own scale in every leaf, and bitwise "
        f"decompress_int8(compress_int8(g)) in {same_codec} of {len(flat)} (the rest: the two "
        f"scales an ulp apart); the all-reduce {wall * 1e3:.1f} ms ({time.perf_counter() - t0:.1f}"
        f" s; {smi})")


def sorted_ep_train(mesh, smi: str, device: str = "cuda", full=None) -> None:
    """Phase 8c (e): full-width mixtral-8x7b cut to ``EP_LAYERS`` trained
    under ``moe_impl="sorted_ep"`` on ``mesh`` through ``build_trainer``
    (``full`` and ``device="cpu"`` rehearse it at another size)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import tree as tr
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.local import full_local
    from repro_torch.runtime.driver import DriverConfig
    from repro_torch.train import steps as st

    t0 = time.perf_counter()
    cfg = train_cfg(dataclasses.replace(full or get_config("mixtral-8x7b"), n_layers=EP_LAYERS,
                                        moe_impl="sorted_ep"))
    calls = {"sorted_ep": 0, "dispatch": 0}
    originals = {"sorted_ep": moe.moe_sorted_ep, "dispatch": moe.moe_dispatch}

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return fn

    moe.moe_sorted_ep, moe.moe_dispatch = counted("sorted_ep"), counted("dispatch")
    try:
        trainer = launch_train.build_trainer(
            cfg, global_batch=MT_BATCH, seq_len=MT_SEQ, opt_cfg=AdamWConfig(**TRAIN_OPT),
            driver_cfg=DriverConfig(total_steps=EP_STEPS, checkpoint_dir=str(ROOT / "build" /
                                                                             "ckpt-8c-ep"),
                                    log_every=0),
            seed=SEED, device=device, mesh=mesh)
        reset_peak(device)
        state = trainer.init_state()
        init_s = time.perf_counter() - t0
        n_params = sum(full_local(x).numel() for x in tr.leaves(state["params"]))
        walls, losses, launches = [], [], 0
        for k in range(EP_STEPS):
            b, out = trainer.make_batch(k), {}

            def one():
                out["s"], out["m"] = trainer.step_fn(state, b)

            if k == EP_STEPS - 1:  # the last step under the profiler
                launches, wall = kernel_launches(one, device)
            else:
                sync(device)
                t1 = time.perf_counter()
                one()
                sync(device)
                wall = time.perf_counter() - t1
            state = out["s"]
            walls.append(wall)
            losses.append(float(out["m"]["loss"]))
        peak = peak_allocated(device)
        if not all(map(math.isfinite, losses)) or calls["sorted_ep"] == 0 or calls["dispatch"]:
            raise SystemExit(f"8c (e): losses {losses}, calls {calls}")
        step_calls = dict(calls)

        # the layer's expert parallelism against the local routine on full
        # tensors without a mesh, on a random activation
        p_moe = {k: v[0] for k, v in state["params"]["blocks"]["moe"].items()}
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        h = torch.randn((MT_BATCH, MT_SEQ, cfg.d_model), generator=gen, device=device).to(
            torch.bfloat16)
        with torch.no_grad():
            y, aux = originals["sorted_ep"](cfg, p_moe, h, mesh)
            y0, aux0 = moe.moe_sorted_local(cfg, {k: full_local(v) for k, v in p_moe.items()},
                                            h.reshape(-1, cfg.d_model), cfg.n_experts, 0)
        if not (torch.equal(bits(y), bits(y0.reshape(y.shape))) and torch.equal(bits(aux),
                                                                                 bits(aux0))):
            raise SystemExit("8c (e): sorted_ep on the mesh differs from the local routine on "
                             "full tensors")

        # where no token can drop, the step's loss against the dispatch's
        b0 = trainer.make_batch(0)
        _, _, _, _, sharder = launch_train._train_layouts(cfg, mesh, MT_BATCH, MT_SEQ)
        nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        loss = {impl: float(full_local(st.make_grad_step(
            dataclasses.replace(nodrop, moe_impl=impl), mesh, sharder)(state["params"], b0)[0]))
            for impl in ("sorted_ep", "dispatch")}
        if not math.isclose(loss["sorted_ep"], loss["dispatch"], rel_tol=RTOL, abs_tol=ATOL):
            raise SystemExit(f"8c (e): at capacity factor {nodrop.capacity_factor} the losses "
                             f"{loss} differ by more than 2e-2")
    finally:
        moe.moe_sorted_ep, moe.moe_dispatch = originals["sorted_ep"], originals["dispatch"]
    del state, trainer
    free_host(device)
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"  (e) {cfg.name} cut to {EP_LAYERS} layer ({n_params:,} parameters, {cfg.n_experts} "
        f"experts of d_ff {cfg.d_ff} top-{cfg.moe_top_k}) under moe_impl=\"sorted_ep\" on the "
        f"{dist.get_backend()} mesh through build_trainer, batch {MT_BATCH} x {MT_SEQ}: losses "
        f"{losses}; step walls {[round(w * 1e3, 1) for w in walls]} ms (the last under the "
        f"profiler, {launches} kernel launches); sorted_ep calls {step_calls['sorted_ep']}, "
        f"dispatch {step_calls['dispatch']}; max_memory_allocated {peak} B; the layer's y and aux "
        f"bitwise the local routine's on full tensors; at capacity factor "
        f"{nodrop.capacity_factor:g} the step's loss {loss['sorted_ep']} against the dispatch's "
        f"{loss['dispatch']} (2e-2 allowed); init {init_s:.1f} s, (e) "
        f"{time.perf_counter() - t0:.1f} s; {smi}")


def shard_suite(smi: str, device: str = "cuda") -> None:
    """Phase 8c (g): the ``shard`` suite's body in place on the child's
    group, and its gates (one request a (rank, group), the per-leaf
    schedule's (1 + 12) x n a group, a steady-wait collapse of at least 2x,
    bitwise equality with eager sharded placement)."""
    import torch.distributed as dist

    from repro_torch.benchmarks import shard_stream

    rows, _ = shard_stream.run_body(device)
    ok, line = shard_stream.gates(rows, dist.get_world_size())
    if not ok:
        raise SystemExit(f"8c (g): the shard suite's gates fail: {line}")
    log(f"  (g) the shard suite on the {dist.get_backend()} group of {dist.get_world_size()}: "
        f"{line} ({smi})")


def phase_mesh_cli():
    """Phase 8c (d): ``--model-parallel 2`` on one card through both
    launchers at smoke size, in parallel processes; a generator: started at
    its first ``next``, checked at the second.  ``main`` starts them before
    the build and reads them after phase 1, which time nothing, so that no
    timed phase shares the card or the host with them (``train`` runs the
    plain attention: it builds and launches no kernel)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = str(ROOT / "src")
    (ROOT / "build").mkdir(exist_ok=True)  # they start before the build makes it
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cmds = {
            "train": [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
                      "--smoke", "--steps", "1", "--batch", "2", "--seq", "16",
                      "--checkpoint-dir", str(Path(tmp) / "ck"), "--model-parallel", "2"],
            "serve": [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                      "--model-parallel", "2"],
        }
        procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in cmds.items()}
        try:
            yield
        except BaseException:
            for q in procs.values():
                q.kill()
            raise
        out = {}
        for k, proc in procs.items():
            try:
                so, se = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs.values():
                    q.kill()
                raise SystemExit(f"8c (d): {k} did not finish")
            out[k] = (proc.returncode, so, se)
    rc, so, se = out["train"]
    if rc != 0 or "model axis 2 does not fit 1 device(s); degraded to 1" not in se:
        raise SystemExit(f"8c (d) train: rc {rc}\n{se[-3000:]}")
    rc2, _, se2 = out["serve"]
    reason = "model axis 2 does not divide the world size 1"
    if rc2 != 2 or reason not in se2:
        raise SystemExit(f"8c (d) serve: rc {rc2}\n{se2[-3000:]}")
    warn = next(line for line in se.splitlines() if "degraded" in line)
    log(f"phase 8c (d) --model-parallel 2 on one card (beside phases 0 and 1): train exits 0 "
        f"after {warn.strip()!r} "
        f"({so.strip().splitlines()[-1]}); serve exits 2: {se2.strip().splitlines()[-1]!r} "
        f"(read {time.perf_counter() - t0:.1f} s after their start)")
    yield


def phase_8c_alone() -> None:
    """Phase 8c alone on the card (``python3 -c 'import chip_smoke as cs;
    cs.phase_8c_alone()'``): the kernels built, the references it reads
    written first (phase 2p's pinned-host paged run, phase 6w's first
    pinned-host step), then (a)-(g)."""
    from repro_torch.configs import get_config
    from repro_torch.core.refspec import PrefetchSpec
    from repro_torch.core.weightstream import WeightStreamPlan
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as st

    resolve_device("cuda")
    t0 = time.perf_counter()
    phase_build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="pallas")
    params = st.init_params(cfg, SEED, "cuda")
    page = dict(kv_kind="pinned_host", kv_page_len=PAGE_LEN, hot_pages=HOT_PAGES,
                distance="auto")
    res, launches = paged_run(cfg, params, "2p (b) pinned_host pages", **page)
    write_p2_result(res, launches)
    del params
    tcfg = train_cfg(cfg)
    plan = WeightStreamPlan(tcfg, st.abstract_params(tcfg), layers_per_group=1,
                            device_budget_mb=W_TRAIN_BUDGET_MB)
    step = st.make_weight_streamed_train_step(
        tcfg, AdamWConfig(**TRAIN_OPT), plan=plan, param_kind="pinned_host",
        prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance="auto"), device="cuda")
    try:
        state = st.init_weight_streamed_state(tcfg, plan, SEED, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = step(state, train_batch(tcfg, 0))
        torch.cuda.synchronize()
        write_w6_result(float(m["loss"]), time.perf_counter() - t1, plan.n_groups,
                        {"param": step.param_stats.h2d_requests,
                         "opt": step.opt_stats.h2d_requests})
    finally:
        step.close()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8c's references written ({time.perf_counter() - t0:.1f} s)")
    t8 = time.perf_counter()
    cli = phase_mesh_cli()
    next(cli)
    next(cli)
    torchrun_phase("phase_mesh", smi)
    log(f"  phase 8c done in {time.perf_counter() - t8:.1f} s")


def torchrun_phase(phase: str, smi: str) -> None:
    """Run the phase function ``phase`` as a one-rank ``torchrun
    --standalone`` job on the card (its own process group, NCCL)."""
    import os

    torch.cuda.empty_cache()
    sys.stdout.flush()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           str(ROOT / "chip_smoke.py"), "--phase", phase, smi]
    env = dict(os.environ, CHIP_SMOKE_LAUNCHED=repr(time.time()))
    rc = subprocess.run(cmd, cwd=ROOT, env=env).returncode
    if rc:
        raise SystemExit(f"{phase} failed in its torchrun child (rc {rc})")


def isolated(phases: tuple, smi: str) -> None:
    """Run the phase functions ``phases`` in turn in one child process on
    the same card, logging the host's MemAvailable before each.  Phases 6v,
    6m and 6x hold tens of GB of host memory (numpy homes, pinned drains)
    that the caching allocators and the C heap keep after they return
    (whole runs in-process saw 41 of the host's 105.9 GB available after 6m
    had freed its state, and 13.6 GB left for 6x after phases 2m-6w).  A
    child gives it all back when it exits; each child costs 12-16 s to start
    and exit, so the phases that fit the host one after another share one."""
    torch.cuda.empty_cache()  # the child gets the card's memory
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as cs; "
            f"from repro_torch.device import resolve_device; resolve_device('cuda'); "
            f"cs.child_phases({list(phases)!r}, {smi!r})")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode
    if rc:
        raise SystemExit(f"{', '.join(phases)} failed in their child process (rc {rc})")


def child_phases(phases: list, smi: str) -> None:
    """:func:`isolated`'s child: each phase in turn, the host's MemAvailable
    and the child's resident set logged before it."""
    t0 = time.perf_counter()
    for phase in phases:
        free_host("cuda")
        log(f"-- child {time.perf_counter() - t0:.1f} s: {phase} (host MemAvailable "
            f"{mem_available()} B, this process's resident set {rss_bytes()} B)")
        globals()[phase](smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--phase"]:  # a phase in a child process (torchrun_phase)
        from repro_torch.device import resolve_device

        resolve_device("cuda")
        globals()[sys.argv[2]](sys.argv[3])
        return 0
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off: the plain versions are f32-exact references
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="pallas")
    hcfg = dataclasses.replace(get_config("recurrentgemma-2b"), attn_impl="pallas")
    t0 = time.perf_counter()

    def at(what: str) -> None:  # where the whole run's time goes
        log(f"-- {time.perf_counter() - t0:.1f} s: {what}")

    # phase 8c (d)'s two launcher processes (smoke size; plain attention, no
    # kernel) run beside the build and phase 1, which time nothing, and are
    # read before the first timed phase
    cli = phase_mesh_cli()
    next(cli)
    phase_build()
    t1 = time.perf_counter()
    errs = phase_kernels(cfg, hcfg)
    log(f"  phase 1 done in {time.perf_counter() - t1:.1f} s")
    next(cli)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # the phases that hold tens of GB of host memory, first, in child
    # processes: the later phases leave the host's memory low.  6v's home
    # takes ~75 GB of the host; 6m, 6x and 6a fit one after another
    for phases in (("phase_vlm_train",), ("phase_moe_train", "phase_xlstm_train",
                                          "phase_audio_train")):
        at(" + ".join(phases))
        isolated(phases, smi)
    at("phase 2")
    from repro_torch.train.steps import init_params

    params = init_params(cfg, SEED, "cuda")  # phases 2 and 2p share them
    res, launches = phase_serve(cfg, PROMPT, "2", ("flash_attention", "decode_attention"), smi,
                                params=params)
    at("phase 2p")
    phase_paged(cfg, params, res, launches)
    at("phase 2w")
    phase_streamed(cfg, params, res, launches)
    del params
    at("phase 2m")
    mlaunches = phase_moe(smi)
    phase_check(cfg, res, PROMPT, "3")
    del res
    at("phase 2q")
    qlaunches = phase_qwen3(smi)
    at("phase 2d")
    dlaunches = phase_dense(smi)
    at("phase 2b")
    hres, hlaunches = phase_serve(hcfg, HYB_PROMPT, "2b",
                                  ("rglru_scan", "flash_attention", "decode_attention"), smi)
    phase_check(hcfg, hres, HYB_PROMPT, "3b")
    del hres
    at("phase 2x")
    phase_xlstm_serve(smi)
    at("phase 2a")
    alaunches = phase_audio_serve(smi)
    at("phase 4")
    launches["streamed_matmul"], sweep = phase_paper(cfg)
    at("phase 6")
    train = phase_train(cfg, smi)
    at("phase 6w")
    phase_train_streamed(cfg, train, smi)
    at("phase 5")
    rows = phase_times(cfg, hcfg, errs, launches, hlaunches, mlaunches, alaunches, qlaunches,
                       dlaunches, sweep, train)
    at("phase 7")
    phase_tables(smi)
    at("phase 8s")
    phase_sharding(cfg, smi)
    at("phase 8c")
    t8 = time.perf_counter()
    torchrun_phase("phase_mesh", smi)
    log(f"  phase 8c (a)-(c), (e)-(g) done in {time.perf_counter() - t8:.1f} s with the child's "
        f"start (its (d) ran beside phases 0 and 1)")
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
