"""Greedy-decode serving on one card: the unpaged device-resident path.

The counterpart of the JAX package's ``serve(..., kv_page_len=0)`` with
``kv_kind="device"`` (``repro/launch/serve.py:_serve_unpaged``), with its two
schedules.  Pageable (full-attention) caches: one prefill per request, the
caches stacked on the batch axis, and per-slot positions.  Ring and
recurrent caches (recurrentgemma's; ``slot_pos`` is shared across the
batch): one batched prefill of all prompts and one scalar position per step
(lock-step).  Either way a warm-up decode runs on a copy of the caches, then
a timed greedy loop.  It is the baseline every serving placement must match.

The paged ``ServeSession``, host and disk cache kinds, streamed weights,
the load generator and model parallelism are later slices (ROADMAP.md).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32 --kv-page-len 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 3072 --gen 32 --kv-page-len 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --smoke --device cpu --kv-page-len 0
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.hoststream import StreamStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.train import steps as st

KV_KINDS = ("device", "pinned_host", "disk_host")
PARAM_KINDS = ("device", "pinned_host", "disk_host")

_PAGED = "the paged ServeSession (ROADMAP.md, queue 1 item 3)"
_STREAMED = "streamed weights (ROADMAP.md, queue 1 item 4)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def lock_step(cfg) -> bool:
    """True iff ``cfg`` serves in lock-step: its caches hold a ring
    (``slot_pos`` shared across the batch) or recurrent states, so requests
    cannot be prefilled one at a time or decoded at per-slot positions."""
    return not st.paged_cache_supported(st.abstract_caches(cfg, 1, 1))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[..., -1, :].argmax(dim=-1).to(torch.int32)


def prefill_all(cfg, params: ParamTree, prompts: torch.Tensor, max_len: int) -> tuple[torch.Tensor, dict]:
    """Prefill every row of ``prompts`` ((B, S) token ids on the device) into
    caches of ``max_len`` positions.  Returns each request's first greedy
    token ((B,) int32) and the caches.  Pageable caches prefill one request
    at a time and stack on the batch axis; in :func:`lock_step` all rows
    prefill in one batch."""
    if lock_step(cfg):
        logits, caches = st.make_prefill_step(cfg, prompts.shape[0], max_len)(params, {"tokens": prompts})
        return _greedy(logits), caches
    prefill_fn = st.make_prefill_step(cfg, 1, max_len)
    first, slot_caches = [], []
    for b in range(prompts.shape[0]):
        logits, cache = prefill_fn(params, {"tokens": prompts[b:b + 1]})
        first.append(_greedy(logits))
        slot_caches.append(cache)
    # (L, B, T, K, H): requests stack on the batch axis
    return torch.cat(first), {k: torch.cat([c[k] for c in slot_caches], dim=1) for k in slot_caches[0]}


def step_pos(cfg, batch: int, pos: int, device) -> torch.Tensor:
    """The decode step's position ``pos``: one per slot ((B,) int32), or one
    scalar in :func:`lock_step`."""
    return torch.full(() if lock_step(cfg) else (batch,), pos, dtype=torch.int32, device=device)


def serve_loop(
    cfg,
    params: ParamTree,
    prompts: np.ndarray,
    gen: int,
    *,
    device: torch.device,
    warmup: bool = True,
) -> dict:
    """Serve one greedy request per row of ``prompts`` ((B, S) int32) for
    ``gen`` tokens with ``params`` on ``device``.

    The first token of each request comes from its prefill
    (:func:`prefill_all`); ``gen - 1`` decode steps follow.  Tokens stay on
    the device until the loop ends.
    """
    batch, prompt_len = prompts.shape
    # decided before the clock starts: the first call builds a cache tree on
    # the meta device, a one-time cost of the process that is not prefill
    lock_step(cfg)
    decode_fn = st.make_decode_step(cfg)
    prompts_t = torch.tensor(np.asarray(prompts), dtype=torch.long, device=device)

    def step_batch(tok: torch.Tensor) -> dict:
        return {"tokens": tok.to(torch.long).reshape(-1, 1)}

    t0 = time.perf_counter()
    tokens, caches = prefill_all(cfg, params, prompts_t, prompt_len + gen)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    if warmup:
        # one step on a throwaway copy (the step updates caches in place), so
        # the timed loop does not include first-call costs such as the kernels'
        # build and load
        caches_w = st.clone_caches(caches)
        decode_fn(params, caches_w, step_batch(tokens), step_pos(cfg, batch, prompt_len, device))
        del caches_w
        _sync(device)

    out_tokens = [tokens]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = step_pos(cfg, batch, prompt_len + i, device)
        logits, caches = decode_fn(params, caches, step_batch(tokens), pos)
        tokens = _greedy(logits)
        out_tokens.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0

    generated = torch.stack(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        # gen-1 decode steps: the first token per slot comes from prefill
        "tokens_per_s": batch * (gen - 1) / t_decode if t_decode else float("inf"),
        "generated": generated,
        "stats": StreamStats(),  # device-resident caches: nothing streams
        "paged": False,
        "n_steps": gen - 1,
    }


def serve(
    cfg,
    *,
    batch: int,
    prompt_len: int,
    gen: int,
    kv_kind: str = "device",
    kv_page_len: int = 32,
    seed: int = 0,
    n_requests: Optional[int] = None,
    warmup: bool = True,
    param_kind: str = "device",
    device: DeviceLike = None,
) -> dict:
    """Serve ``batch`` greedy requests of ``prompt_len`` random prompt tokens
    and ``gen`` generated tokens, with random weights from ``seed``.

    Only ``kv_page_len=0`` with ``kv_kind="device"`` and
    ``param_kind="device"`` is ported; the rest raises
    ``NotImplementedError``.  The defaults are the JAX package's.  Runs on
    the card unless ``device="cpu"`` is passed.  Prompts come from
    ``np.random.default_rng(seed + 1)``.
    """
    device = resolve_device(device)
    if kv_page_len > 0:
        raise NotImplementedError(f"kv_page_len > 0 needs {_PAGED}; pass kv_page_len=0")
    if kv_kind != "device":
        raise NotImplementedError(f"kv_kind={kv_kind!r} needs {_PAGED}")
    if param_kind != "device":
        raise NotImplementedError(f"param_kind={param_kind!r} needs {_STREAMED}")
    if (n_requests or batch) != batch:
        raise ValueError("the unpaged path serves exactly one request per slot")
    params = st.init_params(cfg, seed, device)
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(1, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    return serve_loop(cfg, params, prompts, gen, device=device, warmup=warmup)


#: flags of the JAX entry point that this slice does not serve, and where
#: their port is queued; any value but the default exits
_NOT_PORTED = {
    "requests": _PAGED,
    "hot_pages": _PAGED,
    "distance": _PAGED,
    "spill_dir": _PAGED,
    "no_prefix_sharing": _PAGED,
    "shared_prefix_len": _PAGED,
    "param_kind": _STREAMED,
    "device_budget_mb": _STREAMED,
    "param_cache_mb": _STREAMED,
    "expert_stream": _STREAMED,
    "verify_schedule": _STREAMED,
    "loadgen": "the load generator and SLO scheduler (ROADMAP.md, queue 1 item 3)",
    "model_parallel": "model parallelism (ROADMAP.md, queue 1 item 5: multi-device and tooling)",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--kv-kind", default="device", choices=KV_KINDS)
    ap.add_argument("--kv-page-len", type=int, default=32,
                    help="tokens per KV page (0 = unpaged path, the only one ported)")
    ap.add_argument("--hot-pages", type=int, default=1)
    ap.add_argument("--distance", default="auto")
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--param-kind", default="device", choices=PARAM_KINDS)
    ap.add_argument("--device-budget-mb", type=float, default=None)
    ap.add_argument("--param-cache-mb", type=float, default=None)
    ap.add_argument("--expert-stream", action="store_true")
    ap.add_argument("--verify-schedule", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--shared-prefix-len", type=int, default=0)
    ap.add_argument("--loadgen", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args()

    for dest, where in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            ap.exit(2, f"--{dest.replace('_', '-')} is not ported yet: it needs {where}\n")
    if args.kv_page_len > 0:
        ap.exit(2, f"--kv-page-len > 0 needs {_PAGED}; pass --kv-page-len 0\n")
    if args.kv_kind != "device":
        ap.exit(2, f"--kv-kind {args.kv_kind} needs {_PAGED}\n")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")  # the CUDA attention kernels
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                kv_page_len=args.kv_page_len, seed=args.seed, device=args.device)
    print(
        f"served {args.arch}: prefill {res['prefill_s']*1e3:.1f} ms, "
        f"decode {res['decode_s']*1e3:.1f} ms total, "
        f"{res['tokens_per_s']:.1f} tok/s "
        f"(kv_kind={args.kv_kind}, page_len={args.kv_page_len}, "
        f"paged={res['paged']}, device={args.device})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
