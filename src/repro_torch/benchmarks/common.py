"""Shared benchmark utilities: the paper's ML workload, timing, reporting."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: where the port's benchmarks write their rows (gitignored; the JAX
#: package's committed ``results/bench`` stays its own)
RESULTS_DIR = Path("results/torch")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable[[], Any], *, repeats: int = 3, warmup: int = 1, stats: Any = None) -> dict:
    """Median wall time of ``fn()``, each call ended by a synchronise of the
    card.  ``stats`` (a ``StreamStats``) is ``reset()`` after the warmup, so
    its counters cover exactly the ``repeats`` timed runs."""
    for _ in range(warmup):
        fn()
        _sync()
    if stats is not None:
        stats.reset()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync()
        ts.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(ts)), "min_s": min(ts), "max_s": max(ts),
            "repeats": repeats}


def save_rows(name: str, rows: list[dict]) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / f"{name}.json"
    out.write_text(json.dumps(rows, indent=1, default=str))
    return out


def print_table(title: str, rows: list[dict], cols: list[str]) -> None:
    print(f"\n== {title} ==")
    header = " | ".join(f"{c:>18s}" for c in cols)
    print(header)
    print("-" * len(header))
    for r in rows:
        print(" | ".join(f"{_fmt(r.get(c)):>18s}" for c in cols))


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


# ---------------------------------------------------------------------------
# The paper's ML benchmark (§5): 1-hidden-layer NN over 3D-scan-like images.
# Phases: feed forward / combine gradients / model update.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LungNNConfig:
    n_pixels: int  # 3600 (small) / "full" ~7M in the paper
    n_hidden: int = 100
    batch_images: int = 8
    seed: int = 0

    @property
    def image_bytes(self) -> int:
        return self.n_pixels * 4


def init_lung_nn(cfg: LungNNConfig, device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """Weights from ``cfg.seed`` with an explicit ``torch.Generator`` on the
    device (not the JAX package's numbers: the generators differ)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    w1 = torch.randn((cfg.n_pixels, cfg.n_hidden), generator=g, device=dev) * 0.01
    w2 = torch.randn((cfg.n_hidden, 1), generator=g, device=dev) * 0.1
    return {"w1": w1, "w2": w2}


def make_images(cfg: LungNNConfig, n: int, device: DeviceLike = None):
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    xs = torch.randn((n, cfg.n_pixels), generator=g, device=dev)
    ys = (xs[:, ::97].sum(dim=-1, keepdim=True) > 0).float()
    return xs, ys


def feed_forward(params, x):
    h = torch.sigmoid(x @ params["w1"])
    return torch.sigmoid(h @ params["w2"])


def loss_fn(params, x, y):
    p = feed_forward(params, x)
    return torch.mean((p - y) ** 2)


combine_gradients = torch.func.grad(loss_fn)


def model_update(params, grads, lr=0.1):
    return {k: p - lr * grads[k] for k, p in params.items()}
