"""Paper Table 1 analogue: throughput / power across hardware classes.

    PYTHONPATH=src python -m repro_torch.benchmarks.power_model [--device cpu]

The paper measures LINPACK MFLOPs and Watts on Epiphany / MicroBlaze /
Cortex-A9 and situates micro-cores against embedded and HPC parts.  The JAX
package's ``benchmarks/power_model.py`` has no power meter; the card does.
The table holds:

  * measured on the card: ``a @ a`` by ``torch.matmul`` (TF32 off) at the
    JAX package's n = 1024 in f32, and at n = 8192 in f32 and in bf16,
    where the product fills an H100; each row runs ``WINDOW_S`` after a
    ``WARMUP_S`` warm-up, while ``nvidia-smi`` samples the board's power
    and SM clock every 100 ms in a subprocess.  GFLOP/s is the mean over
    the window, watts the mean of the window's samples, GFLOP/W their
    quotient; the idle draw is read first;
  * derived: the H100's bf16 dense peak from ``roofline.hw.H100`` at its
    700 W board power, and the JAX package's TPU v5e row as it cites it;
  * cited: the paper's own rows and its Pascal row.

On the CPU (``--device cpu``) the measured row is the JAX package's
(``container CPU core (measured f32)``, n = 1024) and its watts read
``"n/a"``.  A missing ``nvidia-smi`` on the card is an error.

Writes ``results/torch/table1_power.json``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.roofline.hw import H100, V5E

#: the H100 SXM's maximum board power (the data sheet's; a card's
#: ``power.limit`` may be set lower)
H100_BOARD_W = 700.0
#: the JAX package's ~200 W-class envelope for its TPU v5e row
V5E_ENVELOPE_W = 200.0
IDLE_S, WARMUP_S, WINDOW_S = 2.0, 2.0, 5.0
SAMPLE_MS = 100
#: the measured rows on the card: (n, dtype)
CARD_ROWS = ((1024, torch.float32), (8192, torch.float32), (8192, torch.bfloat16))
#: a burst of products between synchronises lasts about this long
BURST_S = 0.05

#: the paper's Table 1 rows and its Pascal row, as the JAX package cites them
CITED_ROWS = [
    {"technology": "Epiphany-III (paper)", "gflops": 1.508, "watts": 0.90,
     "gflops_per_watt": 1.676},
    {"technology": "MicroBlaze+FPU (paper)", "gflops": 0.0472, "watts": 0.18,
     "gflops_per_watt": 0.262},
    {"technology": "Cortex A-9 (paper)", "gflops": 0.0332, "watts": 0.60,
     "gflops_per_watt": 0.055},
    {"technology": "Pascal GPU (paper, cited)", "gflops": None, "watts": 250.0,
     "gflops_per_watt": 42.0},
]


def measured_matmul_gflops(n: int = 1024, repeats: int = 5, device: DeviceLike = "cpu") -> float:
    """The JAX package's measured row: ``x = x @ x`` in f32, ``repeats``
    times after one warm-up call, timed on the host clock."""
    dev = resolve_device(device)
    x = torch.ones((n, n), dtype=torch.float32, device=dev)
    torch.matmul(x, x)
    C._sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        x = torch.matmul(x, x)
    C._sync()
    dt = (time.perf_counter() - t0) / repeats
    return 2 * n ** 3 / dt / 1e9


def power_field(device: torch.device) -> str:
    """``power.draw.instant`` where ``nvidia-smi`` knows the field, else
    ``power.draw``.  Raises when ``nvidia-smi`` is missing."""
    probe = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw.instant", "--format=csv,noheader,nounits",
         "-i", C.smi_index(device)], capture_output=True, text=True, timeout=60)
    try:
        float(probe.stdout.strip().splitlines()[0])
        return "power.draw.instant"
    except (ValueError, IndexError):
        return "power.draw"


class PowerSampler:
    """``nvidia-smi -lms`` in a subprocess: the board's power and SM clock
    every ``interval_ms``, each line stamped on the host clock by a reader
    thread as it arrives.  The subprocess is killed on exit."""

    def __init__(self, device: torch.device, interval_ms: int = SAMPLE_MS) -> None:
        self.field = power_field(device)
        self._cmd = ["nvidia-smi", f"--query-gpu={self.field},clocks.sm",
                     "--format=csv,noheader,nounits", "-lms", str(interval_ms),
                     "-i", C.smi_index(device)]
        self._lock = threading.Lock()
        #: (host time, watts, SM MHz)
        self.samples: list[tuple[float, float, float]] = []
        self._proc: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "PowerSampler":
        self._proc = subprocess.Popen(self._cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        try:
            self._thread = threading.Thread(target=self._read, name="power-sampler", daemon=True)
            self._thread.start()
        except BaseException:
            self._stop()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._stop()

    def _stop(self) -> None:
        try:
            self._proc.kill()
        finally:
            self._proc.wait(timeout=10)
            if self._thread is not None:
                self._thread.join(timeout=10)

    def _read(self) -> None:
        for line in self._proc.stdout:
            t = time.perf_counter()
            parts = [p.strip() for p in line.split(",")]
            try:
                sample = (t, float(parts[0]), float(parts[1]))
            except (ValueError, IndexError):
                continue  # "[N/A]" or a partial line
            with self._lock:
                self.samples.append(sample)

    def window(self, t0: float, t1: float) -> list[tuple[float, float, float]]:
        with self._lock:
            return [s for s in self.samples if t0 <= s[0] <= t1]


def _burst_loop(fn, seconds: float) -> tuple[int, float, float]:
    """Call ``fn`` (one burst of ``k`` products, returning ``k``) until
    ``seconds`` have passed, synchronising after each burst.  Returns
    ``(products, t0, t1)``."""
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        done += fn()
        torch.cuda.synchronize()
    return done, t0, time.perf_counter()


def measure_card_row(n: int, dtype: torch.dtype, device: torch.device,
                     sampler: PowerSampler) -> dict:
    """``a @ a`` at ``n`` in ``dtype`` for ``WINDOW_S`` after ``WARMUP_S``;
    GFLOP/s over the window beside the window's mean power."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=device).to(dtype)
    out = torch.empty_like(a)
    torch.matmul(a, a, out=out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.matmul(a, a, out=out)
    torch.cuda.synchronize()
    k = max(1, int(BURST_S / max(time.perf_counter() - t0, 1e-6)))

    def burst() -> int:
        for _ in range(k):
            torch.matmul(a, a, out=out)
        return k

    _burst_loop(burst, WARMUP_S)
    calls, t0, t1 = _burst_loop(burst, WINDOW_S)
    gflops = 2 * n ** 3 * calls / (t1 - t0) / 1e9
    samples = sampler.window(t0, t1)
    if not samples:
        raise RuntimeError(f"nvidia-smi gave no {sampler.field} sample in the {n}^3 window")
    watts = float(np.mean([s[1] for s in samples]))
    name = "f32" if dtype == torch.float32 else "bf16"
    return {"technology": f"H100 (measured {name}, n={n})", "gflops": gflops, "watts": watts,
            "gflops_per_watt": gflops / watts, "n": n, "dtype": name, "products": calls,
            "window_s": t1 - t0, "n_samples": len(samples),
            "sm_mhz": float(np.mean([s[2] for s in samples])), "power_field": sampler.field}


def derived_rows() -> list[dict]:
    """The H100's bf16 peak at its board power, and the JAX package's TPU
    v5e row as it cites it."""
    return [
        {"technology": "H100 SXM (peak bf16)", "gflops": H100.peak_flops_bf16 / 1e9,
         "watts": H100_BOARD_W, "gflops_per_watt": H100.peak_flops_bf16 / 1e9 / H100_BOARD_W},
        {"technology": "TPU v5e chip (peak bf16)", "gflops": V5E.peak_flops_bf16 / 1e9,
         "watts": V5E_ENVELOPE_W, "gflops_per_watt": V5E.peak_flops_bf16 / 1e9 / V5E_ENVELOPE_W},
    ]


def run(device: DeviceLike = None) -> list[dict]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        with PowerSampler(dev) as sampler:
            time.sleep(IDLE_S)
            t1 = time.perf_counter()
            idle = sampler.window(t1 - IDLE_S, t1)
            if not idle:
                raise RuntimeError(f"nvidia-smi gave no {sampler.field} sample while idle")
            idle_w = float(np.mean([s[1] for s in idle]))
            measured = [measure_card_row(n, dt, dev, sampler) for n, dt in CARD_ROWS]
        for r in measured:
            r["idle_watts"] = idle_w
    else:
        cpu = measured_matmul_gflops(device=dev)
        measured = [{"technology": "container CPU core (measured f32)", "gflops": round(cpu, 1),
                     "watts": "n/a", "gflops_per_watt": "n/a"}]
    rows = measured + derived_rows() + [dict(r) for r in CITED_ROWS]
    C.print_table(f"paper Table 1 analogue: throughput / power — {C.card_label(dev)}", rows,
                  ["technology", "gflops", "watts", "gflops_per_watt"])
    if dev.type == "cuda":
        C.print_table("measured rows: the window's power samples", measured,
                      ["technology", "n_samples", "sm_mhz", "idle_watts", "window_s",
                       "power_field"])
    C.save_rows("table1_power", rows)
    return rows


def main(device: DeviceLike = None) -> int:
    run(device)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
