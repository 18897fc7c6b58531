#!/usr/bin/env python3
"""Show that chip_smoke.py's kernel checks catch planted faults in the
kernels.

    python3 fault_check.py

For the unmodified kernels and for each fault in ``FAULTS`` it copies
``chip_smoke.py`` and ``src/`` into ``build/fault_check/<name>/``, edits one
line of a kernel source there, and runs the chip_smoke check of that source
(``CHECKS``: ``check_attention_256`` for the attention kernels,
``check_streamed_matmul`` for the matmul) in that copy, whose kernels build
from the copy's sources; the unmodified copy runs every check.  The f32
route's two faults (its combine skips the last split; each split's run of
k-tiles stops one short) must fail ``check_streamed_matmul`` too.  It prints
each run's check lines (the largest |kernel - plain| and its share of the
tolerance) and exits 0 iff the unmodified kernels pass and every planted
fault fails.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "fault_check"

#: name -> (kernel source, line as it is, line with the fault)
FAULTS = {
    "decode_drops_last_ring_stage": (
        "decode_attention.cu",
        "const int n_stage = (stop - start + BKV - 1) / BKV;",
        "const int n_stage = (stop - start + BKV - 1) / BKV - 1;",
    ),
    "decode_combine_skips_last_split": (
        "decode_attention.cu",
        "const int n_used = (len + SPLIT_KV - 1) / SPLIT_KV;",
        "const int n_used = (len + SPLIT_KV - 1) / SPLIT_KV - 1;",
    ),
    "flash_window_off_by_one": (
        "flash_attention.cu",
        "if (window) ok = ok && kpos > qp - window;",
        "if (window) ok = ok && kpos >= qp - window;",
    ),
    "streamed_matmul_tensor_cores_stop_one_tile_short": (
        "streamed_matmul.cu",
        "for (int kt = 0; kt < n_kt; ++kt) {",
        "for (int kt = 0; kt < n_kt - 1; ++kt) {",
    ),
    "streamed_matmul_f32_combine_skips_last_split": (
        "streamed_matmul.cu",
        "for (int s = 1; s < splits; ++s) acc = add(acc, part[s * count + i]);",
        "for (int s = 1; s < splits - 1; ++s) acc = add(acc, part[s * count + i]);",
    ),
    "streamed_matmul_f32_split_stops_one_tile_short": (
        "streamed_matmul.cu",
        "const int n = max(0, min(kps, n_kt - kt0));",
        "const int n = max(0, min(kps, n_kt - kt0) - 1);",
    ),
}

#: kernel source -> the chip_smoke check (and its model config) that must catch its faults
CHECKS = {
    "decode_attention.cu": ("check_attention_256", "recurrentgemma-2b"),
    "flash_attention.cu": ("check_attention_256", "recurrentgemma-2b"),
    "streamed_matmul.cu": ("check_streamed_matmul", "smollm-360m"),
}

_RUN = """
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
resolve_device("cuda")
for check, config in {checks!r}:
    getattr(chip_smoke, check)(get_config(config))
"""


def copy_with(name: str, fault) -> Path:
    """A copy of the checkout's program under ``WORK/name`` with ``fault``
    (``None``: unmodified) planted in it."""
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst)
    if fault is not None:
        source, line, planted = fault
        path = dst / "src" / "repro_torch" / "csrc" / source
        text = path.read_text()
        if text.count(line) != 1:
            raise SystemExit(f"{name}: the line to edit is not once in {source}: {line!r}")
        path.write_text(text.replace(line, planted))
    return dst


def main() -> int:
    runs = {"unmodified": None, **FAULTS}
    every_check = sorted(set(CHECKS.values()))
    procs = {name: subprocess.Popen(
                 [sys.executable, "-c",
                  _RUN.format(checks=every_check if fault is None else [CHECKS[fault[0]]])],
                 cwd=copy_with(name, fault), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, fault in runs.items()}
    failed = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        failed[name] = proc.returncode != 0
        print(f"{name}: {'fails' if failed[name] else 'passes'} (exit {proc.returncode})")
        for line in out.splitlines():
            if "tolerance" in line or "Error" in line:
                print(f"  {line.strip()}")
    shutil.rmtree(WORK, ignore_errors=True)
    caught = not failed["unmodified"] and all(failed[name] for name in FAULTS)
    print(f"unmodified kernels pass and every planted fault fails: {caught}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
