#!/usr/bin/env python3
"""Time the decode-attention kernel at each key split it could be built with,
and beside it the decode kernel of another checkout.

    python3 decode_split_sweep.py [--baseline DIR] [--passes N]

``SPLIT_KV`` (keys per block) is one compile-time constant of
``csrc/decode_attention.cu``, mirrored in its wrapper.  For each value in
``SPLITS`` this copies ``chip_smoke.py``, the sweep scripts and ``src/`` into
``build/split_sweep/<split>/`` and sets the constant in both copies.  With
``--baseline DIR`` (an unpacked checkout of another commit, such as
``git archive HEAD~1``) it also copies ``DIR/src`` with this ``chip_smoke.py``
into ``build/split_sweep/baseline/``, so that both kernels are timed by the
same code.  It builds the copies' decode kernels (one ``nvcc`` each, in
parallel), then runs each copy at both serving shapes of ``chip_smoke.py``
phase 5 in its own process, ``N`` passes (default 2) in the order baseline,
``SPLITS``, then reversed, so that drift shows as a difference between a
copy's runs.

Each run first holds the kernel against its plain version at both shapes,
then times the kernel and ``scaled_dot_product_attention`` on the same
inputs, 30 calls each with the L2 flushed before every call, in two ways:

* ``events``: ``chip_smoke.time_ms``'s way (record, call, record); the host
  must enqueue the call while the flush runs, or its delay is counted;
* ``held``: the device also spins ``HOLD_CYCLES`` after the flush, so that
  the call is queued before the first event whatever the host does.

For each it reports the mean, the median and the largest call, and for
every call over twice the median the host's time to enqueue it, beside the
flush's device time (the head start the host has).  It also reports the
host time of one wrapper call (``chip_smoke.host_us``), and from a
``torch.profiler`` trace the kernels a call launches, the median device
span of a call (first kernel's start to last kernel's end) and how far the
combine ends after the split kernel.  Prints one line per run
and a JSON summary; exits 0 iff every copy agrees with the plain version.
Needs a CUDA card and ``nvcc``.

The copy, build and run machinery (:func:`copy_with`, :func:`build_copies`,
:func:`run_copies`) and the timing helpers (:func:`timed`,
:func:`flush_ms`, :func:`device_spans`) serve ``matmul_tile_sweep.py`` too.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "split_sweep"
SPLITS = (64, 128, 256)
#: scripts each copy carries beside ``src/``: the runs import them there
SCRIPTS = ("chip_smoke.py", "decode_split_sweep.py", "matmul_tile_sweep.py")
HOLD_CYCLES = 100_000  # ~50 us at the H100's clocks

#: (file under src/repro_torch, the line that sets the split, its template)
EDITS = [
    ("csrc/decode_attention.cu", "constexpr int SPLIT_KV = 128;", "constexpr int SPLIT_KV = {};"),
    ("kernels/decode_attention/ops.py", "SPLIT_KV = 128\n", "SPLIT_KV = {}\n"),
]


# ---------------------------------------------------------------------------
# copies of the program, each built and run in its own process
# ---------------------------------------------------------------------------

def copy_with(work: Path, name: str, src: Path, edits=()) -> Path:
    """``src`` (a checkout's ``src/``) and this checkout's sweep scripts,
    copied into ``work/name``, with each ``(file under src/repro_torch, line,
    new line)`` of ``edits`` made there; the line must stand once."""
    dst = work / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    for script in SCRIPTS:
        shutil.copy2(ROOT / script, dst)
    for rel, line, new in edits:
        path = dst / "src" / "repro_torch" / rel
        text = path.read_text()
        if text.count(line) != 1:
            raise SystemExit(f"the line to edit is not once in {rel}: {line!r}")
        path.write_text(text.replace(line, new))
    return dst


def build_copies(dirs: dict, kernels: list[str]) -> None:
    """Build ``kernels`` in every copy, all copies at once."""
    code = ("import sys; sys.path.insert(0, 'src'); from repro_torch.kernels import _build; "
            f"_build.build({kernels!r})")
    builds = [subprocess.Popen([sys.executable, "-c", code], cwd=d) for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a copy's kernels did not build")


def run_copies(dirs: dict, call: str, passes: int) -> tuple[list, bool]:
    """Run ``call`` (``module.function``, given the copy's name) in each copy,
    ``passes`` times in the order of ``dirs``, then reversed, and so on.
    Returns the ``RESULT`` JSON of each run, with its copy's name, and
    whether every run ended well.  Prints each run's check lines."""
    module, fn = call.split(".")
    order = [name for i in range(passes) for name in (list(dirs) if i % 2 == 0 else list(dirs)[::-1])]
    runs, ok = [], True
    for name in order:
        proc = subprocess.run([sys.executable, "-c", f"import {module}; {module}.{fn}({name!r})"],
                              cwd=dirs[name], capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        for line in lines:
            if "tolerance" in line:
                print(f"  {line.strip()}")
        result = [ln for ln in lines if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not result:
            print(f"{name}: failed (exit {proc.returncode})\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            ok = False
            continue
        runs.append({"copy": name, **json.loads(result[0][len("RESULT "):])})
    return runs, ok


# ---------------------------------------------------------------------------
# timing on the card (in a copy's process)
# ---------------------------------------------------------------------------

def flush_buffer():
    """256 MB on the card: zeroing it evicts the 50 MB L2."""
    import torch

    return torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")


def timed(fn, flush, hold: int, reps: int = 30) -> dict:
    """``reps`` calls of ``fn``, each after an L2 flush (and ``hold`` cycles
    of device spin): mean, median and largest time, and ``[device ms, host
    enqueue ms]`` of each call over twice the median."""
    import torch

    for _ in range(3):
        fn()
    dev, host = [], []
    for _ in range(reps):
        flush.zero_()
        if hold:
            torch.cuda._sleep(hold)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host.append((time.perf_counter() - h0) * 1e3)
        e1.synchronize()
        dev.append(e0.elapsed_time(e1))
    med = statistics.median(dev)
    return dict(mean=statistics.fmean(dev), median=med, max=max(dev),
                slow=[[d, h] for d, h in zip(dev, host) if d > 2 * med])


def both_ways(fn, flush) -> dict:
    return {way: timed(fn, flush, hold) for way, hold in (("events", 0), ("held", HOLD_CYCLES))}


def flush_ms(flush, reps: int = 10) -> float:
    """Device time of one flush."""
    import torch

    flush.zero_()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        flush.zero_()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_spans(fn, flush, kernel: str, tail: str, calls: int = 20) -> dict:
    """From a ``torch.profiler`` trace of ``calls`` calls (L2 flushed before
    each): the kernels a call launches whose names match ``kernel``, the
    median device span of a call (its first kernel's start to its last
    kernel's end, the ``tail`` kernel included) and how far the ``tail``
    kernel ends after the one before it, in us.  A ``tail`` kernel starts
    while the one before runs (programmatic dependent launch) and waits for
    it, so its own duration overlaps that kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ks = sorted((e.time_range.start, e.time_range.end, re.search(kernel, e.name)[0])
                for e in prof.events() if re.search(kernel, e.name))
    spans, tails = [], []
    for i, (start, end, name) in enumerate(ks):
        if name == tail:
            continue
        nxt = ks[i + 1] if i + 1 < len(ks) and ks[i + 1][2] == tail else None
        spans.append(((nxt[1] if nxt else end) - start) / 1e3)
        tails.append((nxt[1] - end) / 1e3 if nxt else 0.0)
    if not spans:  # the trace held no such kernel
        return dict(kernels=0)
    return dict(span=statistics.median(spans), tail=statistics.median(tails), kernels=len(ks) / calls,
                names=sorted({k[2] for k in ks}))


def fmt(r: dict) -> str:
    return f"{r['mean']:.5f}/{r['median']:.5f}/{r['max']:.5f}"


# ---------------------------------------------------------------------------
# the decode sweep
# ---------------------------------------------------------------------------

def run_decode(name: str) -> None:
    """In a copy: check, then time its decode kernel at both serving shapes;
    prints ``RESULT`` and the JSON of the run."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    resolve_device("cuda")
    flush = flush_buffer()
    out = {"flush_ms": flush_ms(flush)}
    for arch in ("smollm-360m", "recurrentgemma-2b"):
        cfg = get_config(arch)
        t = C.PROMPT + C.GEN if arch == "smollm-360m" else cfg.window
        lens = [t, 300, 77, 1] if arch == "smollm-360m" else [t] * C.BATCH
        n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        tol = C.DECODE_256_TOL if h == 256 else dict(rtol=C.RTOL, atol=C.ATOL)
        q, k, v, lengths = C.decode_inputs(len(lens), t, n, kh, h, lens, qk=1.0 if h == 256 else 0.5)
        C.check_close(f"{arch} {name}", decode_attention(q, k, v, lengths),
                      decode_attention_ref(q, k, v, lengths), **tol)
        ks, vs = (x.repeat_interleave(n // kh, 2).transpose(1, 2) for x in (k, v))
        mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        kern = lambda: decode_attention(q, k, v, lengths)
        sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None, :], ks, vs, attn_mask=mask)
        out[arch] = dict(kernel=both_ways(kern, flush), sdpa=both_ways(sdpa, flush),
                         host_us=C.host_us(kern),
                         kernels_ms=device_spans(kern, flush, r"decode_\w+", "decode_combine_kernel"))
    print("RESULT " + json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an unpacked checkout whose decode kernel is timed too")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    dirs = {str(split): copy_with(WORK, str(split), ROOT / "src",
                                  [(rel, line, tmpl.format(split)) for rel, line, tmpl in EDITS])
            for split in SPLITS}
    if args.baseline:
        dirs = {"baseline": copy_with(WORK, "baseline", args.baseline.resolve() / "src"), **dirs}
    build_copies(dirs, ["decode_attention"])
    runs, ok = run_copies(dirs, "decode_split_sweep.run_decode", args.passes)
    for row in runs:
        print(f"{row['copy']} (flush {row['flush_ms']:.4f} ms; mean/median/max ms):")
        for arch in ("smollm-360m", "recurrentgemma-2b"):
            r = row[arch]
            slow = [f"{d:.4f} ms after {h:.3f} ms enqueue" for way in ("events", "held")
                    for d, h in r["kernel"][way]["slow"]]
            print(f"  {arch}: kernel events {fmt(r['kernel']['events'])} held {fmt(r['kernel']['held'])}; "
                  f"SDPA events {fmt(r['sdpa']['events'])} held {fmt(r['sdpa']['held'])}; "
                  f"host {r['host_us']:.1f} us a call; on the device {r['kernels_ms']}; slow calls {slow}")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"split_sweep": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
