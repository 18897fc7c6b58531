#!/usr/bin/env python3
"""Time the decode-attention kernel at each key split it could be built with,
and beside it the decode kernel of another checkout.

    python3 decode_split_sweep.py [--baseline DIR] [--passes N]

``SPLIT_KV`` (keys per block) is one compile-time constant of
``csrc/decode_attention.cu``, mirrored in its wrapper.  For each value in
``SPLITS`` this copies ``chip_smoke.py`` and ``src/`` into
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
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "split_sweep"
SPLITS = (64, 128, 256)

#: (file under src/repro_torch, the line that sets the split, its template)
EDITS = [
    ("csrc/decode_attention.cu", "constexpr int SPLIT_KV = 128;", "constexpr int SPLIT_KV = {};"),
    ("kernels/decode_attention/ops.py", "SPLIT_KV = 128\n", "SPLIT_KV = {}\n"),
]

_BUILD = "import sys; sys.path.insert(0, 'src'); from repro_torch.kernels import _build; _build.build(['decode_attention'])"
_RUN = """
import json, re, statistics, time, torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
import chip_smoke as C
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
resolve_device("cuda")
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
HOLD_CYCLES = 100_000  # ~50 us at the H100's clocks

def event():
    return torch.cuda.Event(enable_timing=True)

def timed(fn, hold, reps=30):
    for _ in range(3):
        fn()
    dev, host = [], []
    for _ in range(reps):
        flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        e0, e1 = event(), event()
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

def flush_ms(reps=10):
    flush.zero_()
    torch.cuda.synchronize()
    e0, e1 = event(), event()
    e0.record()
    for _ in range(reps):
        flush.zero_()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps

def kernel_ms(fn, calls=20):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    # (start, end, name) of each decode kernel on the device, in us; the
    # combine starts while the split kernel runs (programmatic dependent
    # launch) and waits for it, so its own duration overlaps the split's
    ks = sorted((e.time_range.start, e.time_range.end, re.search(r"decode_\\w+", e.name)[0])
                for e in prof.events() if "decode_" in e.name)
    spans, tails = [], []
    for i, (start, end, name) in enumerate(ks):
        if name == "decode_combine_kernel":
            continue
        comb = ks[i + 1] if i + 1 < len(ks) and ks[i + 1][2] == "decode_combine_kernel" else None
        spans.append(((comb[1] if comb else end) - start) / 1e3)
        tails.append((comb[1] - end) / 1e3 if comb else 0.0)
    if not spans:  # the trace held no decode kernel
        return dict(kernels=0)
    return dict(span=statistics.median(spans), combine_tail=statistics.median(tails),
                kernels=len(ks) / calls)

out = {{"flush_ms": flush_ms()}}
for arch in ("smollm-360m", "recurrentgemma-2b"):
    cfg = get_config(arch)
    t = C.PROMPT + C.GEN if arch == "smollm-360m" else cfg.window
    lens = [t, 300, 77, 1] if arch == "smollm-360m" else [t] * C.BATCH
    n, kh, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tol = C.DECODE_256_TOL if h == 256 else dict(rtol=C.RTOL, atol=C.ATOL)
    q, k, v, lengths = C.decode_inputs(len(lens), t, n, kh, h, lens, qk=1.0 if h == 256 else 0.5)
    C.check_close(f"{{arch}} {name}", decode_attention(q, k, v, lengths),
                  decode_attention_ref(q, k, v, lengths), **tol)
    ks, vs = (x.repeat_interleave(n // kh, 2).transpose(1, 2) for x in (k, v))
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    kern = lambda: decode_attention(q, k, v, lengths)
    sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None, :], ks, vs, attn_mask=mask)
    out[arch] = dict(
        kernel={{way: timed(kern, hold) for way, hold in (("events", 0), ("held", HOLD_CYCLES))}},
        sdpa={{way: timed(sdpa, hold) for way, hold in (("events", 0), ("held", HOLD_CYCLES))}},
        host_us=C.host_us(kern), kernels_ms=kernel_ms(kern))
print("RESULT " + json.dumps(out))
"""


def copy_with(name: str, src: Path, split: int | None) -> Path:
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst)
    for rel, line, template in EDITS if split else ():
        path = dst / "src" / "repro_torch" / rel
        text = path.read_text()
        if text.count(line) != 1:
            raise SystemExit(f"the line that sets the split is not once in {rel}: {line!r}")
        path.write_text(text.replace(line, template.format(split)))
    return dst


def fmt(r: dict) -> str:
    return f"{r['mean']:.5f}/{r['median']:.5f}/{r['max']:.5f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an unpacked checkout whose decode kernel is timed too")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    dirs = {str(split): copy_with(str(split), ROOT / "src", split) for split in SPLITS}
    if args.baseline:
        dirs = {"baseline": copy_with("baseline", args.baseline.resolve() / "src", None), **dirs}
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=d) for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a copy's decode kernel did not build")
    order = [name for i in range(args.passes) for name in (list(dirs) if i % 2 == 0 else list(dirs)[::-1])]
    runs, ok = [], True
    for name in order:
        proc = subprocess.run([sys.executable, "-c", _RUN.format(name=name)], cwd=dirs[name],
                              capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        for line in lines:
            if "tolerance" in line:
                print(f"  {line.strip()}")
        result = [ln for ln in lines if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not result:
            print(f"{name}: failed (exit {proc.returncode})\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            ok = False
            continue
        row = json.loads(result[0][len("RESULT "):])
        runs.append({"copy": name, **row})
        print(f"{name} (flush {row['flush_ms']:.4f} ms; mean/median/max ms):")
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
