"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the cell is found by name in
``BENCHMARK.json``, the program in ``src/``.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit).  Exits 2 without a
result when the cell's cards are not there, 1 when the program is missing
or a run loaded JAX.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the program's kernel caches stay in fixed directories of the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole (the
    port, ``repro_torch``, is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from h100bench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("run.py: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 1
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"run.py: the run loaded {bad}", file=sys.stderr)
        return 1
    for k, v in {**res.notes, **res.numbers}.items():
        if k not in res.checks:
            print(f"note {k}: {v!r}", file=sys.stderr)
    for k, c in res.checks.items():  # the last lines on standard error
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": res.metrics, "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = res.checks
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
