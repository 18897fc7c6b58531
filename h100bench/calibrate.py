"""The readings that a cell's correctness limits are set from: for each
seed, one run of the cell (its own window and load) and the numbers
compared for the program's served tokens and for the control's (the
reference in float8 e4m3 in the program's place), printed as JSON lines.

    python3 h100bench/calibrate.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

All seeds run in one process (the set-up's one-time costs are paid once);
the benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--detail", help="a file for every compared token's gaps (JSON lines)")
    args = ap.parse_args()

    import torch

    from h100bench.harness import runner, spec

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        res = runner.run(cell, seed, args.seconds, False, time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": res.correct, **res.numbers,
                          "metrics": {k: v["value"] for k, v in res.metrics.items()},
                          "notes": res.notes}), flush=True)
        if args.detail:
            with open(args.detail, "a") as f:
                f.write(json.dumps({"seed": seed, **res.detail}) + "\n")
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
