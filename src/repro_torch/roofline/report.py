"""Render the dry-run and roofline tables from a rows JSON (one dict per
(arch x shape x mesh) cell, the JAX package's ``results/dryrun.json``
layout):

  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun.json
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt_ms(s):
    return f"{s*1e3:.1f}"


def dryrun_table(rows: list[dict]) -> str:
    out = [
        "| arch | shape | mesh | status | compile s | mem/dev GiB | HLO GFLOP/dev | coll GB/dev (raw AG/AR/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]), r["mesh"])  # noqa: E731
    for r in sorted(rows, key=key):
        if not r.get("runnable", True):
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP ({r['skip_reason'][:40]}…) | — | — | — | — |"
            )
            continue
        if not r.get("ok"):
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL** {r.get('error','')[:60]} | — | — | — | — |"
            )
            continue
        mem = r["memory"]["per_device_total_gib"]
        fl = r["cost_raw"]["flops"] / 1e9
        c = r["coll_raw"]
        coll = "/".join(
            f"{c.get(k,0)/1e9:.2f}"
            for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
        )
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['compile_s']} | "
            f"{mem:.2f} | {fl:.0f} | {coll} |"
        )
    return "\n".join(out)


def roofline_table(rows: list[dict]) -> str:
    out = [
        "| arch | shape | t_compute ms | t_memory ms (analytic) | t_mem ms (HLO) | t_collective ms | dominant | MODEL/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]))  # noqa: E731
    for r in sorted([r for r in rows if r.get("roofline")], key=key):
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_ms(t['t_compute_s'])} | "
            f"{_fmt_ms(t['t_memory_s'])} | {_fmt_ms(t.get('t_memory_hlo_s', 0))} | "
            f"{_fmt_ms(t['t_collective_s'])} | {t['dominant']} | "
            f"{t['model_flops_ratio']:.3f} | {t['roofline_fraction']:.3f} |"
        )
    return "\n".join(out)


def pick_hillclimb(rows: list[dict]) -> list[tuple[str, dict]]:
    """worst roofline fraction / most collective-bound / most paper-representative."""
    cand = [r for r in rows if r.get("roofline")]
    if not cand:
        return []
    worst = min(cand, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(
        cand,
        key=lambda r: r["roofline"]["t_collective_s"]
        / max(r["roofline"]["t_dominant_s"], 1e-30),
    )
    # paper-representative: the memory-hierarchy-bound serve step with the
    # largest streamed state (decode of the biggest cache)
    decodes = [r for r in cand if r.get("step_kind") == "decode"]
    paper = max(
        decodes or cand, key=lambda r: r["probe"]["analytic_bytes"]
    )
    return [("worst-fraction", worst), ("most-collective-bound", coll), ("paper-representative", paper)]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0] if argv else "results/dryrun.json")
    rows = json.loads(path.read_text())
    print("## §Dry-run\n")
    print(dryrun_table(rows))
    single = [r for r in rows if r["mesh"] == "16x16"]
    print("\n## §Roofline (single-pod, probe-scaled)\n")
    print(roofline_table(single))
    print("\n## Hillclimb candidates\n")
    for tag, r in pick_hillclimb(single):
        t = r["roofline"]
        print(
            f"- **{tag}**: {r['arch']} x {r['shape']} "
            f"(dominant={t['dominant']}, fraction={t['roofline_fraction']:.3f})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
