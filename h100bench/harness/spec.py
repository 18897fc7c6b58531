"""What one cell is: found by name, from ``BENCHMARK.json`` and the files
under ``h100bench/``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration is ``configs/<config>.json``, the traffic ``traffic/<traffic>.json``,
the cell's correctness limits ``cells/<cell>.json``, and each metric the
cell reports is read by ``metrics/<metric>.py`` (or, for a metric split by
cells as ``<base>.<part>``, by ``metrics/<base>.py``).  Adding a cell, a mix or a
metric adds files and entries; no existing file changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

#: the benchmark's own folder
BENCH = Path(__file__).resolve().parents[1]
#: the checkout's root (``BENCHMARK.json`` and the program's ``src/``)
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    read: Callable  # ``read(ctx) -> float | None``


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, bench: Path = BENCH) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``, or where there is no
    such file, of the file named by the part of ``name`` before its first
    dot: ``idle_share.chat`` is read by ``metrics/idle_share.py`` (file names
    may hold dots, so the file is loaded by path, not imported)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    modname = "h100bench_metric_" + "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; one
    without applies wherever the end-to-end metric it moves is reported."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in reported if "moves" in entry else True


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    return make_cell(cells[name], spec, bench)


def make_cell(w: dict, spec: dict, bench: Path = BENCH) -> Cell:
    """The cell of workload entry ``w`` under the metric entries of ``spec``
    (a ``BENCHMARK.json``), with its files."""
    name = w["name"]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]

    def metrics(entries, kind):
        return tuple(Metric(m["name"], m["unit"], kind, load_reader(m["name"], bench))
                     for m in entries)

    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(bench / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "cells" / f"{name}.json"),
        end_to_end=metrics(e2e, "end_to_end"),
        per_layer=metrics(per_layer, "per_layer"),
    )


def session_args(config: dict, traffic: dict) -> dict:
    """The ``ServeSession`` arguments of a cell: the configuration's home,
    stream and pages, the traffic's slots and the longest request."""
    args = dict(config["session"])
    args["slots"] = int(traffic["slots"])
    args["max_len"] = int(traffic["prompt_len"][1]) + int(traffic["output_len"][1])
    return args

