"""A cell, a traffic mix and a metric are found by their files' names alone:
adding one adds files and ``BENCHMARK.json`` entries and edits no file of
the benchmark."""
import hashlib
import json
import shutil

import pytest

from h100bench.harness import spec


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_of_the_benchmark_loads():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m.name for m in cell.end_to_end}
        for m in cell.per_layer:
            assert m.kind == "per_layer" and callable(m.read)
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).exists()


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = tmp_path / "h100bench"
    shutil.copytree(spec.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    (bench / "traffic" / "chat-burst.json").write_text(json.dumps(
        {"loop": "open", "slots": 32, "prompt_len": [256, 2048], "output_len": [16, 128],
         "phases": [{"share": 2, "rate_rps": 1.0}, {"share": 1, "rate_rps": 6.0}]}))
    (bench / "cells" / "internlm2-20b.chat-burst.json").write_text(json.dumps(
        {"sample": {"requests": 8, "finished_only": True},
         "limits": {"max_logit_gap": 1.0}}))
    (bench / "metrics" / "burst_share.chat-burst.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    doc = spec.load_json(spec.ROOT / "BENCHMARK.json")
    doc["workloads"].append({"name": "internlm2-20b.chat-burst", "config": "internlm2-20b",
                             "traffic": "chat-burst", "chips": 1, "why": "bursts"})
    doc["per_layer"].append({"name": "burst_share.chat-burst", "unit": "%", "better": "lower",
                             "source": "host_clock", "layer": "device", "moves": "ttft_p90_ms",
                             "workloads": ["internlm2-20b.chat-burst"]})
    for m in doc["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append("internlm2-20b.chat-burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = spec.load_cell("internlm2-20b.chat-burst", tmp_path, bench)
    assert cell.traffic["phases"][1]["rate_rps"] == 6.0
    assert cell.config["name"] == "internlm2-20b"
    assert [m.name for m in cell.per_layer] == ["burst_share.chat-burst"]
    assert cell.per_layer[0].read(None) == 42.0
    assert {m.name for m in cell.end_to_end} == {"setup_s", "tpot_p90_ms", "ttft_p90_ms"}
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_split_metric_is_read_by_its_base_file(tmp_path):
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "idle_share.py").write_text("def read(ctx):\n    return 1.0\n")
    (metrics / "idle_share.burst.py").write_text("def read(ctx):\n    return 2.0\n")
    assert spec.load_reader("idle_share.chat", tmp_path)(None) == 1.0
    assert spec.load_reader("idle_share.burst", tmp_path)(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such.chat", tmp_path)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")
