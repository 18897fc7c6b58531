"""The port's paper tables (Table 1 ``power_model``, Table 2
``transfer_stall``), its ``HwSpec`` and its suite runner, held against the
JAX package's ``benchmarks/`` and ``repro.roofline.hw``.

On the CPU the tables' rows and columns are the JAX package's (its
committed ``results/bench/{table1_power,table2_stall}.json``), the cited
rows its values and the measured row's watts ``"n/a"``.  The runner takes
``--smoke`` and ``--device``, runs the JAX package's suites (``shard`` on two
gloo ranks, its counts the JAX package's) and exits 1 on a failing suite.
Tests marked ``cuda`` skip without a card.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmarks import run as ref_run
from benchmarks import transfer_stall as ref_stall
from repro.roofline import hw as ref_hw
from repro_torch.benchmarks import common as C
from repro_torch.benchmarks import engine_compare, power_model, transfer_stall
from repro_torch.benchmarks import run as bench_run
from repro_torch.core.engine import EngineConfig
from repro_torch.roofline import hw

ROOT = Path(__file__).resolve().parents[1]
REF_RESULTS = ROOT / "results" / "bench"


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(C, "RESULTS_DIR", tmp_path)
    return tmp_path


def _ref_rows(name: str) -> list[dict]:
    return json.loads((REF_RESULTS / f"{name}.json").read_text())


# ---------------------------------------------------------------------------
# HwSpec
# ---------------------------------------------------------------------------


def test_hwspec_fields_and_v5e_are_the_jax_packages():
    def fields(cls):
        return [(f.name, str(f.type)) for f in dataclasses.fields(cls)]

    assert fields(hw.HwSpec) == fields(ref_hw.HwSpec)
    assert dataclasses.asdict(hw.V5E) == dataclasses.asdict(ref_hw.V5E)


def test_h100_spec_is_the_data_sheets():
    assert (hw.H100.peak_flops_bf16, hw.H100.hbm_bw, hw.H100.ici_bw) == (989e12, 3.35e12, 50e9)
    assert hw.H100.hbm_bytes == 80 * 2**30


# ---------------------------------------------------------------------------
# Table 2: stall per transfer
# ---------------------------------------------------------------------------


def test_transfer_stall_rows_and_columns_match_the_jax_packages(results):
    rows = transfer_stall.run("cpu")
    ref = _ref_rows("table2_stall")
    assert [(r["size"], r["mode"]) for r in rows] == [(r["size"], r["mode"]) for r in ref]
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    assert all(0 <= r["min_ms"] <= r["mean_ms"] <= r["max_ms"] for r in rows)
    assert json.loads((results / "table2_stall.json").read_text()) == rows


def test_transfer_stall_measure_keys_and_warmup_match_the_jax_packages():
    port = transfer_stall._measure(1024, prefetch=True, device=torch.device("cpu"), n=8)
    ref = ref_stall._measure(1024, prefetch=True, n=8)
    assert sorted(port) == sorted(ref)
    assert transfer_stall.SIZES == (128, 1024, 8192, 262144, 2 ** 20)
    assert (transfer_stall.N_TRANSFERS, transfer_stall.WARMUP) == (64, 4)


def test_small_transfer_means_line(capsys, results):
    assert transfer_stall.main("cpu") == 0
    out = capsys.readouterr().out
    assert "small-transfer mean stall: on_demand" in out and "pageable" not in out


# ---------------------------------------------------------------------------
# Table 1: throughput / power
# ---------------------------------------------------------------------------


def test_power_model_rows_match_the_jax_packages_on_the_cpu(results):
    rows = power_model.run("cpu")
    ref = _ref_rows("table1_power")
    by = {r["technology"]: r for r in rows}
    # every row of the JAX package's table, under its name and columns
    assert [t for t in by if t in {r["technology"] for r in ref}] == [r["technology"] for r in ref]
    for r in ref:
        assert sorted(by[r["technology"]]) == sorted(r)
    measured = by["container CPU core (measured f32)"]
    assert measured["watts"] == measured["gflops_per_watt"] == "n/a"
    assert isinstance(measured["gflops"], float) and measured["gflops"] > 0
    for r in ref[1:]:  # derived and cited: the JAX package's values
        assert by[r["technology"]] == r
    h100 = by["H100 SXM (peak bf16)"]
    assert h100["gflops"] == 989e3 and h100["watts"] == power_model.H100_BOARD_W
    assert h100["gflops_per_watt"] == pytest.approx(989e3 / 700.0)
    assert json.loads((results / "table1_power.json").read_text()) == rows


def test_power_model_needs_nvidia_smi_on_the_card(monkeypatch):
    def missing(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(power_model.subprocess, "run", missing)
    with pytest.raises(FileNotFoundError):
        power_model.power_field(torch.device("cuda", 0))


def test_power_field_falls_back_to_power_draw(monkeypatch):
    def smi(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 2, stdout='Field "power.draw.instant" is not '
                                           'a valid field to query.\n', stderr="")

    monkeypatch.setattr(power_model.subprocess, "run", smi)
    assert power_model.power_field(torch.device("cuda", 0)) == "power.draw"

    def smi_ok(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 0, stdout="71.23\n", stderr="")

    monkeypatch.setattr(power_model.subprocess, "run", smi_ok)
    assert power_model.power_field(torch.device("cuda", 0)) == "power.draw.instant"


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def test_runner_suites_are_the_jax_packages():
    assert list(bench_run.SUITES) == list(ref_run.SUITES)
    assert bench_run.SMOKE_SUITES == ref_run.SMOKE_SUITES


def _runner(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    """The runner in a subprocess from ``cwd`` (its ``results/torch`` goes there)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


#: the columns of a ``BENCH_shard`` row that count (the JAX package's
#: integers: summed over the port's ranks where they count requests, bytes
#: and devices)
SHARD_COUNTS = ("config", "n_devices", "n_leaves", "requests_per_group",
                "requests_per_device_group", "h2d_requests", "bytes_h2d",
                "bitwise_equal_to_eager_sharded")


def test_runner_shard_on_two_gloo_ranks_counts_the_jax_packages(tmp_path):
    """``run.py shard --device cpu`` re-runs the suite on two gloo ranks and
    exits 0; its rows' counts are those of the JAX package's
    ``benchmarks.shard_stream`` on its forced 2-device mesh, run from
    another directory at the same sizes."""
    (tmp_path / "port").mkdir()
    p = _runner(tmp_path / "port", "shard", "--device", "cpu")
    assert p.returncode == 0 and "[shard] rc=0" in p.stdout, (p.stdout + p.stderr)[-3000:]
    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-m", "benchmarks.shard_stream"], cwd=ref_dir, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    ours = json.loads((tmp_path / "port" / "results" / "torch" / "BENCH_shard.json").read_text())
    theirs = json.loads((ref_dir / "results" / "bench" / "BENCH_shard.json").read_text())
    assert [{k: row[k] for k in SHARD_COUNTS} for row in ours] == [
        {k: row[k] for k in SHARD_COUNTS} for row in theirs]
    assert all(row["wait_collapse_vs_per_leaf"] >= 2.0 for row in ours if row["config"] == "sharded")
    # ``final_distance`` is the AUTO controller's last window, driven by
    # measured waits near its 100 us threshold: both packages' runs end
    # anywhere from 5 to 8 (the controllers' traces are held equal on one
    # injected sequence in test_torch_engine.py).  Each row's window has
    # grown above 1 (the JAX package's disk_tier gate) and stays within
    # the engine's max_distance.
    top = EngineConfig().max_distance
    assert all(1 < row["final_distance"] <= top for row in ours + theirs), (ours, theirs)


def test_runner_smoke_on_the_cpu_exits_0(tmp_path):
    """``--smoke --device cpu`` over every smoke suite exits 0, or 1 with no
    failure but two known wall-clock gates, each of which the JAX package's
    suite also meets only at the margin on a loaded CPU (ROADMAP section 3):
    the engine's paper-link speedup (>= 1.20x; the port's per-leaf schedule
    is the cheaper one, so the port's ratio sits lower) and the disk tier's
    latency hiding.  Their request counts hold either way, so the engine
    fails on its speedup alone; every other suite passes."""
    p = _runner(tmp_path, "--smoke", "--device", "cpu")
    out = (p.stdout + p.stderr)[-3000:]
    assert all(f"[{name}] rc=" in p.stdout for name in bench_run.SMOKE_SUITES), out
    failed = [n for n in bench_run.SMOKE_SUITES if f"[{n}] rc=0" not in p.stdout]
    assert set(failed) <= {"engine", "disk"}, out
    assert p.returncode == (1 if failed else 0), out
    res = tmp_path / "results" / "torch"
    by = {(r["link"], r["config"]): r for r in json.loads((res / "BENCH_engine.json").read_text())}
    assert (by[("real", "engine")]["h2d_requests_per_group"],
            by[("real", "seed")]["h2d_requests_per_group"]) == (1.0, 7.0)
    eng = by[("paper", "engine")]
    speedup = max(eng["speedup_vs_seed"], eng["speedup_min_vs_seed"])
    assert (speedup < engine_compare.SPEEDUP_GATE) == ("engine" in failed), out
    disk = json.loads((res / "BENCH_disk.json").read_text())
    assert [(r["requests_per_group"], r["disk_requests_per_group"]) for r in disk] == [
        (1.0, 0.0), (1.0, 1.0), (1.0, 1.0), (1.0, 1.0)]
    rows = json.loads((res / "BENCH_recovery.json").read_text())
    assert rows[0]["repeats"] == 20  # the smoke REPEATS of the clean-overhead gate
    shard = {r["config"]: r for r in json.loads((res / "BENCH_shard.json").read_text())}
    assert [(shard[c]["requests_per_group"], shard[c]["requests_per_device_group"],
             shard[c]["n_devices"]) for c in ("per_leaf", "sharded")] == [(26.0, 13.0, 2),
                                                                          (2.0, 1.0, 2)]


def test_runner_exits_1_on_a_failing_suite(monkeypatch, tmp_path, capsys):
    (tmp_path / "_failing_suite.py").write_text("def main(device=None):\n    return 1\n")
    (tmp_path / "_passing_suite.py").write_text(
        "SEEN = []\ndef main(device=None):\n    SEEN.append(device)\n    return 0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(bench_run.SUITES, "bad", ("_failing_suite", "fails"))
    monkeypatch.setitem(bench_run.SUITES, "good", ("_passing_suite", "passes"))
    assert bench_run.main(["good", "bad", "--device", "cpu"]) == 1
    assert "FAILED suites: ['bad']" in capsys.readouterr().out
    assert sys.modules["_passing_suite"].SEEN == ["cpu"]
    assert bench_run.main(["good"]) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_pinned_on_demand_beats_pageable_at_1mib(cuda):
    pinned = transfer_stall._measure(2 ** 20, prefetch=False, pinned=True, device=cuda)
    pageable = transfer_stall._measure(2 ** 20, prefetch=False, pinned=False, device=cuda)
    assert pinned["mean_ms"] < pageable["mean_ms"]


@pytest.mark.cuda
def test_power_sampler_samples_a_5_s_loop(cuda):
    a = torch.randn((4096, 4096), device=cuda)
    with power_model.PowerSampler(cuda) as sampler:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 5.0:
            for _ in range(8):
                a @ a
            torch.cuda.synchronize()
        samples = sampler.window(t0, time.perf_counter())
    assert len(samples) >= 20 and all(w > 0 for _, w, _ in samples)
    assert sampler.field in ("power.draw.instant", "power.draw")
    assert sampler._proc.poll() is not None  # the subprocess was stopped
