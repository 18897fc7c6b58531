"""The port's dry-run (``launch/dryrun.py`` over ``core/lowering.py``)
against the JAX package's, on the JAX package's own integration cells.

The JAX package lowers and compiles on 8 forced host devices, mesh (2, 4)
(``tests/test_dryrun_integration.py``); the port lowers on 8 fake ranks
(``init_process_group("fake", ...)``), mesh (2, 4), on meta tensors.  Both
run in subprocesses, at the same time, because each needs its device
count set before anything else: the smoke configs cut to 2 layers, the
named shapes at full size (train_4k: 256 x 4096; decode_32k: 128 x 32768).

What is held, per device:

* the step kind and the token count;
* ``argument_size_in_bytes`` and ``alias_size_in_bytes``, exactly (the
  parameters' and AdamW state's shards, the int32 batch shard, the
  donated state or caches);
* every cell communicating;
* each layer probe's FLOPs (1 and 2 layers, unrolled, the plain
  attention) at or under XLA's: the port counts the products alone, XLA
  one more per element of every arithmetic op.  Measured (torch 2.13, CPU):
  olmo-1b train_4k 0.882 / 0.867 of XLA's at 1 / 2 layers, olmo-1b
  decode_32k 0.274 / 0.274 (its element-wise work over a 32k context is
  most of XLA's count), so train cells are held at or above 0.75.
  mixtral-8x7b train_4k is the exception, 6.36 / 6.36 of XLA's: under a
  mesh the port runs the MoE dispatch whole on every rank
  (``parallel/local.py::on_full``), where XLA partitions it, so it is held
  between XLA's per-device count and XLA's count times the 8 ranks;
* on the port alone, the probe extrapolation ``probe(1) + (L - 1) x
  (probe(2) - probe(1))`` equal to a 4-layer probe's count, exactly;
* the CLI: a row with ``ok``, ``memory``, ``cost_raw``, ``coll_raw``,
  ``probe`` and ``roofline`` on 256 fake ranks, skipped when cached,
  rewritten with ``--force``, and rendered by ``roofline.report``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600

CELLS = (("olmo-1b", "train_4k"), ("olmo-1b", "decode_32k"), ("mixtral-8x7b", "train_4k"))
#: the JAX package's per-device argument and alias bytes on mesh (2, 4)
#: (``compiled.memory_analysis()``); for olmo-1b train_4k the alias is the
#: parameters and AdamW state, and the rest of the arguments the int32
#: tokens and targets, 128 x 4096 x 4 x 2 = 4,194,304 B
REF_BYTES = {
    "olmo-1b:train_4k": (4_395_012, 200_708),
    "olmo-1b:decode_32k": (268_484_868, 268_435_456),
    "mixtral-8x7b:train_4k": (4_618_116, 423_812),
}

_BODY = r"""
import dataclasses, json
out = {}
for arch, shape in CELLS:
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2)
    c, kind, tokens = dr.lower_cell(cfg, shape, mesh)
    m = c.memory_analysis()
    row = {"kind": kind, "tokens": tokens, "argument": int(m.argument_size_in_bytes),
           "alias": int(m.alias_size_in_bytes),
           "coll": ra.collective_bytes_from_hlo(c.as_text())}
    for p in PROBES:
        cp, _, _ = dr.lower_cell(cfg, shape, mesh, probe_layers=p, donate=False)
        row[f"probe{p}"] = ra.cost_terms(cp)["flops"]
    out[f"{arch}:{shape}"] = row
print("RESULT " + json.dumps(out))
"""

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs import get_smoke_config
from repro.jaxcompat import make_mesh
from repro.launch import dryrun as dr
from repro.roofline import analysis as ra
mesh = make_mesh((2, 4), ("data", "model"))
CELLS, PROBES = %r, (1, 2)
""" % (CELLS,) + _BODY

_PORT = r"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.roofline import analysis as ra
dr.init_fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
CELLS, PROBES = %r, (1, 2)
""" % (CELLS,) + _BODY + r"""
cfg = dataclasses.replace(get_smoke_config("olmo-1b"), n_layers=2)
c, _, _ = dr.lower_cell(cfg, "train_4k", mesh, probe_layers=4, donate=False)
print("PROBE4 " + json.dumps(ra.cost_terms(c)["flops"]))
"""

#: the CLI's cell: full-width smollm-360m decode_32k cut to 2 layers
_CLI_ARGS = ("--arch", "smollm-360m", "--shape", "decode_32k", "--set", "n_layers=2")


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)


def _start(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    tagged = (ln.split(" ", 1) for ln in out.splitlines())
    return {t[0]: json.loads(t[1]) for t in tagged if t[0] in ("RESULT", "PROBE4")}


def _cli_sequence(out: Path) -> list[dict]:
    """The CLI three times (a fresh row, the cached path, ``--force``) and
    the report: each step's return code, output and the file after it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *_CLI_ARGS, "--out", str(out)]
    steps = []
    for extra in ((), (), ("--force",)):
        p = subprocess.run(cmd + list(extra), cwd=ROOT, env=_env(), capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        steps.append({"rc": p.returncode, "out": p.stdout + p.stderr[-3000:],
                      "rows": json.loads(out.read_text()) if out.exists() else None})
    p = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", str(out)], cwd=ROOT,
                       env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    steps.append({"rc": p.returncode, "out": p.stdout + p.stderr[-3000:]})
    return steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' cells and the port's CLI, in parallel processes."""
    import concurrent.futures

    jax, port = _start(_JAX), _start(_PORT)
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(_cli_sequence, out)
        jax, port = _result(jax), _result(port)
        return {"jax": jax["RESULT"], "port": port["RESULT"], "probe4": port["PROBE4"],
                "cli": cli.result()}


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_kind_and_tokens_are_the_jax_packages(runs, cell):
    ours, theirs = runs["port"][cell], runs["jax"][cell]
    assert (ours["kind"], ours["tokens"]) == (theirs["kind"], theirs["tokens"])
    assert ours["kind"] == cell.split(":")[1].split("_")[0]


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_argument_and_alias_bytes_are_the_jax_packages(runs, cell):
    ours, theirs = runs["port"][cell], runs["jax"][cell]
    assert (ours["argument"], ours["alias"]) == (theirs["argument"], theirs["alias"]) \
        == REF_BYTES[cell]


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_every_cell_communicates(runs, cell):
    """A sharded program must communicate (the JAX package's integration
    test's assertion), in both packages."""
    assert any(v > 0 for v in runs["port"][cell]["coll"].values()), runs["port"][cell]
    assert any(v > 0 for v in runs["jax"][cell]["coll"].values())


@pytest.mark.parametrize("probe", [1, 2])
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_probe_flops_against_the_jax_packages(runs, cell, probe):
    ours, theirs = runs["port"][cell][f"probe{probe}"], runs["jax"][cell][f"probe{probe}"]
    assert ours > 0
    if cell.startswith("mixtral"):
        # the MoE dispatch runs whole on every rank: more than XLA's
        # partitioned count, no more than the 8 ranks' work together
        assert theirs <= ours <= 8 * theirs, (ours, theirs)
        return
    assert ours <= theirs, (ours, theirs)
    if cell.endswith("train_4k"):
        assert ours >= 0.75 * theirs, (ours, theirs)


def test_probe_extrapolation_is_the_full_depth_count(runs):
    """olmo-1b's layers are alike: the dry-run's extrapolation from the 1-
    and 2-layer probes to 4 layers is the 4-layer probe's count, exactly."""
    row = runs["port"]["olmo-1b:train_4k"]
    p1, p2, p4 = row["probe1"], row["probe2"], runs["probe4"]
    assert p1 + (4 - 1) * (p2 - p1) == p4


def test_cli_rows_cache_force_and_report(runs):
    first, cached, forced, report = runs["cli"]
    assert first["rc"] == 0, first["out"]
    (row,) = first["rows"]
    assert (row["arch"], row["shape"], row["mesh"], row["ok"]) == (
        "smollm-360m", "decode_32k", "16x16", True)
    assert {"memory", "cost_raw", "coll_raw", "probe", "roofline"} <= set(row)
    assert row["memory"]["argument_size_in_bytes"] > row["memory"]["alias_size_in_bytes"] > 0
    assert row["probe"]["residual_flops"] == 0.0
    assert cached["rc"] == 0 and "[cached] smollm-360m x decode_32k [16x16]" in cached["out"]
    assert cached["rows"] == first["rows"]
    assert forced["rc"] == 0 and "[cached]" not in forced["out"], forced["out"]
    (again,) = forced["rows"]
    assert again["memory"] == row["memory"] and again["cost_raw"] == row["cost_raw"]
    assert report["rc"] == 0, report["out"]
    assert "| smollm-360m | decode_32k | 16x16 | ok |" in report["out"]
    assert "| smollm-360m | decode_32k |" in report["out"].split("§Roofline")[1]
