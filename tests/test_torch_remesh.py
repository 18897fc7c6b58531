"""The 2 <-> 1-rank re-mesh of a streamed-weight training run (the JAX
package's tests/test_recovery.py: its forced 2 <-> 1-device resumes).

The train launcher runs on two gloo ranks under ``torchrun --standalone``
and on one rank as a plain process, on the CPU.  A run killed and resumed
on another rank count, with another weight grouping, re-derives its mesh
(the model axis degrades where the ranks cannot host it), repartitions its
grouped checkpoint by streaming and replays a loss series bitwise the
resume without a reshard.  The runs are hazard-sanitized
(``REPRO_SANITIZE=1``), as the JAX package's.  Every process group has a
60 s timeout and every subprocess its own.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 240


def _train(ckpt_dir, *, ranks, steps, lpg, model_parallel, hist=None, param_kind="pinned_host",
           extra=()) -> subprocess.Popen:
    """The train CLI on ``ranks`` gloo ranks (torchrun above one), started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_SANITIZE="1",
               OMP_NUM_THREADS="1")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks > 1 else [sys.executable])
    cmd = launch + [
        "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--smoke", "--device", "cpu",
        "--steps", str(steps), "--batch", "2", "--seq", "16", "--checkpoint-dir", str(ckpt_dir),
        "--checkpoint-every", "2", "--model-parallel", str(model_parallel),
        "--param-kind", param_kind, "--param-layers-per-group", str(lpg), *extra]
    if hist is not None:
        cmd += ["--history-out", str(hist)]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _done(*procs) -> list:
    """Wait for ``procs``; each must exit 0.  Returns their stderr."""
    errs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out[-2000:], err[-4000:])
        errs.append(err)
    return errs


def _losses(path) -> dict:
    return {int(h["step"]): h["loss"] for h in json.loads(Path(path).read_text())}


def _mesh_of(ckpt_dir) -> dict:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    return json.loads((steps[-1] / "meta.json").read_text())["extra"]["mesh"]


def test_remesh_2_to_1_rank_resumes_bitwise(tmp_path):
    """A 2-rank disk-homed streamed run (mesh (1, 2), its groups staged at
    the train plan's layouts) killed mid-train and recovered, then resumed
    on one rank (the model axis degrades to 1) with another grouping: the
    reshard replays the loss series of the resume without one, bitwise."""
    ckpt, spill = tmp_path / "ckpt", tmp_path / "spill"
    _done(_train(ckpt, ranks=2, steps=4, lpg=1, model_parallel=2, param_kind="disk_host",
                 extra=("--spill-dir", str(spill), "--fail-at", "2")))
    assert _mesh_of(ckpt) == {"n_devices": 2, "shape": [1, 2], "axes": ["data", "model"]}
    ref_dir = tmp_path / "ckpt-ref"
    shutil.copytree(ckpt, ref_dir)
    # one run at a time: the tests beside these in the suite time themselves
    err_el, = _done(_train(ckpt, ranks=1, steps=8, lpg=2, model_parallel=2,
                           param_kind="disk_host", hist=tmp_path / "el.json",
                           extra=("--spill-dir", str(spill))))
    err_ref, = _done(_train(ref_dir, ranks=1, steps=8, lpg=1, model_parallel=2,
                            param_kind="disk_host", hist=tmp_path / "ref.json",
                            extra=("--spill-dir", str(tmp_path / "spill-ref"))))
    # the reshard rewrites the checkpoint under the new mesh's fingerprint;
    # the resume without one restores across the mesh change and says so
    assert "degraded to 1" in err_el and "re-sharding checkpoint step" in err_el
    assert "elastic re-mesh" in err_ref and "re-sharding" not in err_ref
    got, ref = _losses(tmp_path / "el.json"), _losses(tmp_path / "ref.json")
    assert got and set(got) == set(ref) == set(range(4, 8))
    assert all(got[s] == ref[s] for s in ref), (got, ref)


def test_remesh_1_to_2_rank_resumes_bitwise(tmp_path):
    """The mirror direction: a one-rank run resumed on two ranks (mesh
    (2, 1): each rank its half of the batch) with a re-derived grouping,
    against the two-rank resume without a reshard."""
    ckpt = tmp_path / "ckpt"
    _done(_train(ckpt, ranks=1, steps=4, lpg=2, model_parallel=1))
    assert _mesh_of(ckpt) == {"n_devices": 1, "shape": [1, 1], "axes": ["data", "model"]}
    ref_dir = tmp_path / "ckpt-ref"
    shutil.copytree(ckpt, ref_dir)
    err_el, = _done(_train(ckpt, ranks=2, steps=8, lpg=1, model_parallel=1,
                           hist=tmp_path / "el.json"))
    err_ref, = _done(_train(ref_dir, ranks=2, steps=8, lpg=2, model_parallel=1,
                            hist=tmp_path / "ref.json"))
    assert "re-sharding checkpoint step" in err_el and "elastic re-mesh" in err_ref
    assert _mesh_of(ckpt) == {"n_devices": 2, "shape": [2, 1], "axes": ["data", "model"]}
    got, ref = _losses(tmp_path / "el.json"), _losses(tmp_path / "ref.json")
    assert got and set(got) == set(ref) == set(range(4, 8))
    assert all(got[s] == ref[s] for s in ref), (got, ref)
