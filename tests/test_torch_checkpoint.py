"""The port's checkpoint manager: the JAX package's checkpoint tests and kill
points, ported, and checkpoints crossing between the packages.

A checkpoint is one ``.npy`` per leaf under path-encoded names plus
``meta.json``; either package restores the other's bit for bit, bf16
leaves included, and for the same state the two write the same leaf files.
"""
import json
import pathlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.int32), "c": torch.ones(())},
    }


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return np.asarray(x)


def _bits_equal(a, b) -> None:
    la, lb = tr.leaves(a), tr.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.shape == y.shape
        assert np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# the JAX package's checkpoint-manager tests (tests/test_runtime.py), ported
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(3, t, blocking=True)
    step, restored = mgr.restore(_tree())
    assert step == 3
    _bits_equal(t, restored)
    assert all(isinstance(x, np.ndarray) for x in tr.leaves(restored))


def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16 serializes as raw void in npy; restore re-views it through the
    dtype in meta.json: numpy ``uint16`` bits on the host, ``bfloat16`` on a
    device."""
    mgr = CheckpointManager(tmp_path, keep=2)
    t = {"w": torch.linspace(-2, 2, 16).to(torch.bfloat16)}
    mgr.save(1, t, blocking=True)
    assert mgr.load_meta(1)["leaves"] == [{"name": "w", "shape": [16], "dtype": "bfloat16"}]
    _, host = mgr.restore(t)
    assert isinstance(host["w"], BF16HostArray)
    _, dev = mgr.restore(t, device="cpu")
    assert dev["w"].dtype == torch.bfloat16 and torch.equal(dev["w"], t["w"])
    _bits_equal(t, host)


def test_checkpoint_keep_k_prunes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(), blocking=True)
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(7, _tree())
    mgr.wait()
    assert mgr.latest_step() == 7


def test_checkpoint_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=3)

    def boom(*a, **kw):
        raise OSError("injected async write fault")

    monkeypatch.setattr(np, "save", boom)
    mgr.save(2, _tree())
    with pytest.raises(OSError, match="injected async"):
        mgr.wait()
    mgr.wait()  # raised once, then cleared


def test_checkpoint_overwrite_crash_window_keeps_old_copy(tmp_path, monkeypatch):
    """A crash at the commit rename while overwriting a step must not lose
    the previous copy."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(0), blocking=True)
    real_rename = pathlib.Path.rename

    def boom(self, target):
        if self.name.endswith(".tmp"):
            raise OSError("injected crash at commit")
        return real_rename(self, target)

    monkeypatch.setattr(pathlib.Path, "rename", boom)
    with pytest.raises(OSError, match="injected"):
        mgr.save(1, _tree(1), blocking=True)
    monkeypatch.undo()
    step, restored = mgr.restore(_tree())
    assert step == 1
    _bits_equal(restored, _tree(0))
    assert not list(tmp_path.glob("*.old"))  # rolled back, nothing dangling


def test_checkpoint_init_sweeps_stale_tmp_and_recovers_old(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(5), blocking=True)
    (tmp_path / "step_00000007.tmp").mkdir()
    (tmp_path / "step_00000003.old").mkdir()
    mgr2 = CheckpointManager(tmp_path, keep=3)
    assert not (tmp_path / "step_00000007.tmp").exists()
    assert (tmp_path / "step_00000003").exists()  # crash-window recovery
    assert mgr2.all_steps() == [3, 5]


def test_checkpoint_keep_zero_keeps_all_negative_rejected(tmp_path):
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path / "bad", keep=-1)
    mgr = CheckpointManager(tmp_path, keep=0)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [1, 2, 3, 4]


def test_checkpoint_wide_step_numbers_stay_visible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(99_999_999, _tree(1), blocking=True)
    mgr.save(100_000_000, _tree(2), blocking=True)
    assert mgr.all_steps() == [99_999_999, 100_000_000]
    assert mgr.restore(_tree())[0] == 100_000_000


def test_checkpoint_restore_places_on_a_device(tmp_path):
    """The counterpart of the JAX package's elastic restore onto shardings:
    leaves placed on the device asked for, values unchanged."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t, blocking=True)
    _, restored = mgr.restore(_tree(), device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in tr.leaves(restored))
    _bits_equal(t, restored)


def test_checkpoint_extra_meta_save_streamed_and_load_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, _tree(2), blocking=True, extra_meta={"mesh": {"n_devices": 1}})
    assert mgr.load_meta()["extra"] == {"mesh": {"n_devices": 1}}
    w = torch.linspace(0, 1, 6).to(torch.bfloat16)
    mgr.save_streamed(4, iter([("x", np.arange(3, dtype=np.float32)), ("w", w)]),
                      extra_meta={"k": 1})
    meta = mgr.load_meta(4)
    assert meta["treedef"] == "streamed" and meta["extra"] == {"k": 1}
    assert [leaf["dtype"] for leaf in meta["leaves"]] == ["float32", "bfloat16"]
    got = mgr.load_leaf(4, "w", dtype="bfloat16", mmap=True)
    assert isinstance(got, BF16HostArray) and np.array_equal(got, w.view(torch.uint16).numpy())
    _, tree = mgr.restore({"x": 0, "w": 0}, step=4)
    _bits_equal(tree, {"x": np.arange(3, dtype=np.float32), "w": w})


def test_checkpoint_host_leaves_are_snapshotted_by_reference(tmp_path):
    """Host homes (numpy, CPU tensors) are written from the caller's memory,
    device leaves copied at save (the JAX package's contract)."""
    mgr = CheckpointManager(tmp_path)
    home = np.arange(4, dtype=np.float32)
    mgr.save(1, {"h": home}, blocking=True)
    _, back = mgr.restore({"h": 0})
    assert np.array_equal(back["h"], home)


# ---------------------------------------------------------------------------
# the kill points of tests/test_checkpoint_crash.py, ported
# ---------------------------------------------------------------------------


def _ktree(tag: float):
    return {"w": np.full((4, 3), tag, np.float32), "b": np.arange(5, dtype=np.int32) + int(tag)}


def _commit(directory, step, tag, keep=3):
    mgr = CheckpointManager(directory, keep=keep)
    mgr.save(step, _ktree(tag), blocking=True)
    return mgr


def _value(tree) -> float:
    return float(tree["w"][0, 0])


def _make_committed_dir(tmp_path, name, step, tag):
    scratch = tmp_path / f"scratch-{name}"
    _commit(scratch, step, tag)
    return scratch / f"step_{step:08d}"


def test_crash_mid_tmp_write_recovers_previous_step(tmp_path):
    d = tmp_path / "ckpt"
    _commit(d, 0, 1.0)
    tmp = d / "step_00000001.tmp"
    tmp.mkdir()
    (tmp / "w.npy").write_bytes(b"\x93NUMPY partial garbage")
    mgr = CheckpointManager(d)
    assert not tmp.exists()
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 1.0


def test_crash_after_tmp_fully_written_before_commit(tmp_path):
    d = tmp_path / "ckpt"
    _commit(d, 0, 1.0)
    shutil.copytree(_make_committed_dir(tmp_path, "a", 1, 2.0), d / "step_00000001.tmp")
    mgr = CheckpointManager(d)
    assert not (d / "step_00000001.tmp").exists()
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 1.0


def test_crash_after_move_aside_before_commit_recovers_old(tmp_path):
    d = tmp_path / "ckpt"
    _commit(d, 0, 1.0)
    (d / "step_00000000").rename(d / "step_00000000.old")
    shutil.copytree(_make_committed_dir(tmp_path, "b", 0, 2.0), d / "step_00000000.tmp")
    mgr = CheckpointManager(d)
    assert not (d / "step_00000000.tmp").exists()
    assert not (d / "step_00000000.old").exists()
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 1.0


def test_crash_after_commit_before_old_delete_keeps_new(tmp_path):
    d = tmp_path / "ckpt"
    _commit(d, 0, 2.0)
    shutil.copytree(_make_committed_dir(tmp_path, "c", 0, 1.0), d / "step_00000000.old")
    mgr = CheckpointManager(d)
    assert not (d / "step_00000000.old").exists()
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 2.0


def test_crash_before_first_commit_leaves_no_steps(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "step_00000000.tmp").mkdir()
    mgr = CheckpointManager(d)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_ktree(0.0))


def test_failed_leaf_write_keeps_previous_step(tmp_path, monkeypatch):
    d = tmp_path / "ckpt"
    mgr = _commit(d, 0, 1.0)
    real_save = np.save
    calls = {"n": 0}

    def flaky_save(f, arr, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected leaf-write fault")
        return real_save(f, arr, *a, **kw)

    monkeypatch.setattr(np, "save", flaky_save)
    with pytest.raises(RuntimeError, match="injected leaf-write"):
        mgr.save(1, _ktree(2.0), blocking=True)
    monkeypatch.setattr(np, "save", real_save)
    mgr2 = CheckpointManager(d)
    assert not (d / "step_00000001.tmp").exists()
    step, tree = mgr2.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 1.0


def test_failed_commit_rename_rolls_back_old_copy(tmp_path, monkeypatch):
    d = tmp_path / "ckpt"
    mgr = _commit(d, 0, 1.0)
    real_rename = Path.rename

    def flaky_rename(self, target):
        if str(self).endswith(".tmp") and not str(target).endswith(".old"):
            raise OSError("injected commit-rename fault")
        return real_rename(self, target)

    monkeypatch.setattr(Path, "rename", flaky_rename)
    with pytest.raises(OSError, match="injected commit-rename"):
        mgr.save(0, _ktree(2.0), blocking=True)
    monkeypatch.setattr(Path, "rename", real_rename)
    assert not (d / "step_00000000.old").exists()
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 1.0
    mgr.save(0, _ktree(3.0), blocking=True)
    step, tree = mgr.restore(_ktree(0.0))
    assert step == 0 and _value(tree) == 3.0


@pytest.mark.parametrize("kill", ["partial_tmp", "full_tmp", "old_moved_no_commit",
                                  "committed_old_undeleted"])
def test_every_kill_point_always_leaves_a_loadable_step(tmp_path, kill):
    """For each kill point of an overwrite save of step 1 (with a committed
    step 0 behind it), a restart finds a loadable step, and step 0 is never
    the casualty of step 1's crash."""
    d = tmp_path / "ckpt"
    _commit(d, 0, 1.0)
    if kill in ("old_moved_no_commit", "committed_old_undeleted"):
        _commit(d, 1, 2.0)
    if kill == "partial_tmp":
        (d / "step_00000001.tmp").mkdir()
    elif kill == "full_tmp":
        shutil.copytree(_make_committed_dir(tmp_path, "k1", 1, 9.0), d / "step_00000001.tmp")
    elif kill == "old_moved_no_commit":
        (d / "step_00000001").rename(d / "step_00000001.old")
        shutil.copytree(_make_committed_dir(tmp_path, "k2", 1, 9.0), d / "step_00000001.tmp")
    else:
        shutil.copytree(_make_committed_dir(tmp_path, "k3", 1, 8.0), d / "step_00000001.old")
    mgr = CheckpointManager(d)
    assert 0 in mgr.all_steps()
    _, tree = mgr.restore(_ktree(0.0), step=0)
    assert _value(tree) == 1.0
    _, latest = mgr.restore(_ktree(0.0), step=mgr.latest_step())
    assert np.isfinite(_value(latest))
    assert not list(d.glob("*.tmp")) and not list(d.glob("*.old"))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _mixed_state(seed=0):
    """A train-state-like tree: bf16 params, f32 moments, an int32 step."""
    rng = np.random.default_rng(seed)
    f32 = {"embed": {"tok": rng.standard_normal((8, 4)).astype(np.float32)},
           "blocks": {"attn": {"wq": rng.standard_normal((2, 4, 3, 2)).astype(np.float32)}}}
    return {
        "params": jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), f32),
        "opt": {"leaves": jax.tree.map(lambda a: {"master": a, "m": a * 0.5, "v": a * a}, f32),
                "step": np.asarray(3, np.int32)},
    }


def _port_tree(state):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return tr.tree_map(conv, jax.tree.map(np.asarray, state))


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    state = _mixed_state()
    JaxManager(tmp_path).save(3, state, blocking=True)
    step, ours = CheckpointManager(tmp_path).restore(_port_tree(state))
    assert step == 3
    _bits_equal(ours, _port_tree(state))
    assert isinstance(ours["params"]["embed"]["tok"], BF16HostArray)
    _, on_dev = CheckpointManager(tmp_path).restore(_port_tree(state), device="cpu")
    assert on_dev["params"]["embed"]["tok"].dtype == torch.bfloat16
    _bits_equal(on_dev, _port_tree(state))


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    state = _mixed_state(1)
    CheckpointManager(tmp_path).save(5, _port_tree(state), blocking=True)
    step, theirs = JaxManager(tmp_path).restore(jax.eval_shape(lambda: state))
    assert step == 5
    assert theirs["params"]["embed"]["tok"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(state)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
    jnp.asarray(theirs["params"]["embed"]["tok"])  # a valid JAX input


def test_both_packages_write_the_same_leaf_files(tmp_path):
    """The same state gives byte-identical ``.npy`` files and the same leaf
    list in ``meta.json`` (names, shapes, dtypes)."""
    state = _mixed_state(2)
    JaxManager(tmp_path / "jax").save(1, state, blocking=True, extra_meta={"k": 1})
    CheckpointManager(tmp_path / "port").save(1, _port_tree(state), blocking=True,
                                              extra_meta={"k": 1})
    a, b = tmp_path / "jax" / "step_00000001", tmp_path / "port" / "step_00000001"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        if n != "meta.json":
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
    ma, mb = (json.loads((d / "meta.json").read_text()) for d in (a, b))
    assert ma["leaves"] == mb["leaves"] and ma["extra"] == mb["extra"] and ma["step"] == mb["step"]
