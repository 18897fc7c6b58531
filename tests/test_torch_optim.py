"""The port's optimizer, schedule and data pipeline held against the JAX
package's.

Both packages get the same numpy inputs from a seed; float results agree
within the reference tests' f32 tolerance (rtol 2e-4 / atol 2e-3), integers
exactly.  The synthetic batches differ by design (threefry against a
``torch.Generator``), so their task is checked, not their tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_schedule as jax_cosine
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_state_from_numpy, tree_to_numpy
from repro_torch.core import tree as tr
from repro_torch.core.spillstore import SpillStore
from repro_torch.data import DiskShardLoader, PrefetchLoader, SyntheticConfig, synthetic_batch
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_schedule

TOL = dict(rtol=2e-4, atol=2e-3)


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"tok": (rng.standard_normal((16, 8)) * scale).astype(np.float32)},
        "blocks": {"w": (rng.standard_normal((2, 8, 4)) * scale).astype(np.float32),
                   "b": (rng.standard_normal((2, 4)) * scale).astype(np.float32)},
        "ln_f": {"scale": np.ones(8, np.float32)},
    }


def _t(tree):
    return tr.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, **tol):
    for a, b in zip(tr.leaves(tree_to_numpy(port)), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup, total, min_ratio", [(10, 100, 0.1), (1, 8, 0.0), (0, 5, 0.5),
                                                      (2, 2, 0.1)])
def test_cosine_schedule_matches_jax(warmup, total, min_ratio):
    kw = dict(peak_lr=3e-3, warmup_steps=warmup, total_steps=total, min_ratio=min_ratio)
    for step in range(0, total + 3):
        ours = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        theirs = jax_cosine(jnp.asarray(step, jnp.int32), **kw)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)


def test_cosine_schedule_shape():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(cosine_schedule(0, **kw)) == 0.0
    assert abs(float(cosine_schedule(10, **kw)) - 1.0) < 1e-6
    assert abs(float(cosine_schedule(100, **kw)) - 0.1) < 1e-6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e6], ids=["clip", "no_clip", "loose_clip"])
@pytest.mark.parametrize("grad_scale", [0.01, 30.0], ids=["small_grads", "large_grads"])
def test_adamw_three_updates_match_jax(clip, grad_scale):
    """Three updates from the same params and gradients: params, master,
    moments, step, grad norm and lr agree (clipping engages on the large
    gradients)."""
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    p0 = _tree(0)
    ours_o = adamw.adamw_init(_t(p0))
    theirs_o = jax_adamw.adamw_init(jax.tree.map(jnp.asarray, p0))
    for i in range(3):
        g = _tree(10 + i, grad_scale)
        ours_p, ours_o, om = adamw.adamw_update(cfg, _t(g), ours_o, compute_dtype=torch.float32)
        theirs_p, theirs_o, tm = jax_adamw.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, g), theirs_o, compute_dtype=jnp.float32)
        _close(ours_p, theirs_p)
        _close(ours_o["leaves"], theirs_o["leaves"])
        assert int(ours_o["step"]) == int(theirs_o["step"]) == i + 1
        np.testing.assert_allclose(float(om["grad_norm"]), float(tm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(om["lr"]), float(tm["lr"]), rtol=1e-6)


def test_adamw_globals_and_leaf_update_match_jax():
    cfg = adamw.AdamWConfig(peak_lr=5e-3, warmup_steps=1, total_steps=6)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    g = _tree(3, 5.0)
    ours = adamw.adamw_globals(cfg, _t(g), torch.tensor(4, dtype=torch.int32))
    theirs = jax_adamw.adamw_globals(jcfg, jax.tree.map(jnp.asarray, g), 4)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(theirs[k]), rtol=1e-6)
    s = {"master": _tree(4)["blocks"]["w"], "m": _tree(5)["blocks"]["w"],
         "v": np.abs(_tree(6)["blocks"]["w"])}
    om, os_ = adamw.adamw_leaf_update(cfg, ours, torch.from_numpy(g["blocks"]["w"]), _t(s))
    tm, ts = jax_adamw.adamw_leaf_update(jcfg, theirs, jnp.asarray(g["blocks"]["w"]),
                                         jax.tree.map(jnp.asarray, s))
    _close([om, os_], [tm, ts])


def test_adamw_globals_from_norm_matches_adamw_globals():
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=8)
    g = _t(_tree(7, 3.0))
    a = adamw.adamw_globals(cfg, g, torch.tensor(3, dtype=torch.int32))
    b = adamw.adamw_globals_from_norm(cfg, adamw.global_norm(g), 3)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_global_norm_and_state_bytes_match_jax():
    g = _tree(8, 2.0)
    np.testing.assert_allclose(float(adamw.global_norm(_t(g))),
                               float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, g))),
                               rtol=1e-6)
    assert adamw.opt_state_bytes(_t(g)) == jax_adamw.opt_state_bytes(g)


def test_adamw_state_layout_matches_jax():
    """Leaf names, shapes, dtypes and order of the state equal the JAX
    package's, and the conversion between them is exact both ways."""
    p = _tree(1)
    theirs = jax.tree.map(np.asarray, jax_adamw.adamw_init(jax.tree.map(jnp.asarray, p)))
    ours = adamw.adamw_init(_t(p))
    ours_np, theirs_leaves = tr.leaves(tree_to_numpy(ours)), jax.tree.leaves(theirs)
    assert [(a.shape, str(a.dtype)) for a in ours_np] == [(b.shape, str(b.dtype))
                                                          for b in theirs_leaves]
    for a, b in zip(ours_np, theirs_leaves):
        np.testing.assert_array_equal(a, b)
    for host in (False, True):
        conv = opt_state_from_numpy(theirs, "cpu", host=host)
        for a, b in zip(tr.leaves(tree_to_numpy(conv)), theirs_leaves):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_adamw_reduces_quadratic_loss():
    w = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw.adamw_init(w)
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = w
    for _ in range(60):
        params, opt, _ = adamw.adamw_update(cfg, {"w": 2 * params["w"]}, opt,
                                            compute_dtype=torch.float32)
    assert float(torch.sum(params["w"] ** 2)) < 0.2


def test_adamw_grad_clip_reports_raw_norm():
    w = {"w": torch.ones(4) * 100}
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0)
    _, _, m = adamw.adamw_update(cfg, {"w": torch.ones(4) * 1e6}, adamw.adamw_init(w))
    assert float(m["grad_norm"]) > 1.0


def test_adamw_refuses_mismatched_state():
    with pytest.raises(ValueError, match="optimizer state leaves"):
        adamw.adamw_update(adamw.AdamWConfig(), {"a": torch.ones(2), "b": torch.ones(2)},
                           adamw.adamw_init({"a": torch.ones(2)}))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_batches_are_a_pure_function_of_seed_and_step():
    cfg = get_smoke_config("smollm-360m")
    sc = SyntheticConfig(cfg.vocab_size, 32, 4, seed=3)
    a, b = synthetic_batch(cfg, sc, 17), synthetic_batch(cfg, sc, 17)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["targets"], b["targets"])
    assert not torch.equal(a["tokens"], synthetic_batch(cfg, sc, 18)["tokens"])
    other_seed = synthetic_batch(cfg, dataclasses.replace(sc, seed=4), 17)
    assert not torch.equal(a["tokens"], other_seed["tokens"])


def test_synthetic_task_matches_jax():
    """The same task as the JAX package's: shapes and dtypes' kinds, tokens in
    [1, v), targets the tokens shifted by one, the period-16 copy pattern
    broken by about 10% noise."""
    cfg, jcfg = get_smoke_config("smollm-360m"), jax_smoke("smollm-360m")
    from repro.data.synthetic import SyntheticConfig as JaxSC
    from repro.data.synthetic import synthetic_batch as jax_batch

    sc = SyntheticConfig(cfg.vocab_size, 256, 16, seed=0)
    ours = synthetic_batch(cfg, sc, 5)
    theirs = jax_batch(jcfg, JaxSC(jcfg.vocab_size, 256, 16, seed=0), 5)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape
    seq = torch.cat([ours["tokens"], ours["targets"][:, -1:]], dim=1)
    assert torch.equal(ours["targets"][:, :-1], ours["tokens"][:, 1:])
    assert int(seq.min()) >= 1 and int(seq.max()) < cfg.vocab_size
    repeats = (seq[:, 16:] == seq[:, :-16]).float().mean().item()
    jseq = np.concatenate([theirs["tokens"], theirs["targets"][:, -1:]], axis=1)
    jrepeats = float((jseq[:, 16:] == jseq[:, :-16]).mean())
    assert abs(repeats - 0.81) < 0.03 and abs(jrepeats - 0.81) < 0.03  # (0.9)^2 kept


def test_prefetch_loader_order_and_restart():
    cfg = get_smoke_config("smollm-360m")
    sc = SyntheticConfig(cfg.vocab_size, 16, 2, seed=0)
    made = []

    def make(s):
        made.append(s)
        return synthetic_batch(cfg, sc, s)

    loader = PrefetchLoader(make, device="cpu", distance=2)
    b3 = loader(3)
    assert made == [3, 4, 5]
    loader(4)
    assert made == [3, 4, 5, 6]
    b3r = PrefetchLoader(make, device="cpu", distance=2)(3)  # restart back at step 3
    assert torch.equal(b3["tokens"], b3r["tokens"])
    assert torch.equal(loader(1)["tokens"], synthetic_batch(cfg, sc, 1)["tokens"])  # rewind


def test_prefetch_loader_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(lambda s: {"x": np.zeros(2)})


def test_disk_shard_loader_streams_spilled_batches(tmp_path):
    cfg = get_smoke_config("smollm-360m")
    sc = SyntheticConfig(cfg.vocab_size, 16, 2, seed=1)
    with SpillStore(tmp_path / "shards") as store:
        disk = DiskShardLoader.write_shards(store, lambda s: synthetic_batch(cfg, sc, s), 3)
        loader = PrefetchLoader(disk, device="cpu", distance=1)
        for step in (0, 1, 2, 3, 4):
            got = loader(step)
            want = synthetic_batch(cfg, sc, step % 3)
            assert torch.equal(got["tokens"], want["tokens"])
            assert torch.equal(got["targets"], want["targets"])
        assert len(list(store.keys())) == 3
    with pytest.raises(ValueError):
        DiskShardLoader(None, 0)


def test_host_opt_state_matches_jax():
    """The streamed optimizer's numpy home: the JAX package's leaf for leaf."""
    from repro_torch.train import steps as st

    p = _tree(2)
    ours = st.host_opt_state(_t(p))
    theirs = jax_steps.host_opt_state(jax.tree.map(jnp.asarray, p))
    assert all(isinstance(x, np.ndarray) for x in tr.leaves(ours))
    for a, b in zip(tr.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
