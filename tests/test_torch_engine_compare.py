"""The port's engine studies (``engine_compare``, ``disk_tier``) held
against the JAX package's ``benchmarks/engine_compare.py`` and
``benchmarks/disk_tier.py`` on the same numpy inputs.

Request counts are exact; the ro and rw outputs agree within the f32
tolerance of ``tests/test_kernels.py::_tol`` (rtol 2e-4, atol 2e-3); inside
the port the schedules, configs and links never change a value (bitwise).
The JAX package's suites are driven through their own ``_workload`` and
``HostStreamExecutor`` (their ``run`` writes the committed
``results/bench`` files, which these tests leave alone).  Tests marked
``cuda`` skip without a card.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as ref_C
from benchmarks import disk_tier as ref_disk
from benchmarks import engine_compare as ref_engine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.hoststream import HostStreamExecutor as JaxExecutor
from repro.core.hoststream import StreamStats as JaxStreamStats
from repro.core.refspec import AUTO as JAX_AUTO
from repro.core.refspec import PrefetchSpec as JaxPrefetchSpec
from repro_torch.benchmarks import common as C
from repro_torch.benchmarks import disk_tier, engine_compare
from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray
from repro_torch.core.engine import GroupLayout

F32_TOL = dict(rtol=2e-4, atol=2e-3)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(C, "RESULTS_DIR", tmp_path)
    return tmp_path


# ---------------------------------------------------------------------------
# engine_compare
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lung_inputs():
    """The JAX package's lung-NN params and images, as numpy."""
    cfg = ref_C.LungNNConfig(n_pixels=engine_compare.N_PIXELS,
                             batch_images=engine_compare.BATCH_IMAGES)
    params = {k: np.asarray(v) for k, v in ref_C.init_lung_nn(cfg).items()}
    xs, ys = ref_C.make_images(cfg, engine_compare.BATCH_IMAGES)
    return params, (np.asarray(xs), np.asarray(ys))


@pytest.fixture(scope="module")
def jax_engine_runs():
    """Per config on the real link: the JAX package's request counts and
    its ff carry, rw carry and written-back groups."""
    ff_apply, ff_groups, ff_carry, grad_apply, rw_groups = ref_engine._workload()
    spec = JaxPrefetchSpec(buffer_size=6, elements_per_fetch=1, distance=2)
    out = {}
    for name, make_cfg in ref_engine.CONFIGS.items():
        st, st2 = JaxStreamStats(), JaxStreamStats()
        with JaxExecutor(ff_apply, engine_config=make_cfg(None)) as ex:
            ff, _ = ex.run(ff_carry, ff_groups, mode="prefetch", prefetch=spec, stats=st)
        with JaxExecutor(grad_apply, writeback=True, engine_config=make_cfg(None)) as ex:
            rw, groups = ex.run(jnp.zeros(()), rw_groups, mode="prefetch", prefetch=spec,
                                stats=st2)
        out[name] = {"h2d_requests_per_group": st.requests_per_group,
                     "rw_h2d_requests_per_group": st2.requests_per_group,
                     "d2h_requests": st2.d2h_requests,
                     "ff": np.asarray(ff), "rw": np.asarray(rw),
                     "rw_groups": [np.asarray(g) for g in groups]}
    return out


@pytest.fixture(scope="module")
def port_engine_run(lung_inputs, tmp_path_factory):
    params, images = lung_inputs
    mp = pytest.MonkeyPatch()
    mp.setattr(C, "RESULTS_DIR", tmp_path_factory.mktemp("engine"))
    try:
        rows, values = engine_compare.run("cpu", params=params, images=images)
    finally:
        mp.undo()
    return rows, values


def test_workload_groups_match_the_jax_packages(lung_inputs):
    params, images = lung_inputs
    _, ff_groups, ff_carry, _, rw_groups = engine_compare._workload(CPU, params=params,
                                                                    images=images)
    _, jff_groups, jff_carry, _, jrw_groups = ref_engine._workload()
    assert len(ff_groups) == len(jff_groups) == engine_compare.GROUPS
    assert ff_carry.shape == jff_carry.shape
    for g, jg in zip(ff_groups, jff_groups):
        assert np.array_equal(g["x"], jg["x"])
        assert len(g["w"]) == len(jg["w"]) == engine_compare.N_W_PARTS
        assert all(np.array_equal(a, b) for a, b in zip(g["w"], jg["w"]))
    np.testing.assert_allclose(rw_groups[0]["dh"].numpy(), np.asarray(jrw_groups[0]["dh"]),
                               **F32_TOL)


def test_engine_compare_request_counts_are_the_jax_packages(port_engine_run, jax_engine_runs):
    rows, _ = port_engine_run
    by = {(r["link"], r["config"]): r for r in rows}
    for link in ("real", "paper"):
        for name in ("seed", "engine"):
            r, j = by[(link, name)], jax_engine_runs[name]
            assert r["h2d_requests_per_group"] == j["h2d_requests_per_group"]
            assert r["rw_h2d_requests_per_group"] == j["rw_h2d_requests_per_group"]
            assert r["d2h_requests"] == j["d2h_requests"] == engine_compare.GROUPS
        # engine 1; seed 7 = 6 weight parts + x (dh rides by reference)
        assert by[(link, "engine")]["h2d_requests_per_group"] == 1.0
        assert by[(link, "seed")]["h2d_requests_per_group"] == engine_compare.N_W_PARTS + 1


def test_engine_compare_rows_have_the_jax_packages_columns(port_engine_run):
    rows, _ = port_engine_run
    assert [(r["link"], r["config"]) for r in rows] == [
        (link, cfg) for link in ("real", "paper") for cfg in ref_engine.CONFIGS]
    cols = {"link", "config", "ff_s", "rw_s", "total_s", "total_min_s", "h2d_requests_per_group",
            "rw_h2d_requests_per_group", "d2h_requests", "transfer_wait_s", "rw_transfer_wait_s",
            "writeback_drain_s", "wait_hist", "speedup_vs_seed", "speedup_min_vs_seed"}
    assert all(set(r) == cols for r in rows)
    ok, line = engine_compare.gates(rows)
    assert "requests/group: engine 1 vs seed 7" in line


def test_engine_compare_outputs_agree_with_jax(port_engine_run, jax_engine_runs):
    _, values = port_engine_run
    for key, v in values.items():
        j = jax_engine_runs[key[1]]
        np.testing.assert_allclose(v["ff"], j["ff"], **F32_TOL)
        np.testing.assert_allclose(v["rw"], j["rw"], **F32_TOL)
        assert len(v["rw_groups"]) == len(j["rw_groups"])
        for a, b in zip(v["rw_groups"], j["rw_groups"]):
            np.testing.assert_allclose(a, b, **F32_TOL)


def test_engine_compare_schedules_and_links_are_bitwise(port_engine_run):
    _, values = port_engine_run
    first = values[("real", "seed")]
    assert set(values) == {(link, c) for link in ("real", "paper") for c in ("seed", "engine")}
    for v in values.values():
        assert v["ff"].tobytes() == first["ff"].tobytes()
        assert v["rw"].tobytes() == first["rw"].tobytes()
        assert [g.tobytes() for g in v["rw_groups"]] == [g.tobytes() for g in first["rw_groups"]]


def test_pack_link_split_needs_the_card():
    with pytest.raises(RuntimeError, match="needs one"):
        engine_compare.pack_link_split("cpu")


def test_split_groups_sizes():
    """This workload's group (x and six w parts), Fig 4's 6 MB group and
    smollm-360m's embed, layers and tied-head fetch groups of its 160 MB
    plan, which the JAX package's plan sizes the same; over a pass of 34
    groups they move its 818,014,080 B."""
    from repro.configs import get_config as jax_config
    from repro.core.weightstream import WeightStreamPlan as JaxPlan
    from repro.train import steps as jax_steps

    groups = engine_compare.split_groups(CPU)
    layouts = [GroupLayout(g) for _, g, _ in groups]
    assert [n for _, _, n in groups] == [engine_compare.GROUPS, 120, 1, 32, 1]
    assert [lay.n_packed for lay in layouts] == [7, 1, 1, 9, 2]
    assert [lay.payload_bytes for lay in layouts[:2]] == [8 * 225 * 4 + 225 * 96 * 4, 6_000_000]
    assert sum(n * lay.payload_bytes for (_, _, n), lay in zip(groups[2:], layouts[2:])) == \
        818_014_080
    # the bf16 home leaves are the serving path's (BF16HostArray)
    assert all(isinstance(x, BF16HostArray) for _, g, _ in groups[2:] for x in tr.leaves(g))
    cfg = jax_config("smollm-360m")
    jplan = JaxPlan(cfg, jax_steps.abstract_params(cfg),
                    device_budget_mb=engine_compare.SMOLLM_BUDGET_MB)
    jbytes = {g.kind: jplan.group_bytes(g) for g in jplan.groups}
    assert [lay.payload_bytes for lay in layouts[2:]] == [jbytes[k] for k in ("embed", "layers", "head")]
    assert jplan.n_groups == 34


def _chip_smoke_engine_exception() -> dict:
    """``chip_smoke.py``'s ``ENGINE_*`` constants, read without importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {t.id: ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name) and t.id.startswith("ENGINE_")}


def test_chip_smoke_engine_exception_names_an_open_roadmap_item():
    """``chip_smoke.py`` lets one gate fail on the card, the engine's
    paper-link speedup, above a floor of 0.9x, until the ROADMAP item it
    names; that item, still open, names the exception back."""
    c = _chip_smoke_engine_exception()
    assert c == {"ENGINE_GATE_EXCEPTION": "ROADMAP queue 1 item 8", "ENGINE_CARD_FLOOR": 0.9}
    roadmap = (ROOT / "ROADMAP.md").read_text()
    item = roadmap[roadmap.index("- **Item 8:"):]
    item = item[:item.index("\n### ")]
    assert "ENGINE_GATE_EXCEPTION" in item and "chip_smoke.py" in item


# ---------------------------------------------------------------------------
# disk_tier
# ---------------------------------------------------------------------------

DISK_GROUPS = 12  # the suites' smoke size


@pytest.fixture(scope="module")
def jax_disk_runs(tmp_path_factory):
    """The four cases through the JAX package's workload and executor:
    per-tier requests a group and the values."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_disk, "N_GROUPS", DISK_GROUPS)
    try:
        host_groups, disk_groups, apply_ro, apply_rw = ref_disk._workload(
            str(tmp_path_factory.mktemp("jax-disk")))
        cfg = JaxEngineConfig(link=ref_disk.HOST_LINK, disk_link=ref_disk.DISK_LINK)
        out = {}
        for source, groups, dist in (("host", host_groups, 1), ("disk", disk_groups, 1),
                                     ("disk", disk_groups, JAX_AUTO)):
            spec = JaxPrefetchSpec(buffer_size=DISK_GROUPS + 2, distance=dist)
            st = JaxStreamStats()
            with JaxExecutor(apply_ro, engine_config=cfg) as ex:
                c, _ = ex.run(jnp.zeros(()), groups, mode="prefetch", prefetch=spec, stats=st)
            out[("ro", source, str(dist))] = (st.requests_per_group, st.disk_requests_per_group,
                                              np.asarray(c))
        spec = JaxPrefetchSpec(buffer_size=DISK_GROUPS + 2, distance=JAX_AUTO)
        st = JaxStreamStats()
        with JaxExecutor(apply_rw, writeback=True, engine_config=cfg) as ex:
            c, groups = ex.run(jnp.zeros(()), disk_groups, mode="prefetch", prefetch=spec,
                               stats=st)
        out[("rw", "disk", str(JAX_AUTO))] = (
            st.requests_per_group, st.disk_requests_per_group, np.asarray(c),
            [{k: np.asarray(v) for k, v in g.items()} for g in groups])
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def port_disk_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(disk_tier, "N_GROUPS", DISK_GROUPS)
    mp.setattr(disk_tier, "REPEATS", 2)
    mp.setattr(C, "RESULTS_DIR", tmp_path_factory.mktemp("disk"))
    try:
        return disk_tier.run("cpu")
    finally:
        mp.undo()


def test_disk_inputs_are_the_jax_packages(tmp_path):
    host_groups, *_ = ref_disk._workload(str(tmp_path))
    port = disk_tier.host_groups(len(host_groups))
    for a, b in zip(port, host_groups):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_disk_tier_request_counts_are_the_jax_packages(port_disk_run, jax_disk_runs):
    rows, _ = port_disk_run
    assert [(r["schedule"], r["source"], r["distance"]) for r in rows] == list(jax_disk_runs)
    for r in rows:
        h2d, disk, *_ = jax_disk_runs[(r["schedule"], r["source"], r["distance"])]
        assert (r["requests_per_group"], r["disk_requests_per_group"]) == (h2d, disk)
        assert r["requests_per_group"] == 1.0
        assert r["disk_requests_per_group"] == (0.0 if r["source"] == "host" else 1.0)


def test_disk_tier_values_agree_with_jax_and_are_bitwise_across_schedules(
        port_disk_run, jax_disk_runs):
    _, values = port_disk_run
    ro = [values[k] for k in (("host", "1"), ("disk", "1"), ("disk", str(disk_tier.AUTO)))]
    assert all(v.tobytes() == ro[0].tobytes() for v in ro)
    np.testing.assert_allclose(ro[0], jax_disk_runs[("ro", "host", "1")][2], **F32_TOL)
    carry, groups = values[("rw", str(disk_tier.AUTO))]
    *_, jcarry, jgroups = jax_disk_runs[("rw", "disk", str(JAX_AUTO))]
    np.testing.assert_allclose(carry, jcarry, **F32_TOL)
    for g, jg in zip(groups, jgroups, strict=True):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], jg[k], **F32_TOL)


def test_disk_tier_rows_have_the_jax_packages_columns(port_disk_run):
    rows, _ = port_disk_run
    cols = {"schedule", "source", "distance", "total_s", "total_min_s", "requests_per_group",
            "disk_requests_per_group", "per_tier", "stall_breakdown", "tail_wait_s",
            "tail_disk_wait_s", "final_distance", "wait_hist"}
    assert all(set(r) == cols for r in rows)
    ok, line = disk_tier.gates(rows)
    assert "requests/group: h2d 1, disk 1" in line


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_pack_link_split_parts_sum_to_the_staged_transfer(cuda, results):
    rows = engine_compare.pack_link_split(cuda)
    assert len(rows) == 5 and all(r["pack_s"] > 0 and r["link_s"] > 0 for r in rows)
    for r in rows[1:]:  # the groups of 6 MB and more: launch costs are noise there
        assert abs(r["pack_s"] + r["link_s"] - r["whole_s"]) <= 0.2 * r["whole_s"], r


@pytest.mark.cuda
def test_chip_smoke_engine_exception_is_still_needed(cuda, results):
    """While ``chip_smoke.py`` lets the engine's paper-link gate fail on the
    card, the gate fails here too, above the floor.  Once it holds this
    test fails: the exception goes, and this test with it."""
    floor = _chip_smoke_engine_exception()["ENGINE_CARD_FLOOR"]
    rows, _ = engine_compare.run(cuda)
    ok, line = engine_compare.gates(rows)
    eng = next(r for r in rows if (r["link"], r["config"]) == ("paper", "engine"))
    assert "requests/group: engine 1 vs seed 7" in line
    assert max(eng["speedup_vs_seed"], eng["speedup_min_vs_seed"]) > floor, line
    assert not ok, f"the gate holds on the card ({line}): remove chip_smoke.py's exception"
