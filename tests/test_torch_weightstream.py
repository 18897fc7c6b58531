"""The port's weight-stream plan held against the JAX package's.

Plans are built from each package's abstract parameters of the same config;
every integer (groups, keys, bytes, peaks, distances, capacities) and every
budget message must be equal.  Homes are compared leaf for leaf, bitwise,
and spilled homes are read across the packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.spillstore import SpillStore as JaxSpillStore
from repro.core.weightstream import WeightStreamPlan as JaxPlan
from repro.core.weightstream import weight_stream_support as jax_support
from repro.train import steps as jax_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import home_from_numpy, params_from_numpy
from repro_torch.core import tree as tr
from repro_torch.core.arrays import BF16HostArray, host_tensor
from repro_torch.core.spillstore import SpillStore, is_disk_leaf
from repro_torch.core.weightstream import (
    PARAM_KINDS,
    WeightStreamPlan,
    merge_expert_slice,
    weight_stream_support,
)
from repro_torch.train import steps as st

ARCHS = ("smollm-360m", "recurrentgemma-2b", "mixtral-8x7b")


def _both(arch, full=False):
    """(port config, JAX config) and their abstract parameters."""
    pc = (get_config if full else get_smoke_config)(arch)
    jc = (jax_get_config if full else jax_get_smoke_config)(arch)
    return pc, jc, st.abstract_params(pc), jax_steps.abstract_params(jc)


def _plans(pc, jc, ap, ja, **kw):
    """Both plans, or both construction errors' messages."""
    out = []
    for cls, c, a in ((WeightStreamPlan, pc, ap), (JaxPlan, jc, ja)):
        try:
            out.append(cls(c, a, **kw))
        except ValueError as e:
            out.append(str(e))
    return out


def _integers(plan, distances=range(6)) -> dict:
    return {
        "groups": [dataclasses.astuple(g) for g in plan.groups],
        "units": [dataclasses.astuple(u) for u in plan.units],
        "grouping": plan.grouping(),
        "fetch": plan.fetch_sequence_bytes(),
        "peaks": [plan.peak_device_bytes(d) for d in distances],
        "cached_peaks": [plan.peak_device_bytes(d, cached_bytes=12345) for d in distances],
        "max_d": [plan.max_distance_for_budget(cap) for cap in (2, 8)],
        "max_d_cached": plan.max_distance_for_budget(cached_bytes=4096),
        "capacity": plan.residency_capacity_bytes(),
        "bytes": (plan.total_param_bytes, plan.per_layer_bytes, plan.embed_bytes,
                  plan.head_home_bytes, plan.head_fetch_bytes, plan.layers_per_group,
                  plan.n_groups, plan.layout, plan.head_reads_embed),
        "spill_keys": [plan.spill_key(g) for g in plan.groups],
    }


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lpg", [None, 1, 2, 3, 4])
def test_plan_integers_equal_jax(arch, lpg):
    pc, jc, ap, ja = _both(arch)
    base = WeightStreamPlan(pc, ap, layers_per_group=1)
    budgets = [None] + [base.peak_device_bytes(d) / 1e6 * f for d in (1, 2) for f in (0.9, 1.0, 1.7)]
    for budget in budgets:
        ours, theirs = _plans(pc, jc, ap, ja, layers_per_group=lpg, device_budget_mb=budget)
        if isinstance(theirs, str):
            assert ours == theirs  # the budget message, word for word
            continue
        assert _integers(ours) == _integers(theirs), (arch, lpg, budget)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("budget", [None, 160, 256, 2400])
def test_full_width_plans_equal_jax(arch, budget):
    pc, jc, ap, ja = _both(arch, full=True)
    ours, theirs = _plans(pc, jc, ap, ja, device_budget_mb=budget)
    if isinstance(theirs, str):
        assert ours == theirs
        return
    assert _integers(ours) == _integers(theirs)


def test_smollm_full_width_numbers():
    """The slice's cell: 818,014,080 bytes a pass; 34 groups at 160 MB with a
    133,703,040-byte distance-1 peak, distance 2 and 6,632,320 bytes of
    cache; 10 groups at 256 MB; 6 groups and an unbounded cache without a
    budget."""
    cfg = get_config("smollm-360m")
    ap = st.abstract_params(cfg)
    p160 = WeightStreamPlan(cfg, ap, device_budget_mb=160)
    assert sum(p160.fetch_sequence_bytes()) == 818_014_080
    assert p160.embed_table_bytes == 94_371_840
    assert p160.n_groups == 34 and p160.groups[0].key == "g000_embed"
    assert p160.groups[-1].key == "g033_head"
    assert p160.peak_device_bytes(1) == 133_703_040
    assert p160.max_distance_for_budget() == 2
    assert p160.residency_capacity_bytes() == 6_632_320
    assert WeightStreamPlan(cfg, ap, device_budget_mb=256).n_groups == 10
    free = WeightStreamPlan(cfg, ap)
    assert free.n_groups == 6 and free.residency_capacity_bytes() is None


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b", "olmo-1b"])
def test_support_reasons_equal_jax(arch):
    for full in (False, True):
        pc = (get_config if full else get_smoke_config)(arch)
        jc = (jax_get_config if full else jax_get_smoke_config)(arch)
        assert dataclasses.astuple(weight_stream_support(pc)) == dataclasses.astuple(jax_support(jc))
    assert PARAM_KINDS == ("device", "pinned_host", "disk_host")


def test_recurrentgemma_streamed_serving_refused_with_the_jax_message():
    from repro_torch.launch import serve as sv

    cfg = get_smoke_config("recurrentgemma-2b")
    reason = jax_support(jax_get_smoke_config("recurrentgemma-2b")).serve_reason
    with pytest.raises(ValueError) as exc:
        sv.serve(cfg, batch=1, prompt_len=4, gen=2, kv_page_len=0, param_kind="pinned_host",
                 device="cpu")
    assert str(exc.value) == f"--param-kind pinned_host: {reason}"


def test_expert_stream_and_shardings_name_their_items():
    """Expert streaming needs a MoE config (the JAX package's message);
    ``merge_expert_slice`` stacks expert groups on a new expert axis;
    per-group shardings map a full-params tree onto the groups (against the
    JAX package's on every config: test_torch_sharded_stream.py)."""
    cfg = get_smoke_config("smollm-360m")
    jc = jax_get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="requires an MoE config") as ours:
        WeightStreamPlan(cfg, st.abstract_params(cfg), expert_stream=True)
    with pytest.raises(ValueError) as theirs:
        JaxPlan(jc, jax_steps.abstract_params(jc), expert_stream=True)
    assert str(ours.value) == str(theirs.value)
    ne = {"attn": {"wq": torch.ones(1, 2)}, "moe": {"router": torch.ones(1, 3)}}
    experts = [{"wi": torch.full((1, 2, 4), float(e))} for e in range(3)]
    merged = merge_expert_slice(ne, experts)
    assert merged["moe"]["wi"].shape == (1, 3, 2, 4) and merged["attn"] is ne["attn"]
    assert [float(merged["moe"]["wi"][0, e, 0, 0]) for e in range(3)] == [0.0, 1.0, 2.0]
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg))
    assert plan.group_shardings(None) is None and plan.home_group_shardings(None) is None
    marks = tr.tree_map(lambda x: tuple(x.shape), st.abstract_params(cfg))
    fetch, home = plan.group_shardings(marks), plan.home_group_shardings(marks)
    assert len(fetch) == len(home) == plan.n_groups
    assert fetch[0] == home[0] == {"embed": marks["embed"]}
    # the tied head's fetch group borrows embed's layout; its home does not
    assert fetch[-1] == {"ln_f": marks["ln_f"], "embed": marks["embed"]}
    assert home[-1] == {"ln_f": marks["ln_f"]}
    assert all(f is marks["blocks"] for f in fetch[1:-1])


def test_tree_bytes_rejects_dtypeless_leaf():
    cfg = get_smoke_config("smollm-360m")
    ap = st.abstract_params(cfg)
    ap["embed"] = {"tok": object()}
    with pytest.raises(TypeError, match="needs a dtype"):
        WeightStreamPlan(cfg, ap)


def _jax_params(jc, seed=3):
    return jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(seed), jc)[0])


def _leaf_bytes(x) -> bytes:
    return host_tensor(x).contiguous().view(torch.uint8).numpy().tobytes()


def _assert_homes_equal(a: dict, b: dict) -> None:
    la, sa = tr.flatten(a["groups"])
    lb, sb = tr.flatten(b["groups"])
    assert sa == sb
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape)
        assert _leaf_bytes(x) == _leaf_bytes(y)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_home_of_converted_params_equals_jax_home(arch, dtype):
    pc = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jc = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    jparams = _jax_params(jc)
    params = params_from_numpy(jparams, pc, "cpu")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=1)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1)
    home = plan.init_home(params)
    jhome = home_from_numpy(jplan.init_home(jparams))
    _assert_homes_equal(home, jhome)
    for leaf in tr.leaves(home["groups"]):
        assert isinstance(leaf, np.ndarray)
        if dtype == "bfloat16":
            assert isinstance(leaf, BF16HostArray)
    # the home is the parameters' values, and assembles back into them
    back = plan.assemble(home)
    for (name, p), x in zip(sorted(params.named_parameters()), _by_name(back)):
        assert _leaf_bytes(p.data) == _leaf_bytes(x), name


def _by_name(tree, prefix=""):
    """Leaves of a nested dict in ``named_parameters`` name order."""
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[f"{pre}{k}"] = v

    walk(tree, prefix)
    return [flat[k] for k in sorted(flat)]


def test_disk_home_reads_across_packages(tmp_path):
    """A ``disk_host`` home spilled by either package is read by the other's
    plan: the same chunk files under the same ``wp/`` keys, the same bytes."""
    pc = get_smoke_config("smollm-360m")
    jc = jax_get_smoke_config("smollm-360m")
    jparams = _jax_params(jc)
    plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=1)
    jplan = JaxPlan(jc, jax_steps.abstract_params(jc), layers_per_group=1)
    home = plan.init_home(params_from_numpy(jparams, pc, "cpu"))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    with SpillStore(ours) as s:
        spilled = plan.spill_home(home, s)
        assert plan.is_spilled(spilled) and not plan.is_spilled(home)
        assert plan.spill_home(spilled, s) is not spilled  # already on disk: not rewritten
    with JaxSpillStore(theirs) as js:
        jplan.spill_home(jplan.init_home(jparams), js)
    chunks = lambda d: {p.name: p.read_bytes() for p in d.iterdir() if p.suffix == ".bin"}
    assert len(chunks(ours)) == plan.n_groups and chunks(ours) == chunks(theirs)
    with SpillStore(theirs) as s:  # the JAX package's chunks, read by the port's plan
        back = {"groups": {g.key: s.get(plan.spill_key(g), template=home["groups"][g.key])
                           for g in plan.groups}}
        assert all(is_disk_leaf(x) for x in tr.leaves(back["groups"]))
        _assert_homes_equal(back, home)
    with JaxSpillStore(ours) as js:  # and the port's, by the JAX package's
        jhome = jplan.init_home(jparams)
        back = {"groups": {g.key: js.get(jplan.spill_key(g), template=jhome["groups"][g.key])
                           for g in jplan.groups}}
        _assert_homes_equal(home, home_from_numpy(jax.tree.map(np.asarray, back)))


def test_fetch_group_tied_head_borrows_the_embed_table():
    from repro_torch.core.residency import ResidencyCache

    pc = get_smoke_config("smollm-360m")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=1)
    home = plan.init_home(st.init_params(pc, 0, "cpu"))
    head = plan.groups[-1]
    fetched = plan.fetch_group(home, head)
    assert sorted(fetched) == ["embed", "ln_f"]
    assert fetched["embed"] is home["groups"]["g000_embed"]["embed"]
    assert plan.cache_home_tree(head, fetched).keys() == {"ln_f"}
    cache = ResidencyCache(None)
    resident = {"embed": {"tok": torch.zeros(3)}}
    cache.put("g000_embed", resident)
    assert plan.fetch_group(home, head, cache)["embed"] is resident["embed"]
    thunks = plan.fetch_thunks_forward(home, cache)
    assert len(thunks) == plan.n_groups and thunks[0]() is resident


def test_device_home_places_every_group():
    pc = get_smoke_config("smollm-360m")
    plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=1)
    home = plan.init_home(st.init_params(pc, 0, "cpu"))
    dev = plan.device_home(home, device="cpu")
    for a, b in zip(tr.leaves(home["groups"]), tr.leaves(dev["groups"])):
        assert isinstance(b, torch.Tensor) and _leaf_bytes(a) == _leaf_bytes(b)
