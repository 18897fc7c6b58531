"""The port's sharding plan (``parallel/sharding.py``) and meshes
(``launch/mesh.py``), held against the JAX package's on every case of
``tests/test_sharding.py``.

* On a shape-only mesh (the reference test's ``_FakeMesh``): the specs of
  params, optimizer state (ZeRO-1 too), batches and caches, the
  recommended plans, the Sharder's spec trees and the report strings equal
  the reference's leaf for leaf, for all ten configs at full width on the
  16 x 16 and 2 x 16 x 16 meshes.
* In a subprocess, on 256 (and 512) fake ranks: ``distribute_tensor`` of
  the meta leaves gives the local shapes each spec's division says, and a
  dim over ``("pod", "data")`` covers the index ranges JAX's layout gives
  each device (JAX on 512 placeholder CPU devices, in a subprocess of its
  own).
* Under gloo, in two CPU processes: smoke olmo-1b placed per the train
  plan and gathered back bitwise; the Sharder leaves values bitwise.

Every subprocess has its own timeout.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs import input_specs as ref_input_specs
from repro.models import transformer as ref_tf
from repro.parallel import sharding as ref_sh
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config, input_specs
from repro_torch.device import generator
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.parallel import sharding as sh
from repro_torch.train import steps as st

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 240
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    """Shape-only mesh stand-in for rule tests (no devices needed)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _plans(mode="train", mesh="16x16", **kw):
    """(port, reference) plans on the same shape-only mesh."""
    shape = MESHES[mesh]
    pod = "pod" if "pod" in shape else None
    return (sh.ShardingPlan(mesh=_FakeMesh(shape), mode=mode, pod_axis=pod, **kw),
            ref_sh.ShardingPlan(mesh=_FakeMesh(shape), mode=mode, pod_axis=pod, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch: str, smoke: bool = False):
    """(port f32 params on the meta device, reference eval_shape params)."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    ref = (ref_get_smoke_config if smoke else ref_get_config)(arch)
    port = transformer.init_model(cfg, generator(0), "meta").as_dict()
    return port, jax.eval_shape(lambda: ref_tf.init_model(jax.random.PRNGKey(0), ref))


def _flat_ref(tree) -> dict:
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, JP))[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)] = x
    return out


def _flat_port(tree, path=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_port(v, path + (str(k),)))
    else:
        out[path] = tree
    return out


def _same_specs(port_tree, ref_tree) -> int:
    """Equal leaf for leaf (paths and entries); returns the leaf count."""
    got, want = _flat_port(port_tree), _flat_ref(ref_tree)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert isinstance(spec, sh.P), path
        assert tuple(spec) == tuple(want[path]), (path, spec, want[path])
        assert str(spec) == str(want[path])
    return len(got)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [(), ("data",), (None,), ("data", None),
                                   (("pod", "data"), None), (["a", "b"],), (("a",),),
                                   (None, ("a", "b"), "c"), ((),)])
def test_spec_normalises_and_prints_as_jax(parts):
    p, j = sh.P(*parts), JP(*parts)
    assert tuple(p) == tuple(j)
    assert repr(p) == repr(j) and str(p) == str(j)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")

    assert sh.placements(M, sh.P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(M, sh.P(None, "data")) == (Replicate(), Shard(1), Replicate())
    assert sh.placements(M, sh.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="another order"):
        sh.placements(M, sh.P(("data", "pod")))
    with pytest.raises(ValueError, match="two dims"):
        sh.placements(M, sh.P("data", "data"))
    with pytest.raises(ValueError, match="mesh axis 'x'"):
        sh.placements(M, sh.P("x"))


def test_the_plan_fields_and_rules_are_the_jax_packages():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(sh.ShardingPlan) == fields(ref_sh.ShardingPlan)
    assert sh._RULES == ref_sh._RULES
    assert sh._REPLICATED_NAMES == ref_sh._REPLICATED_NAMES
    for mesh in MESHES:
        port, ref = _plans(mesh=mesh)
        mp, mr = sh.make_plan(port.mesh, "serve"), ref_sh.make_plan(ref.mesh, "serve")
        assert (mp.pod_axis, mp.batch_axes, mp.data_size, mp.model_size, mp.batch_size_divisor) \
            == (mr.pod_axis, mr.batch_axes, mr.data_size, mr.model_size, mr.batch_size_divisor)


# ---------------------------------------------------------------------------
# param, optimizer, batch and cache specs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_jax_packages(arch, mode, mesh):
    port_p, ref_p = _params(arch)
    port, ref = _plans(mode, mesh)
    specs = sh.param_specs(port, port_p)
    assert _same_specs(specs, ref_sh.param_specs(ref, ref_p)) > 0
    # divisibility (tests/test_sharding.py::test_param_specs_divisibility)
    flat_p = _flat_port(port_p)
    for path, spec in _flat_port(specs).items():
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            n = int(np.prod([MESHES[mesh][a] for a in axes]))
            assert flat_p[path].shape[dim] % n == 0, (arch, path, spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_plan_knobs_give_the_jax_packages_specs(arch, mesh):
    port_p, ref_p = _params(arch)
    for kw in (dict(pure_dp=True), dict(attn_indivisible="replicate"), dict(fsdp=False),
               dict(mode="serve", serve_expert_fsdp=False)):
        kw = dict(kw)
        port, ref = _plans(kw.pop("mode", "train"), mesh, **kw)
        _same_specs(sh.param_specs(port, port_p), ref_sh.param_specs(ref, ref_p))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_opt_state_specs_equal_the_jax_packages(arch, mesh):
    port_p, ref_p = _params(arch)
    for mode, kw in (("train", {}), ("serve", {}), ("train", dict(fsdp=False)),
                     ("train", dict(fsdp=False, pure_dp=True))):
        port, ref = _plans(mode, mesh, **kw)
        ps, rs = sh.param_specs(port, port_p), ref_sh.param_specs(ref, ref_p)
        _same_specs(sh.opt_state_specs(port, ps), ref_sh.opt_state_specs(ref, rs))
        # ZeRO-1 when fsdp is off and the params are given
        _same_specs(sh.opt_state_specs(port, ps, port_p), ref_sh.opt_state_specs(ref, rs, ref_p))
    # with the weights replicated, ZeRO-1 shards the moments' leading dim
    port, _ = _plans("train", mesh, fsdp=False, pure_dp=True)
    z1 = sh.opt_state_specs(port, sh.param_specs(port, port_p), port_p)
    assert any(s[0] == "data" for p, s in _flat_port(z1["leaves"]).items() if p[-1] == "m")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_specs_equal_the_jax_packages(arch, shape):
    seq, batch, _ = SHAPES[shape]
    port_b = input_specs(get_config(arch), shape)
    ref_b = ref_input_specs(ref_get_config(arch), shape)
    for mesh in MESHES:
        for mode, kw in (("train", {}), ("train", dict(pure_dp=True))):
            port, ref = _plans(mode, mesh, **kw)
            _same_specs(sh.batch_specs(port, port_b, batch), ref_sh.batch_specs(ref, ref_b, batch))
            assert tuple(sh.batch_spec(port)) == tuple(ref_sh.batch_spec(ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_jax_packages(arch, mesh):
    for smoke, (b, s) in ((True, (16, 64)), (True, (3, 40)), (False, (128, 1024))):
        cfg = (get_smoke_config if smoke else get_config)(arch)
        ref = (ref_get_smoke_config if smoke else ref_get_config)(arch)
        port_c = transformer.init_caches(cfg, b, s, device="meta")
        ref_c = jax.eval_shape(lambda: ref_tf.init_caches(ref, b, s))
        port, refp = _plans("serve", mesh)
        _same_specs(sh.cache_specs_tree(port, port_c, b), ref_sh.cache_specs_tree(refp, ref_c, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_recommended_plan_equals_the_jax_packages(arch):
    for mesh in MESHES:
        for mode in ("train", "serve"):
            port = sh.recommended_plan(_FakeMesh(MESHES[mesh]), get_config(arch), mode)
            ref = ref_sh.recommended_plan(_FakeMesh(MESHES[mesh]), ref_get_config(arch), mode)
            keys = [f.name for f in dataclasses.fields(ref) if f.name != "mesh"]
            assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_sharder_spec_trees_equal_the_jax_packages(arch):
    port_p, ref_p = _params(arch)
    for mesh in MESHES:
        for kw in (dict(), dict(global_batch=256, seq_len=4096, seq_shard=True),
                   dict(global_batch=16), dict(global_batch=3, seq_len=100, seq_shard=True)):
            port, ref = _plans("train", mesh)
            a, r = sh.make_sharder(port, port_p, **kw), ref_sh.make_sharder(ref, ref_p, **kw)
            assert tuple(a.act_spec) == tuple(r.act_spec)
            assert a.uniform == r.uniform
            for name in ("block_specs", "fsdp_specs", "full_specs"):
                _same_specs(getattr(a, name), getattr(r, name))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_report_equals_the_jax_packages(arch):
    port_p, ref_p = _params(arch)
    for mesh in MESHES:
        for mode in ("train", "serve"):
            port, ref = _plans(mode, mesh)
            got = sh.sharding_report(port, port_p, sh.param_specs(port, port_p))
            want = ref_sh.sharding_report(ref, ref_p, ref_sh.param_specs(ref, ref_p))
            assert got == want
            total = sh.per_device_bytes(port, port_p, sh.param_specs(port, port_p))
            assert got.startswith(f"per-device param bytes: {total / 2**30:.3f} GiB")


# -- tests/test_sharding.py's own cases, on the port -------------------------


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen3-moe-235b-a22b", "internlm2-20b"])
def test_param_bytes_fit_hbm_train(arch):
    """FSDP plan: params+optimizer state per device must be << 16 GiB."""
    params, _ = st.abstract_train_state(get_config(arch))
    port, _ = _plans()
    total = sh.per_device_bytes(port, params, sh.param_specs(port, params))
    # bf16 params sharded; x7 for f32 master+m+v = optimizer state
    assert total * 7 < 14 * 2 ** 30, f"{arch}: {total*7/2**30:.1f} GiB state"


def test_serve_plan_no_fsdp_on_dense():
    params, _ = _params("internlm2-20b")
    wq_t = sh.param_specs(_plans("train")[0], params)["blocks"]["attn"]["wq"]
    wq_s = sh.param_specs(_plans("serve")[0], params)["blocks"]["attn"]["wq"]
    assert "data" in wq_t
    assert all(a != "data" for a in wq_s if a)


def test_serve_plan_moe_expert_fsdp():
    params, _ = _params("qwen3-moe-235b-a22b")
    wi = sh.param_specs(_plans("serve")[0], params)["blocks"]["moe"]["wi"]
    assert "model" in wi and "data" in wi


def test_cache_specs_decode_seq_sharding():
    caches = transformer.init_caches(get_config("internlm2-20b"), 128, 1024, device="meta")
    k_spec = sh.cache_specs_tree(_plans("serve")[0], caches, 128)["k"]
    assert k_spec[1] == "data" and k_spec[2] == "model", k_spec


def test_cache_specs_kv_head_sharding_when_divisible():
    caches = transformer.init_caches(get_config("olmo-1b"), 128, 1024, device="meta")
    assert sh.cache_specs_tree(_plans("serve")[0], caches, 128)["k"][3] == "model"


def test_batch_specs_nondivisible_replicates():
    batch = {"tokens": torch.empty((1, 128), dtype=torch.int32, device="meta")}
    assert sh.batch_specs(_plans()[0], batch, 1)["tokens"] == sh.P(None, None)


def test_multi_pod_batch_axes():
    plan = _plans(mesh="2x16x16")[0]
    assert plan.batch_axes == ("pod", "data")
    batch = {"tokens": torch.empty((512, 16), dtype=torch.int32, device="meta")}
    assert sh.batch_specs(plan, batch, 512)["tokens"][0] == ("pod", "data")


def test_sharder_is_the_identity_on_plain_tensors():
    cfg = get_smoke_config("olmo-1b")
    params, _ = st.init_train_state(cfg, 0, "cpu")
    plan = sh.make_plan(_FakeMesh({"data": 2, "model": 2}), "train")
    sharder = sh.make_sharder(plan, params, 2, seq_len=16, seq_shard=True)
    layer = {k: {n: v[0] for n, v in sub.items()} for k, sub in params["blocks"].items()}
    assert sharder.block(layer) == layer
    assert sharder.block({"attn": layer["attn"]})["attn"] is not None
    x = torch.ones(2, 16, cfg.d_model)
    assert sharder.acts(x) is x
    assert sharder.grads(params) == params


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_meshes_refuse_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_production_mesh()


def test_production_mesh_refuses_without_a_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("this process holds a group")
    with pytest.raises(RuntimeError, match="256 ranks .* found no process group"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")


def _run(code: str, env: dict = None) -> dict:
    """``code`` in a fresh interpreter; its last stdout line is JSON."""
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **(env or {}))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                         capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_FAKE_MESH_CODE = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import tree as tr
from repro_torch.device import generator
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.parallel import sharding as sh

out = {"archs": {}}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
try:
    make_production_mesh(multi_pod=True, device="cpu")
except RuntimeError as e:
    out["wrong_world"] = str(e)
mesh = make_production_mesh(device="cpu")
out["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
local = make_local_mesh(model=16, device="cpu")
out["local"] = [list(local.mesh_dim_names), list(local.shape)]
try:
    make_local_mesh(model=3, device="cpu")
except ValueError as e:
    out["local_indivisible"] = str(e)
for arch in ARCHS:
    params = transformer.init_model(get_config(arch), generator(0), "meta").as_dict()
    rows = []
    for mode in ("train", "serve"):
        plan = sh.make_plan(mesh, mode)
        specs = sh.param_specs(plan, params)
        placed = sh.distribute_tree(params, mesh, specs)
        for (path, x), s, d in zip(sh._flatten_with_path(params), tr.flatten(
                specs, is_leaf=lambda s: isinstance(s, sh.P))[0], tr.leaves(placed)):
            rows.append(["/".join(path), mode, list(x.shape), list(s),
                         list(d.to_local().shape), list(d.shape)])
        out.setdefault("bytes", {})[arch + "/" + mode] = sh.per_device_bytes(plan, params, specs)
    out["archs"][arch] = rows
dist.destroy_process_group()

# 512 ranks: one leaf over ("pod", "data") x "model"; the local shard of a
# few ranks from an arange (each rank splits its own copy: src_data_rank=None)
shape = (64, 32)
src = torch.arange(64 * 32, dtype=torch.int32).reshape(shape)
spec = sh.P(("pod", "data"), "model")
ranges = {}
for rank in (0, 1, 15, 16, 17, 255, 256, 300, 511):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=512)
    m = make_production_mesh(multi_pod=True, device="cpu")
    loc = distribute_tensor(src, m, sh.placements(m, spec), src_data_rank=None).to_local()
    flat = loc.flatten()
    r0, c0 = divmod(int(flat[0]), 32)
    ranges[rank] = [[r0, r0 + loc.shape[0]], [c0, c0 + loc.shape[1]]]
    dist.destroy_process_group()
out["ranges"] = ranges
print(json.dumps(out))
"""

_JAX_LAYOUT_CODE = r"""
import json, numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.array(jax.devices()).reshape(2, 16, 16)
mesh = Mesh(devs, ("pod", "data", "model"))
idx = NamedSharding(mesh, P(("pod", "data"), "model")).devices_indices_map((64, 32))
by_id = {d.id: [[s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(sl, (64, 32))]
         for d, sl in idx.items()}
flat = [d.id for d in devs.flatten()]
print(json.dumps({r: by_id[flat[r]] for r in (0, 1, 15, 16, 17, 255, 256, 300, 511)}))
"""


@pytest.fixture(scope="module")
def fake_mesh_run():
    return _run(_FAKE_MESH_CODE)


def test_fake_production_meshes(fake_mesh_run):
    assert fake_mesh_run["mesh"] == [["data", "model"], [16, 16]]
    assert fake_mesh_run["local"] == [["data", "model"], [16, 16]]
    assert "512 ranks" in fake_mesh_run["wrong_world"]
    assert "world size 256" in fake_mesh_run["wrong_world"]
    assert "does not divide the world size 256" in fake_mesh_run["local_indivisible"]


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_meta_leaves_take_each_specs_division(fake_mesh_run, arch):
    rows = fake_mesh_run["archs"][arch]
    port_p, _ = _params(arch)
    flat = {"/".join(k): v for k, v in _flat_port(port_p).items()}
    assert len(rows) == 2 * len(flat)
    for path, mode, shape, spec, local, global_ in rows:
        assert shape == global_ == list(flat[path].shape)
        want = list(shape)
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            for a in ([ax] if isinstance(ax, str) else ax):
                want[d] //= MESHES["16x16"][a]
        assert local == want, (arch, path, mode, spec)
    for mode in ("train", "serve"):
        plan = sh.make_plan(_FakeMesh(MESHES["16x16"]), mode)
        assert fake_mesh_run["bytes"][f"{arch}/{mode}"] == sh.per_device_bytes(
            plan, port_p, sh.param_specs(plan, port_p))


def test_pod_data_dim_covers_jax_layouts_index_ranges(fake_mesh_run):
    jax_ranges = _run(_JAX_LAYOUT_CODE,
                      env={"XLA_FLAGS": "--xla_force_host_platform_device_count=512"})
    assert fake_mesh_run["ranges"] == jax_ranges
    # 2 rows a (pod, data) block, pod major; 2 columns a model rank:
    # rank 17 = (pod 0, data 1, model 1), rank 300 = (pod 1, data 2, model 12)
    assert jax_ranges["17"] == [[2, 4], [2, 4]]
    assert jax_ranges["300"] == [[36, 38], [24, 26]]


# ---------------------------------------------------------------------------
# two CPU ranks under gloo
# ---------------------------------------------------------------------------

_GLOO_CODE = r"""
import json, os, socket, sys
import torch, torch.distributed as dist, torch.multiprocessing as mp

def worker(rank, port, model, q):
    try:
        q.put(run(rank, port, model))
    except BaseException:
        import traceback
        q.put(dict(rank=rank, error=traceback.format_exc()))
        raise


def run(rank, port, model):
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree as tr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import steps as st

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    mesh = make_local_mesh(model=model, device="cpu")
    cfg = get_smoke_config("olmo-1b")
    params, _ = st.init_train_state(cfg, 0, "cpu")
    plan = sh.make_plan(mesh, "train")
    specs = sh.param_specs(plan, params)
    placed = sh.distribute_tree(params, mesh, specs)
    flat = list(zip(tr.leaves(params), tr.leaves(placed)))
    sharded = sum(d.to_local().numel() < x.numel() for x, d in flat)
    local_bytes = sum(d.to_local().numel() * d.to_local().element_size() for _, d in flat)
    gathered_ok = all(torch.equal(d.full_tensor().view(torch.int16), x.view(torch.int16))
                      for x, d in flat)
    sharder = sh.make_sharder(plan, placed, 2, seq_len=16)
    # one layer's slice of the stacked blocks, with gradients
    layer = {k: {n: distribute_tensor(params["blocks"][k][n][0].float(), mesh,
                                      sh.placements(mesh, sharder.fsdp_specs[k][n])
                                      ).requires_grad_()
                 for n in sub} for k, sub in params["blocks"].items() if sub}
    blk = sharder.block(layer)
    block_ok = all(torch.equal(blk[k][n].full_tensor(), params["blocks"][k][n][0].float())
                   and tuple(blk[k][n].placements) == sh.placements(mesh, sharder.block_specs[k][n])
                   for k in blk for n in blk[k])
    loss = sum((blk[k][n] * 3.0).sum() for k in blk for n in blk[k])
    loss.backward()
    grads_ok = all(torch.equal(layer[k][n].grad.full_tensor(),
                               torch.full_like(params["blocks"][k][n][0].float(), 3.0))
                   and tuple(layer[k][n].grad.placements) == tuple(layer[k][n].placements)
                   for k in layer for n in layer[k])
    x = distribute_tensor(torch.arange(2 * 16 * cfg.d_model, dtype=torch.float32).reshape(
        2, 16, cfg.d_model), mesh, sh.placements(mesh, sh.P()))
    a = sharder.acts(x)
    acts_ok = torch.equal(a.full_tensor(), x.full_tensor()) and tuple(a.placements) == \
        sh.placements(mesh, sh.P(sharder.act_spec[0], None, None))
    g = sharder.grads({k: v for k, v in placed.items() if k == "blocks"})
    pinned_ok = all(torch.equal(b.full_tensor(), c.full_tensor())
                    for b, c in zip(tr.leaves(g), tr.leaves({"blocks": placed["blocks"]})))
    dist.destroy_process_group()
    return dict(rank=rank, leaves=len(flat), sharded=int(sharded), gathered=bool(gathered_ok),
                local_bytes=local_bytes, report_bytes=sh.per_device_bytes(plan, params, specs),
                block=bool(block_ok), grads=bool(grads_ok), acts=bool(acts_ok),
                pinned=bool(pinned_ok))

if __name__ == "__main__":
    model = int(sys.argv[1])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, model, q)) for r in range(2)]
    for p in procs:
        p.start()
    res = [q.get(timeout=150) for _ in procs]
    errors = [r["error"] for r in res if "error" in r]
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    print(json.dumps(sorted(res, key=lambda r: r["rank"])))
"""


@pytest.mark.parametrize("model", [2, 1], ids=["mesh_1x2", "mesh_2x1"])
def test_two_gloo_ranks_place_gather_and_shard_bitwise(tmp_path, model):
    script = tmp_path / "gloo_ranks.py"
    script.write_text(_GLOO_CODE)
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(model)], cwd=ROOT, env=full_env,
                         capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["gathered"] and r["block"] and r["grads"] and r["acts"] and r["pinned"], r
        assert r["sharded"] > 0  # the 2-way axis really splits leaves
        assert r["local_bytes"] == r["report_bytes"]
