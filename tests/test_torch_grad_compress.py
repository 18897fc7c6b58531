"""The port's gradient compression (``optim/grad_compress.py``) held
bitwise against the JAX package's on the same numpy inputs.

The codecs run in-process: the int8 payload, its scale, the error state and
the re-quantized payload are compared bit for bit, and the JAX package's
three property tests (``tests/test_runtime.py``) hold for the port's codecs
on the same inputs.  ``pod_allreduce_int8`` runs on two gloo ranks (one
subprocess, ``torch.multiprocessing`` spawn, ``tcp://127.0.0.1:<free
port>``) against the JAX package's ``shard_map`` on a forced 2-device host
mesh (another subprocess) with ``_POD_SCRIPT``'s inputs: two pods whose
gradients differ by four orders of magnitude.  Each subprocess has its own
timeout, and the process group its 60 s one.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.optim import grad_compress as jgc
from repro_torch.optim import grad_compress as gc

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 180


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((32, 24)) * 10.0).astype(np.float32),
            "b": (rng.standard_normal(7) * 1e-3).astype(np.float32),
            "s": np.float32(rng.standard_normal())}


# ---------------------------------------------------------------------------
# the codecs, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_error", [False, True], ids=["no_error", "error_feedback"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_is_the_jax_packages_bitwise(seed, with_error):
    g = _grads(seed)
    err = None
    if with_error:
        rng = np.random.default_rng(100 + seed)
        err = {k: (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32) for k, v in g.items()}
    jq, js, je = jgc.compress_int8(_j(g), None if err is None else _j(err))
    tq, ts, te = gc.compress_int8(_t(g), None if err is None else _t(err))
    for k in g:
        assert tq[k].dtype == torch.int8 and _same_bits(tq[k].numpy(), jq[k]), k
        assert _same_bits(ts[k].numpy(), js[k]), k
        assert _same_bits(te[k].numpy(), je[k]), k
    back_j, back_t = jgc.decompress_int8(jq, js), gc.decompress_int8(tq, ts)
    for k in g:
        assert _same_bits(back_t[k].numpy(), back_j[k]), k


@pytest.mark.parametrize("factor", [1.0, 3.0, 1000.0])
def test_requantize_int8_is_the_jax_packages_bitwise(factor):
    g = _grads(5)
    jq, js, _ = jgc.compress_int8(_j(g))
    tq, ts, _ = gc.compress_int8(_t(g))
    jt = jax.tree.map(lambda s: s * factor, js)
    tt = {k: v * factor for k, v in ts.items()}
    jq2, jextra = jgc.requantize_int8(jq, js, jt)
    tq2, textra = gc.requantize_int8(tq, ts, tt)
    for k in g:
        assert _same_bits(tt[k].numpy(), jt[k]), k
        assert _same_bits(tq2[k].numpy(), jq2[k]), k
        assert _same_bits(textra[k].numpy(), jextra[k]), k


def test_bf16_codec_and_error_state_are_the_jax_packages():
    g = _grads(7)
    jb, tb = jgc.compress_bf16(_j(g)), gc.compress_bf16(_t(g))
    for k in g:
        assert tb[k].dtype == torch.bfloat16
        assert _same_bits(tb[k].view(torch.int16).numpy(),
                          np.asarray(jb[k]).view(np.int16)), k
        back = gc.decompress_bf16(tb)[k]
        assert back.dtype == torch.float32
        assert _same_bits(back.numpy(), jgc.decompress_bf16(jb)[k]), k
    zeros = gc.init_error_state(_t(g))
    for k in g:
        assert zeros[k].dtype == torch.float32 and zeros[k].shape == tuple(np.shape(g[k]))
        assert not zeros[k].any()


# the JAX package's three property tests, on the port's codecs and inputs
# drawn as that package draws them


@settings(max_examples=20, deadline=None)
@given(hst.integers(0, 2 ** 31 - 1))
def test_int8_error_feedback_identity(seed):
    g = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (16,)) * 10.0)}
    q, s, err = gc.compress_int8(_t(g))
    back = gc.decompress_int8(q, s)
    np.testing.assert_allclose((back["w"] + err["w"]).numpy(), g["w"], rtol=1e-5, atol=1e-5)
    jq, js, je = jgc.compress_int8(_j(g))
    assert _same_bits(q["w"].numpy(), jq["w"]) and _same_bits(err["w"].numpy(), je["w"])


def test_bf16_compress_roundtrip_close():
    g = {"w": np.asarray(jnp.linspace(-2, 2, 64))}
    back = gc.decompress_bf16(gc.compress_bf16(_t(g)))
    np.testing.assert_allclose(back["w"].numpy(), g["w"], atol=2e-2)


def test_int8_requantize_identity_and_no_clip():
    g = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(3), (64,)) * 1e-3)}
    q, s, _ = gc.compress_int8(_t(g))
    t = {k: v * 1000.0 for k, v in s.items()}
    q2, extra = gc.requantize_int8(q, s, t)
    lhs = q["w"].numpy().astype(np.float32) * float(s["w"])
    rhs = q2["w"].numpy().astype(np.float32) * float(t["w"]) + extra["w"].numpy()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6, atol=1e-12)
    assert np.abs(q2["w"].numpy().astype(np.int32)).max() <= 127


# ---------------------------------------------------------------------------
# pod_allreduce_int8 over two ranks
# ---------------------------------------------------------------------------

#: ``tests/test_runtime.py::_POD_SCRIPT``'s two pods, and a second leaf
G0 = np.linspace(-1e-3, 1e-3, 32, dtype=np.float32)
G1 = np.linspace(-10.0, 10.0, 32, dtype=np.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    second = [(rng.standard_normal((4, 6)) * s).astype(np.float32) for s in (0.1, 3.0)]
    err = [(rng.standard_normal((4, 6)) * 1e-3).astype(np.float32) for _ in range(2)]
    return {"pods": [{"w": G0, "v": second[0]}, {"w": G1, "v": second[1]}],
            "errors": [{"w": np.zeros(32, np.float32), "v": err[0]},
                       {"w": np.zeros(32, np.float32), "v": err[1]}]}


_JAX_CODE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.jaxcompat import make_mesh
from repro.optim import grad_compress as gc

inp = pickle.load(open(sys.argv[1], "rb"))
mesh = make_mesh((2,), ("pod",))
keys = sorted(inp["pods"][0])
g = {k: jnp.stack([p[k] for p in inp["pods"]]) for k in keys}
e = {k: jnp.stack([p[k] for p in inp["errors"]]) for k in keys}

@partial(shard_map, mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")))
def reduce_fn(g, e):
    out, err = gc.pod_allreduce_int8({k: v[0] for k, v in g.items()}, "pod",
                                     {k: v[0] for k, v in e.items()})
    return ({k: v[None] for k, v in out.items()}, {k: v[None] for k, v in err.items()})

out, err = jax.jit(reduce_fn)(g, e)
pickle.dump({"out": {k: np.asarray(v) for k, v in out.items()},
             "err": {k: np.asarray(v) for k, v in err.items()}}, open(sys.argv[2], "wb"))
"""

_PORT_CODE = r"""
import datetime, pickle, socket, sys, traceback
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp


def worker(rank, port, inp_path, q):
    try:
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.optim import pod_allreduce_int8

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=60))
        inp = pickle.load(open(inp_path, "rb"))
        g = {k: torch.from_numpy(v) for k, v in inp["pods"][rank].items()}
        e = {k: torch.from_numpy(v) for k, v in inp["errors"][rank].items()}
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
        out, err = pod_allreduce_int8(g, "pod", e, mesh)
        # without a mesh: the one-dim mesh over every rank of the group
        out2, err2 = pod_allreduce_int8(g, "pod", e)
        q.put({"rank": rank, "out": {k: v.numpy() for k, v in out.items()},
               "err": {k: v.numpy() for k, v in err.items()},
               "same_without_mesh": all(torch.equal(out[k], out2[k]) and torch.equal(err[k], err2[k])
                                        for k in out)})
        dist.destroy_process_group()
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, sys.argv[1], q)) for r in range(2)]
    for p in procs:
        p.start()
    res = [q.get(timeout=150) for _ in procs]
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
    errors = [r["error"] for r in res if "error" in r]
    assert not errors, "\n".join(errors)
    pickle.dump(sorted(res, key=lambda r: r["rank"]), open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    """``(jax result, [rank 0's, rank 1's])``: both subprocesses at once."""
    d = tmp_path_factory.mktemp("pod_allreduce")
    inp = d / "inputs.pkl"
    inp.write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    (d / "port.py").write_text(_PORT_CODE)
    procs = {
        "jax": subprocess.Popen([sys.executable, "-c", _JAX_CODE, str(inp), str(d / "jax.pkl")],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True),
        "port": subprocess.Popen([sys.executable, str(d / "port.py"), str(inp), str(d / "port.pkl")],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
    }
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name}: {err[-4000:]}"
    return pickle.loads((d / "jax.pkl").read_bytes()), pickle.loads((d / "port.pkl").read_bytes())


@pytest.mark.parametrize("leaf", ["w", "v"])
def test_pod_allreduce_int8_is_the_jax_packages_bitwise(pod_runs, leaf):
    """Each rank's ``out`` and ``err`` are bit for bit the JAX package's for
    its pod, with a mesh passed and without."""
    ref, ranks = pod_runs
    for r in ranks:
        assert r["same_without_mesh"]
        assert _same_bits(r["out"][leaf], ref["out"][leaf][r["rank"]]), r["rank"]
        assert _same_bits(r["err"][leaf], ref["err"][leaf][r["rank"]]), r["rank"]


def test_pod_allreduce_int8_shared_scale_2pods(pod_runs):
    """``_POD_SCRIPT``'s assertions on the port's two ranks: the ranks
    agree, the shared scale bounds the error by one quantum of the larger
    pod, and error feedback closes the loop exactly."""
    _, ranks = pod_runs
    out = np.stack([r["out"]["w"] for r in ranks])
    err = np.stack([r["err"]["w"] for r in ranks])
    true_mean = (G0 + G1) / 2
    pmax = max(np.abs(G0).max(), np.abs(G1).max()) / 127.0
    assert np.array_equal(out[0], out[1]), "allreduce must agree across pods"
    assert np.abs(out[0] - true_mean).max() <= pmax + 1e-6
    c0, c1 = G0 - err[0], G1 - err[1]
    np.testing.assert_allclose((c0 + c1) / 2, out[0], rtol=1e-5, atol=1e-7)
