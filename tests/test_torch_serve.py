"""The port's serving slice held against the JAX package's, plus its guards.

The JAX ``serve(..., kv_kind="device", kv_page_len=0)`` — the baseline
every serving placement must match — runs on the f32 smoke config with
``attn_impl="pallas"``; its weights and prompts are fed to the port's serve
loop on the CPU, and the greedy tokens must be equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.hoststream import StreamStats as JaxStreamStats
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.hoststream import StreamStats
from repro_torch.launch import serve as sv

BATCH, PROMPT, GEN, SEED = 2, 21, 8, 7


def _cfgs():
    jc = dataclasses.replace(jax_get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    pc = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    return jc, pc


@pytest.fixture(scope="module")
def jax_reference():
    jc, _ = _cfgs()
    return jax_serve.serve(jc, make_local_mesh(), batch=BATCH, prompt_len=PROMPT, gen=GEN,
                           kv_kind="device", kv_page_len=0, seed=SEED)


def test_greedy_tokens_equal_jax_serve(jax_reference):
    jc, pc = _cfgs()
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")
    # the prompts the JAX serve drew (repro/launch/serve.py:_serve_unpaged)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (BATCH, PROMPT), 1,
                                            jc.vocab_size), np.int32)
    res = sv.serve_loop(pc, params, prompts, GEN, device=torch.device("cpu"))
    assert res["generated"].dtype == np.int32
    np.testing.assert_array_equal(res["generated"], jax_reference["generated"])
    assert res["n_steps"] == jax_reference["n_steps"] == GEN - 1
    assert res["paged"] is jax_reference["paged"] is False


def test_serve_returns_the_jax_keys(jax_reference):
    _, pc = _cfgs()
    res = sv.serve(pc, batch=BATCH, prompt_len=PROMPT, gen=GEN, kv_page_len=0, seed=SEED,
                   device="cpu")
    keys = {"prefill_s", "decode_s", "tokens_per_s", "generated", "stats", "paged", "n_steps"}
    assert keys <= res.keys() and keys <= jax_reference.keys()
    assert res["generated"].shape == (BATCH, GEN)
    assert ((res["generated"] >= 0) & (res["generated"] < pc.vocab_size)).all()
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    assert isinstance(res["stats"], StreamStats) and res["stats"].h2d_requests == 0


def test_serve_is_seeded():
    _, pc = _cfgs()
    run = lambda seed: sv.serve(pc, batch=2, prompt_len=6, gen=4, kv_page_len=0, seed=seed,
                                device="cpu", warmup=False)["generated"]
    np.testing.assert_array_equal(run(3), run(3))


def test_stream_stats_fields_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(StreamStats) == names(JaxStreamStats)
    assert StreamStats().requests_per_group == JaxStreamStats().requests_per_group == 0.0


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.serve(pc, batch=1, prompt_len=4, gen=2, kv_page_len=0)


@pytest.mark.parametrize("kwargs", [dict(kv_page_len=32), dict(kv_page_len=0, kv_kind="pinned_host"),
                                    dict(kv_page_len=0, param_kind="disk_host")])
def test_unported_serve_options_raise(kwargs):
    _, pc = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sv.serve(pc, batch=1, prompt_len=4, gen=2, device="cpu", **kwargs)


@pytest.mark.parametrize("flags", [[], ["--kv-page-len", "0", "--loadgen"],
                                   ["--kv-page-len", "0", "--model-parallel", "2"],
                                   ["--kv-page-len", "0", "--param-kind", "pinned_host"],
                                   ["--kv-page-len", "0", "--kv-kind", "disk_host"]])
def test_cli_exits_on_unported_flags(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", *flags])
    with pytest.raises(SystemExit) as exc:
        sv.main()
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_cli_serves_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", "--kv-page-len", "0",
                                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert sv.main() == 0
    assert "served smollm-360m" in capsys.readouterr().out
