"""The port's paged ServeSession held against the JAX package's.

Both sessions run the f32 smoke config with ``attn_impl="pallas"`` on the
same weights (the JAX package's, converted) and the same prompts: greedy
tokens, ``StreamStats`` counters and the pager's accounting integers must be
equal, and the paged tokens must equal the port's own unpaged run.  Float
compute is compared only through the tokens.
"""
import dataclasses
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import LinkModel as JaxLinkModel
from repro.core.engine import TransferEngine as JaxTransferEngine
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import EngineConfig, LinkModel, TransferEngine
from repro_torch.launch import serve as sv

SEED = 7

COUNTERS = ("n_transfers", "n_groups", "h2d_requests", "d2h_requests", "bytes_h2d", "bytes_d2h",
            "disk_requests", "bytes_disk", "unique_group_fetches", "cache_hits", "cache_misses",
            "shared_hits")
PAGER = ("peak_resident_bytes", "demoted_groups", "shared_skipped_writebacks")


def _cfgs():
    jc = dataclasses.replace(jax_get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    pc = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32", attn_impl="pallas")
    return jc, pc


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh()


@pytest.fixture(scope="module")
def params():
    """The JAX package's serving weights for ``SEED``, as the port's."""
    jc, pc = _cfgs()
    jparams = jax_steps.init_train_state(jax.random.PRNGKey(SEED), jc)[0]
    return params_from_numpy(jax.tree.map(np.asarray, jparams), pc, "cpu")


def _prompts(n, length, seed=0, shared=0):
    p = np.random.default_rng(seed).integers(1, 256, (n, length), dtype=np.int32)
    p[:, :shared] = p[0, :shared]
    return p


def _sessions(mesh, params, **kw):
    """(port session, JAX session) on the same weights and knobs."""
    jc, pc = _cfgs()
    return (sv.ServeSession(pc, params=params, device="cpu", seed=SEED, **kw),
            jax_serve.ServeSession(jc, mesh, seed=SEED, **kw))


def _accounting(s):
    out = {name: getattr(s.stats, name) for name in COUNTERS}
    out.update({name: getattr(s.pager, name) for name in PAGER})
    out.update(total_cache_bytes=s.pager.total_cache_bytes(), stale_drops=s.pager.stream.stale_drops,
               n_steps=s.n_steps, prefill_compiles=s.prefill_compiles(), rejected=s.rejected)
    return out


def _run_both(mesh, params, prompts, gens, **kw):
    """Serve ``prompts`` through both sessions; returns each one's tokens
    by request and accounting."""
    ours, theirs = _sessions(mesh, params, **kw)
    out = []
    for s in (ours, theirs):
        with s:
            rids = [s.submit(p, g) for p, g in zip(prompts, gens)]
            res = s.run()
            out.append(([res[r] for r in rids], _accounting(s)))
    return out


@pytest.mark.parametrize("page_len", [4, 8])
@pytest.mark.parametrize("kv_kind", ["device", "pinned_host", "disk_host"])
def test_paged_session_equals_jax_and_unpaged(mesh, params, kv_kind, page_len):
    jc, pc = _cfgs()
    prompts = _prompts(3, 21, shared=12)
    (ours, acc), (theirs, jacc) = _run_both(mesh, params, prompts, [8, 8, 8], slots=2, max_len=29,
                                            kv_kind=kv_kind, page_len=page_len)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert acc == jacc
    # the port's unpaged run of the first two requests, one per slot
    unpaged = sv.serve_loop(pc, params, prompts[:2], 8, device=torch.device("cpu"))
    np.testing.assert_array_equal(np.stack(ours[:2]), unpaged["generated"])
    if kv_kind == "device":
        assert acc["h2d_requests"] == acc["d2h_requests"] == 0
    else:
        assert acc["h2d_requests"] == acc["n_groups"] > 0  # one request per page group
        assert acc["peak_resident_bytes"] < acc["total_cache_bytes"]
    if kv_kind == "disk_host":
        assert acc["disk_requests"] == acc["n_groups"]


def test_serve_returns_the_jax_keys(mesh):
    jc, pc = _cfgs()
    kw = dict(batch=2, prompt_len=9, gen=4, kv_kind="pinned_host", kv_page_len=4, warmup=False)
    res = sv.serve(pc, seed=SEED, device="cpu", **kw)
    ref = jax_serve.serve(jc, mesh, seed=SEED, **kw)
    assert res.keys() == ref.keys()
    for key in ("expert_stats", "param_plan", "param_residency"):  # device-resident weights
        assert res[key] is None and ref[key] is None
    assert res["param_stats"].h2d_requests == ref["param_stats"].h2d_requests == 0
    assert res["param_step_fetches"] == ref["param_step_fetches"]
    assert res["generated"].shape == ref["generated"].shape == (2, 4)
    assert res["paged"] is ref["paged"] is True


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def test_slot_reuse_and_late_admission(mesh, params):
    """More requests than slots, of different lengths: finished requests
    retire and their slot is reused; each request's tokens equal the JAX
    session's and those of a run of its own."""
    prompts = [np.arange(1, 10, dtype=np.int32), np.arange(3, 16, dtype=np.int32),
               np.arange(5, 12, dtype=np.int32)]
    gens = [6, 3, 5]
    kw = dict(max_len=24, kv_kind="pinned_host", page_len=4)
    (ours, acc), (theirs, jacc) = _run_both(mesh, params, prompts, gens, slots=2, **kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert acc == jacc
    for i in range(3):
        (solo, _), _ = _run_both(mesh, params, prompts[i:i + 1], gens[i:i + 1], slots=1, **kw)
        np.testing.assert_array_equal(solo[0], ours[i])


def _interrupted(s, prompt, other, interrupt):
    """The JAX package's evict/readmit schedule: three steps, evict, one step
    without it, readmit, run to the end."""
    rid = s.submit(prompt, 10)
    s.submit(other, 12)
    s.admit_pending()
    for _ in range(3):
        s.step()
    if interrupt:
        s.evict(rid)
        assert rid not in s.active
        s.step()
        s.readmit(rid)
    while s.pending_work():
        s.step()
    return np.asarray(s.requests[rid].emitted, np.int32)


@pytest.mark.parametrize("kv_kind", ["pinned_host", "disk_host"])
def test_evict_readmit_mid_decode(mesh, params, kv_kind):
    prompt, other = np.arange(1, 14, dtype=np.int32), np.arange(2, 11, dtype=np.int32)
    kw = dict(slots=2, max_len=32, kv_kind=kv_kind, page_len=4, hot_pages=1)
    runs = {}
    for interrupt in (True, False):
        ours, theirs = _sessions(mesh, params, **kw)
        with ours, theirs:
            runs[interrupt] = (_interrupted(ours, prompt, other, interrupt),
                               _interrupted(theirs, prompt, other, interrupt))
            assert _accounting(ours) == _accounting(theirs)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][0], runs[True][1])


def test_readmit_into_a_full_batch_queues(mesh, params):
    """A readmit while every slot is taken queues (ahead of new requests)
    instead of raising, and the request still finishes bitwise as an
    uninterrupted run."""
    _, pc = _cfgs()
    prompt, other = np.arange(1, 14, dtype=np.int32), np.arange(2, 11, dtype=np.int32)

    def run(interrupt):
        with sv.ServeSession(pc, slots=1, max_len=32, kv_kind="pinned_host", page_len=4,
                             hot_pages=1, params=params, device="cpu") as s:
            rid = s.submit(prompt, 10)
            s.admit_pending()
            for _ in range(3):
                s.step()
            if interrupt:
                s.evict(rid)
                late = s.submit(other, 3)
                s.admit_pending()
                assert s.active == {late: 0}
                assert s.readmit(rid) is False  # queued
                assert s.readmit(rid) is False  # idempotent while queued
            while s.pending_work():
                s.step()
            assert len(s.requests[rid].emitted) == 10
            return np.asarray(s.requests[rid].emitted, np.int32)

    np.testing.assert_array_equal(run(True), run(False))


def test_oversize_submit_is_rejected_and_gen1_retires(mesh, params):
    _, pc = _cfgs()
    with sv.ServeSession(pc, slots=1, max_len=16, kv_kind="pinned_host", page_len=4,
                         params=params, device="cpu") as s:
        ok = s.submit(np.arange(1, 9, dtype=np.int32), 4)
        assert s.submit(np.arange(1, 14, dtype=np.int32), 8) is None  # 13 + 8 > 16
        one = s.submit(np.arange(1, 13, dtype=np.int32), 1)  # retires from admission
        assert s.rejected == 1
        out = s.run()
    assert len(out[ok]) == 4 and len(out[one]) == 1


def test_prefill_widths_are_power_of_two_buckets(mesh, params):
    """Eight prompt lengths prefill at two bucket widths, as the JAX
    package's compiles two executables, and the tokens are its tokens."""
    lengths = [9, 11, 13, 14, 17, 21, 26, 30]
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in lengths]
    (ours, acc), (theirs, jacc) = _run_both(mesh, params, prompts, [2] * 8, slots=2, max_len=48,
                                            kv_kind="pinned_host", page_len=4)
    assert acc["prefill_compiles"] == jacc["prefill_compiles"] == 2
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs, err, match", [
    (dict(param_kind="pinned_host", device_budget_mb=0.001), ValueError,
     "consumed by the KV hot window"),
    (dict(param_kind="disk_host", device_budget_mb=0.1), ValueError,
     "cannot hold even a distance-1 weight stream"),
    (dict(param_kind="disk_host", device_budget_mb=1.0, param_cache_mb=5.0), ValueError,
     "param_cache_mb=5.0"),
    (dict(param_kind="pinned_host", expert_stream=True), ValueError, "requires an MoE config"),
    (dict(hot_pages=-1), ValueError, "hot_pages"),
])
def test_failed_constructor_leaks_nothing(params, tmp_path, kwargs, err, match):
    """A refused construction (a budget the hot window or the weight stream
    cannot fit, expert streaming of a dense config, a bad pager knob) raises
    before any engine thread or spill directory exists."""
    _, pc = _cfgs()
    n0, spill = threading.active_count(), tmp_path / "kv"
    with pytest.raises(err, match=match):
        sv.ServeSession(pc, slots=1, max_len=16, kv_kind="disk_host", page_len=4,
                        spill_dir=str(spill), params=params, device="cpu", **kwargs)
    assert threading.active_count() == n0
    assert not spill.exists()


def test_recurrentgemma_is_not_pageable():
    cfg = get_smoke_config("recurrentgemma-2b")
    with pytest.raises(ValueError, match="not pageable"):
        sv.ServeSession(cfg, slots=1, max_len=16, page_len=4, device="cpu")


def test_close_with_inflight_prefetch_and_undrained_demotions(params):
    """close() while page fetches are in flight and demotions undrained shuts
    down cleanly: the workers join, the disk read-ahead window is free, the
    staging pools stay bounded and the ephemeral spill dir is gone."""
    _, pc = _cfgs()
    s = sv.ServeSession(pc, slots=2, max_len=24, kv_kind="disk_host", page_len=4, hot_pages=0,
                        params=params, device="cpu")
    spill_dir = s._store.dir
    rids = [s.submit(np.arange(1, 10 + i, dtype=np.int32), 8) for i in range(2)]
    s.admit_pending()
    for _ in range(2):
        s.step()
    for rid in rids:
        table = s.pager.tables[rid]
        p = s.pager.current_page(table)
        if table.records[p].state == "device":
            s.pager._demote(table, p)
    assert s.pager._pending_demotions
    s.pager.prefetch()
    s.close()
    assert s._engine._worker is None and s._engine._disk_worker is None
    assert s._engine._disk_in_use == 0
    for free in s._engine._staging_free.values():
        assert len(free) <= max(1, s._engine.config.staging_slots)
    assert not os.path.exists(spill_dir)


def test_adaptive_distance_grows_under_a_modeled_link(mesh, params):
    """Under a slow link the per-request window grows past 1, as the JAX
    package's does."""
    _, pc = _cfgs()
    link = dict(request_s=0.2e-3, bandwidth_Bps=88e6)
    with TransferEngine(EngineConfig(link=LinkModel(**link)), device="cpu") as engine:
        res = sv.serve(pc, batch=1, prompt_len=24, gen=10, kv_kind="pinned_host", kv_page_len=4,
                       engine=engine, params=params, device="cpu", warmup=False)
    jc, _ = _cfgs()
    jengine = JaxTransferEngine(JaxEngineConfig(link=JaxLinkModel(**link)))
    try:
        ref = jax_serve.serve(jc, mesh, batch=1, prompt_len=24, gen=10, kv_kind="pinned_host",
                              kv_page_len=4, engine=jengine, seed=SEED, warmup=False)
    finally:
        jengine.close()
    assert res["stats"].distance_trace[-1] > 1 and ref["stats"].distance_trace[-1] > 1


# ---------------------------------------------------------------------------
# the unpaged host round trip
# ---------------------------------------------------------------------------

def test_unpaged_pinned_host_counters_equal_jax(mesh, params):
    jc, pc = _cfgs()
    ref = jax_serve.serve(jc, mesh, batch=2, prompt_len=21, gen=8, kv_kind="pinned_host",
                          kv_page_len=0, seed=SEED)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED + 1), (2, 21), 1,
                                            jc.vocab_size), np.int32)
    res = sv.serve_loop(pc, params, prompts, 8, device=torch.device("cpu"), kv_kind="pinned_host")
    np.testing.assert_array_equal(res["generated"], ref["generated"])
    for name in COUNTERS:
        assert getattr(res["stats"], name) == getattr(ref["stats"], name), name
    assert res["stats"].h2d_requests == 7 * 2  # every step, both leaves
    assert len(res["step_waits"]) == len(ref["step_waits"]) == 7


def test_unpaged_path_has_no_disk_home(params):
    _, pc = _cfgs()
    with pytest.raises(ValueError, match="no disk home"):
        sv.serve(pc, batch=1, prompt_len=4, gen=2, kv_kind="disk_host", kv_page_len=0,
                 params=params, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--kv-kind", "pinned_host"], ["--kv-kind", "disk_host"],
                                   ["--kv-kind", "pinned_host", "--requests", "3",
                                    "--shared-prefix-len", "8", "--no-prefix-sharing"]])
def test_cli_serves_paged_on_cpu(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", "--kv-page-len", "32",
                                      "--batch", "2", "--prompt-len", "12", "--gen", "3", *flags])
    assert sv.main() == 0
    out = capsys.readouterr().out
    assert "served smollm-360m" in out and "paged=True" in out and "residency: peak" in out


def test_cli_loadgen_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--smoke", "--device", "cpu", "--loadgen", "--kv-kind", "pinned_host",
        "--kv-page-len", "8", "--batch", "2", "--prompt-len", "24", "--gen", "8",
        "--lg-phases", "0.5:8", "--lg-prompt-lens", "8,16", "--lg-gen-lens", "2,4",
        "--shared-prefix-len", "8"])
    assert sv.main() == 0
    out = capsys.readouterr().out
    assert "loadgen smollm-360m: offered" in out and "SLO: attainment" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged path through the CUDA attention kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_kind", ["device", "pinned_host", "disk_host"])
def test_paged_serve_through_the_kernels_on_card(cuda, kv_kind):
    """smollm-360m's widths cut to 2 layers, bf16, through the CUDA flash
    and decode kernels: paged tokens bitwise the unpaged run's, one H2D
    request and one page of bytes per fetched page group."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2, attn_impl="pallas")
    params = sv.st.init_params(cfg, 0, cuda)
    kw = dict(batch=3, prompt_len=100, gen=12, seed=0, params=params, device=cuda)
    unpaged = sv.serve(cfg, kv_page_len=0, **kw)
    flash_attention.launches = decode_attention.launches = 0
    res = sv.serve(cfg, kv_kind=kv_kind, kv_page_len=16, **kw)
    assert flash_attention.launches > 0 and decode_attention.launches > 0
    np.testing.assert_array_equal(res["generated"], unpaged["generated"])
    st = res["stats"]
    page_bytes = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    assert st.h2d_requests == st.n_groups and st.bytes_h2d == st.n_groups * page_bytes
    if kv_kind != "device":
        assert st.n_groups > 0 and res["peak_resident_bytes"] < res["total_cache_bytes"]
    assert st.disk_requests == (st.n_groups if kv_kind == "disk_host" else 0)


@pytest.mark.parametrize("flags, item", [(["--expert-stream"], "--expert-stream streams routed"),
                                         (["--verify-schedule"], "--verify-schedule requires"),
                                         (["--model-parallel", "2"],
                                          "model axis 2 does not divide the world size 1")])
def test_cli_names_the_item_a_flag_waits_for(monkeypatch, capsys, flags, item):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device", "cpu", *flags])
    with pytest.raises(SystemExit) as exc:
        sv.main()
    assert exc.value.code == 2 and item in capsys.readouterr().err
