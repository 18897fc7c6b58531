"""The MoE serving path on the card (marked ``cuda``; skips without one).

Both attention kernels at mixtral-8x7b's shapes (head_dim 128, 4 query heads
a KV head, the 4096 window) against their plain versions at the kernel
tests' bf16 tolerance, and a smoke mixtral served through the kernels with
the experts routed from pinned host and disk: the device-resident run's
tokens, the flash and decode kernels launched.  No JAX here: the CPU tests
hold the port against the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.launch import serve as sv
from repro_torch.models import moe

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shapes, scales, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(s, generator=g, device=device) * c).to(torch.bfloat16)
            for s, c in zip(shapes, scales)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, window", [(2, 512, 4096), (1, 640, 256)])
def test_flash_at_mixtrals_shape_on_card(cuda, b, s, window):
    n, kh, h = 32, 8, 128
    q, k, v = _rand([(b, s, n, h), (b, s, kh, h), (b, s, kh, h)], [0.5, 0.5, 1.0], 1, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t, lens", [(528, [527, 524]), (4096, [4096, 1])])
def test_decode_at_mixtrals_shape_on_card(cuda, t, lens):
    n, kh, h = 32, 8, 128
    q, k, v = _rand([(len(lens), n, h), (len(lens), t, kh, h), (len(lens), t, kh, h)],
                    [0.5, 0.5, 1.0], 2, cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths)
    ref = decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
def test_routed_subset_is_the_full_stack_on_card(cuda):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), n_experts=8)
    p = moe.init_moe(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = _rand([(4, 1, cfg.d_model)], [1.0], 3, cuda)[0]
    top_w, top_i = moe.decode_route(cfg, p, x)
    full = moe.moe_decode(cfg, p, x)
    ids = torch.unique(top_i)
    stack = {n: p[n][ids] for n in ("wi", "wo", "wg")}
    local = torch.searchsorted(ids, top_i.contiguous())
    assert torch.equal(moe.decode_apply(cfg, stack, top_w, local, x), full)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pinned_host", "disk_host"])
def test_routed_serve_through_the_kernels_on_card(cuda, kind):
    # head_dim 64: the CUDA attention kernels take 64, 128 and 256
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), n_experts=8, head_dim=64,
                              attn_impl="pallas")
    kw = dict(batch=2, prompt_len=24, gen=6, kv_page_len=0, seed=3, warmup=False)
    base = sv.serve(cfg, **kw)
    flash0, decode0 = flash_attention.launches, decode_attention.launches
    res = sv.serve(cfg, **kw, param_kind=kind, expert_stream=True, param_cache_mb=0.0)
    assert flash_attention.launches > flash0 and decode_attention.launches > decode0
    np.testing.assert_array_equal(res["generated"], base["generated"])
    es = res["expert_stats"]
    assert es.per_tier()["h2d"]["requests_per_fetched_device_group"] == 1.0
    assert 0 < res["expert_decode_bytes"] < 5 * cfg.n_layers * cfg.n_experts * (
        res["param_plan"].per_expert_bytes)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 6m: MoE training with the experts streamed
# ---------------------------------------------------------------------------

def _phase_6m(device, monkeypatch, flip: bool) -> None:
    """chip_smoke's phase 6m on a smoke mixtral (bf16, 8 experts, 16-token
    sequences); with ``flip``, the pinned-host home's optimizer flips one
    bit of an expert group's master after each step."""
    import chip_smoke as cs
    from repro_torch.core import tree as tr
    from repro_torch.core.arrays import host_tensor
    from repro_torch.train import steps as st

    monkeypatch.setattr(cs, "MT_SEQ", 16)
    if flip:
        real = st.make_weight_streamed_train_step

        def faulty(*args, param_kind="pinned_host", **kw):
            step = real(*args, param_kind=param_kind, **kw)
            if param_kind != "pinned_host":
                return step

            def flipped(state, batch):
                new, metrics = step(state, batch)
                key = next(k for k in new["opt"]["groups"] if "_expert_" in k)
                leaf = host_tensor(tr.leaves(new["opt"]["groups"][key])[0])
                leaf.view(torch.int32).view(-1)[0] ^= 1
                return new, metrics

            for name in ("close", "param_stats", "opt_stats", "engine", "residency"):
                setattr(flipped, name, getattr(step, name))
            return flipped

        monkeypatch.setattr(st, "make_weight_streamed_train_step", faulty)
    full = dataclasses.replace(get_smoke_config("mixtral-8x7b"), n_experts=8)
    cs.phase_moe_train(f"{device}", device=device, full=full)


@pytest.mark.parametrize("flip", [False, True], ids=["clean", "one-bit-flipped"])
def test_phase_6m_bitwise_gate_is_live_on_cpu(monkeypatch, flip):
    """Rehearsed on the CPU: the phase passes, and fails on one flipped bit
    of one expert group's master at the pinned-host home."""
    if flip:
        with pytest.raises(SystemExit, match="differs between the homes"):
            _phase_6m("cpu", monkeypatch, flip)
    else:
        _phase_6m("cpu", monkeypatch, flip)


@pytest.mark.cuda
def test_phase_6m_bitwise_gate_is_live_on_card(cuda, monkeypatch):
    """On the card: phase 6m passes, and its bitwise gate fails on one
    flipped bit of one expert group's master at the pinned-host home."""
    _phase_6m("cuda", monkeypatch, False)
    with pytest.raises(SystemExit, match="differs between the homes"):
        _phase_6m("cuda", monkeypatch, True)
