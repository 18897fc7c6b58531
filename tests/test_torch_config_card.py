"""The served configs that run on the card at full width (``chip_smoke.py``
phases 2q and 2d): qwen3-moe-235b-a22b with its experts routed, then
olmo-1b, minitron-4b and internlm2-20b.

Both attention kernels at qwen3-moe-235b-a22b's 64 query heads over 4 KV
heads (16 a KV head, the top of both kernels' contracts) and at
internlm2-20b's 48 over 8, head_dim 128, against their plain versions at
the kernel tests' bf16 tolerance (marked ``cuda``; they skip without a
card).  Then both phases rehearsed on the CPU at smoke size, where the
kernel wrappers take their plain versions: the phases' gates run, and a
routed stream that fetches more experts than its fan-in fails them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

BF16_TOL = dict(rtol=2e-2, atol=2e-2)

#: (query heads, KV heads) at head_dim 128: qwen3-moe-235b-a22b, internlm2-20b
HEADS = [(64, 4), (48, 8)]


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
@pytest.mark.parametrize("n, kh", HEADS)
@pytest.mark.parametrize("b, s, q_offset", [(2, 512, 0), (1, 300, 20)])
def test_flash_at_the_served_heads_on_card(cuda, n, kh, b, s, q_offset):
    h = 128
    q, k, v = _rand([(b, s, n, h), (b, s, kh, h), (b, s, kh, h)], [0.5, 0.5, 1.0], 1, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, q_offset=q_offset)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, q_offset=q_offset)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n, kh", HEADS)
@pytest.mark.parametrize("t, lens", [(520, [520, 517]), (520, [1, 0]), (544, [544, 543, 300, 1])])
def test_decode_at_the_served_heads_on_card(cuda, n, kh, t, lens):
    h = 128
    q, k, v = _rand([(len(lens), n, h), (len(lens), t, kh, h), (len(lens), t, kh, h)],
                    [0.5, 0.5, 1.0], 2, cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, lengths)
    assert decode_attention.launches == before + 2
    ref = decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 2q and 2d, rehearsed at smoke size
# ---------------------------------------------------------------------------


def _qwen3_smoke():
    """qwen3-moe's smoke config with 16 query heads over 1 KV head (2q's
    grouping) and 32 experts, so that a routed decode step's fan-in (top-2
    x batch 2) is 0.125 of a layer's experts, as top-8 x 2 of 128 is."""
    return dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), n_heads=16,
                               n_kv_heads=1, n_experts=32)


def _phase_2q(monkeypatch, device):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "MOE_PROMPT", 32)
    monkeypatch.setattr(cs, "Q_BUDGET_ROUND", 10_000)  # the smoke plan's floor is ~2.6 MB
    return cs.phase_qwen3(device, device=device, full=_qwen3_smoke())


def test_phase_2q_rehearsed_on_cpu(monkeypatch, capsys):
    """Phase 2q at smoke size: (a) and the logit check, the schedule
    verified, (b)'s tokens bitwise (a)'s, every request and byte the plan's
    and the routing's, at most the fan-in's experts a layer a step."""
    _phase_2q(monkeypatch, "cpu")
    out = capsys.readouterr().out
    assert "OK: occupancy, hazards, pins verified" in out
    assert "2q (b) expert bytes a layer a decode step" in out


def test_phase_2q_expert_gate_is_live_on_cpu(monkeypatch):
    """A routed decode loop that reads twice its experts' bytes (what all
    of the fan-in's experts fetched twice would read) fails 2q's bound of
    16 experts, 0.125 of a layer's, a step."""
    from repro_torch.launch import serve as sv

    real = sv.serve

    def doubled(*args, **kw):
        res = real(*args, **kw)
        if res.get("expert_stats") is not None:
            res["expert_decode_bytes"] *= 2
        return res

    monkeypatch.setattr(sv, "serve", doubled)
    with pytest.raises(SystemExit, match="expert B a layer a decode step, above 4 experts"):
        _phase_2q(monkeypatch, "cpu")


def test_phase_2d_rehearsed_on_cpu(monkeypatch, capsys):
    """Phase 2d at smoke size: each dense config built group by group,
    served, its tokens checked and its logits held at 2 layers."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "PROMPT", 24)
    monkeypatch.setattr(cs, "GEN", 6)
    fulls = [get_smoke_config(a) for a in cs.DENSE_ARCHS]
    launches = cs.phase_dense("cpu", device="cpu", fulls=fulls)
    assert set(launches) == set(cs.DENSE_ARCHS)
    out = capsys.readouterr().out
    for a in cs.DENSE_ARCHS:
        assert f"phase 3d {a} output checks ({a}, {cs.DENSE_CHECK_LAYERS} layers)" in out


def test_phase_1_covers_the_served_groupings():
    """Phase 1's cases reach G 16, 6, 3 and 1 at head_dim 128 in both
    kernels, from the configs' own head counts."""
    import chip_smoke as cs
    from repro_torch.configs import get_config

    groups = {get_config(a).n_heads // get_config(a).n_kv_heads
              for a in (cs.Q_ARCH,) + cs.DENSE_ARCHS}
    assert groups == {16, 6, 3, 1}
    assert all(get_config(a).head_dim == 128 for a in (cs.Q_ARCH,) + cs.DENSE_ARCHS)
