"""The benchmark's own counts against hand-worked shapes."""
from h100bench.harness import counts, spec


def _config(name):
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


def test_mixtral_expert_group_and_plan_bytes():
    c = _config("mixtral-8x7b")
    assert counts.expert_group_bytes(c) == 3 * 4096 * 14336 * 2 == 352_321_536
    # 4 layers of (attention 41,943,040 + 8 experts 1,409,286,144 + router
    # 32,768 + norms 8,192) + embedding + head + final norm, bf16
    per_layer = 41_943_040 + 1_409_286_144 + 32_768 + 8_192
    assert counts.model_bytes(c) == (4 * per_layer + 2 * 131_072_000 + 4096) * 2
    assert counts.model_bytes(c) == 12_134_457_344


def test_internlm2_kv_bytes_per_position():
    c = _config("internlm2-20b")
    assert counts.kv_bytes_per_position(c) == 48 * 2 * 8 * 128 * 2 == 196_608
    # 32 slots of 2,176 positions: the cell's cache, 13.7 GB
    assert 32 * 2176 * counts.kv_bytes_per_position(c) == 13_690_208_256


def test_flash_counts_q_k_v_o_once_without_scores():
    c = _config("internlm2-20b")
    flops, nbytes = counts.flash_call(c, 512)
    # QK and PV over the causal triangle: 4 * N * H * S (S + 1) / 2
    assert flops == 4 * 48 * 128 * 512 * 513 / 2
    # Q and O at 48 heads, K and V at 8, bf16: no (S, S) term
    assert nbytes == 512 * (48 + 48 + 8 + 8) * 128 * 2
    assert counts.flash_call(c, 1024)[1] == 2 * nbytes  # linear in S


def test_decode_attention_counts_the_context_read_once():
    c = _config("mixtral-8x7b")
    flops, nbytes = counts.decode_attn_call(c, [100, 300])
    assert flops == 4 * 32 * 128 * 400
    assert nbytes == 400 * 2 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2


def test_routed_moe_bytes_are_the_routed_experts_only():
    c = _config("mixtral-8x7b")
    # 4 layers with 5, 6, 5, 6 distinct experts routed: 22 groups
    assert counts.routed_expert_bytes(c, 22) == 22 * 352_321_536
    assert counts.routed_expert_bytes(c, 22) < 4 * 8 * 352_321_536


def test_model_flops_use_the_active_experts():
    c = _config("mixtral-8x7b")
    active = 41_943_040 + 2 * 176_160_768 + 32_768
    assert counts.active_matmul_params(c) == active
    assert counts.decode_token_flops(c, 10) == 4 * (2 * active + 4 * 32 * 128 * 10) + 2 * 4096 * 32000
    assert counts.prefill_flops(c, 2) == 4 * (2 * active * 2 + 4 * 32 * 128 * 3) + 2 * 4096 * 32000


def test_least_time_takes_the_larger_bound():
    assert counts.least_time(989e12, 0) == 1.0
    assert counts.least_time(0, 3.35e12) == 1.0
    assert counts.least_time(989e9, 3.35e12) == 1.0
