"""Operations and bytes that the work needs, from the configuration's sizes.

The benchmark's own counts (the port's ``roofline/analysis.py`` is the idea,
two of whose counts are corrected here):

- a flash prefill reads Q, K and V once and writes O once; the (S, S)
  scores never reach memory and are not counted;
- a routed MoE decode step reads the experts that its tokens route to, not
  every expert.

Model FLOPs count the matrix products of the weights a token uses (its
routed experts only) and attention's two products over the context it
attends to; the embedding lookup is not an operation.  Bytes are bf16.
"""
from __future__ import annotations

from .weights import dims

BF16 = 2

#: NVIDIA H100 SXM, dense rates at the 700 W limit (data sheet; the port's
#: ``roofline/hw.py::H100``): bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def attn_params(c: dict) -> int:
    d = dims(c)
    return d["D"] * d["N"] * d["H"] * 2 + d["D"] * d["K"] * d["H"] * 2


def expert_params(c: dict) -> int:
    """One expert's (or the dense MLP's) gated FFN."""
    d = dims(c)
    return 3 * d["D"] * d["F"]


def expert_group_bytes(c: dict) -> int:
    """One expert of one layer, as the stream moves it."""
    return expert_params(c) * BF16


def layer_params(c: dict) -> int:
    """Every parameter of one layer (all experts, router, norms)."""
    d = dims(c)
    ffn = d["E"] * expert_params(c) + d["D"] * d["E"] if d["E"] else expert_params(c)
    return attn_params(c) + ffn + 2 * d["D"]


def model_bytes(c: dict) -> int:
    """All weights of the configuration as run (bf16)."""
    d = dims(c)
    head = 0 if c.get("tie_word_embeddings") else d["D"] * d["V"]
    return (d["L"] * layer_params(c) + d["V"] * d["D"] + head + d["D"]) * BF16


def active_matmul_params(c: dict) -> int:
    """Weights one token multiplies by in one layer (its top-k experts)."""
    d = dims(c)
    if d["E"]:
        return attn_params(c) + c["num_experts_per_tok"] * expert_params(c) + d["D"] * d["E"]
    return attn_params(c) + expert_params(c)


def kv_bytes_per_position(c: dict) -> int:
    """Keys and values of one position over every layer."""
    d = dims(c)
    return d["L"] * 2 * d["K"] * d["H"] * BF16


def decode_token_flops(c: dict, length: int) -> float:
    """One decoded token attending to ``length`` positions (itself included),
    through every layer and the head."""
    d = dims(c)
    per_layer = 2 * active_matmul_params(c) + 4 * d["N"] * d["H"] * length
    return d["L"] * per_layer + 2 * d["D"] * d["V"]


def prefill_flops(c: dict, s: int) -> float:
    """A prompt of ``s`` tokens: every token's products, causal attention,
    and the head for the last position only."""
    d = dims(c)
    per_layer = 2 * active_matmul_params(c) * s + 4 * d["N"] * d["H"] * s * (s + 1) / 2
    return d["L"] * per_layer + 2 * d["D"] * d["V"]


def flash_call(c: dict, s: int) -> tuple:
    """``(flops, bytes)`` of one layer's causal flash attention over ``s``
    tokens: QK and PV over the causal triangle; Q, K, V read once and O
    written once (no scores)."""
    d = dims(c)
    flops = 4 * d["N"] * d["H"] * s * (s + 1) / 2
    nbytes = s * (2 * d["N"] + 2 * d["K"]) * d["H"] * BF16
    return flops, nbytes


def decode_attn_call(c: dict, lengths: list) -> tuple:
    """``(flops, bytes)`` of one layer's decode attention for one token a
    slot at the given context lengths: K and V of each slot's positions read
    once, its query read and output written once."""
    d = dims(c)
    n = sum(lengths)
    flops = 4 * d["N"] * d["H"] * n
    nbytes = n * 2 * d["K"] * d["H"] * BF16 + len(lengths) * 2 * d["N"] * d["H"] * BF16
    return flops, nbytes


def least_time(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def routed_expert_bytes(c: dict, routed: int) -> int:
    """A routed MoE step's expert bytes: ``routed`` distinct (layer, expert)
    pairs that the step's tokens chose, each read once."""
    return routed * expert_group_bytes(c)
