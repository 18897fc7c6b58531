"""The plain reference held against the port's plain path at smoke sizes.

The test imports both; the reference itself imports neither the port nor
JAX.  Both run in float32 on the CPU from the benchmark's weights, so they
agree to float32 rounding: the reference and the port compute the same
model (the weights' names mapped as ``harness/program.py`` maps them)."""
import dataclasses

import numpy as np
import pytest
import torch

from h100bench.harness import program, weights
from h100bench.reference.model import Reference, gaps
from conftest import smoke_cell


def _port_logits(cell, prompt):
    """The port's plain-path prefill logits at the last prompt position, f32."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(program.port_config(cell.config), attn_impl="xla",
                              dtype="float32")
    params = program.make_params(cfg, cell.config, 7, torch.device("cpu"), "device")
    params = params.to(torch.float32)
    caches = transformer.init_caches(cfg, 1, len(prompt), torch.float32, "cpu")
    batch = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long)}
    logits, _ = transformer.prefill(cfg, params, batch, caches)
    return logits[0, -1].float()


@pytest.mark.parametrize("name", ["internlm2-20b.chat", "mixtral-8x7b.offload"])
@pytest.mark.parametrize("length", [9, 33])
def test_reference_matches_the_port_plain_path(name, length):
    cell = smoke_cell(name)
    c = cell.config
    prompt = np.random.default_rng(length).integers(1, c["vocab_size"], size=length)
    want = _port_logits(cell, prompt)
    ref = Reference(c, q_block=8)  # several query blocks
    (got, _), = ref.served_logits([(prompt, [0])],
                                  weights.shell(c, 7, "cpu"),
                                  lambda i: weights.layer(c, 7, i, "cpu"),
                                  c["num_hidden_layers"], "cpu")
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)


def test_gaps_are_zero_for_the_reference_best_tokens():
    logits = torch.tensor([[0.0, 2.0, 1.0], [3.0, -1.0, 0.5]])
    assert gaps(logits, [1, 0]).tolist() == [0.0, 0.0]
    assert gaps(logits, [2, 1]).tolist() == [1.0, 4.0]


def test_control_rounds_to_float8():
    from h100bench.reference.model import _q8

    x = torch.linspace(-3, 3, 101)[None]
    q = _q8(x, -1)
    assert not torch.equal(q, x)
    assert (q - x).abs().max() <= 3 * 2 ** -4  # e4m3: 3 mantissa bits
