"""Shared fixtures of the benchmark's CPU tests: the cells at smoke sizes
(every width cut, the same files otherwise), run on the CPU with the
port's plain paths."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from h100bench.harness import counts, spec  # noqa: E402

#: the widths and depth of a smoke configuration
SMOKE = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, vocab_size=256, num_hidden_layers=2)


#: a cell whose files are kept for a later benchmark PR, without an entry
#: in BENCHMARK.json (PERF.md section 7); the tests build it from its files
KEPT = {"mixtral-8x7b.offload": {"name": "mixtral-8x7b.offload", "config": "mixtral-8x7b",
                                 "traffic": "offload", "chips": 1}}


def smoke_cell(name: str, **sizes) -> spec.Cell:
    """The cell ``name`` at smoke sizes (or ``sizes``): short prompts and
    outputs, few slots, a weight budget that streams, a fast open loop, a
    short priming."""
    cell = (spec.make_cell(KEPT[name], spec.load_json(spec.ROOT / "BENCHMARK.json"))
            if name in KEPT else spec.load_cell(name))
    config = dict(cell.config, **{**SMOKE, **sizes})
    sess = dict(config["session"])
    if "device_budget_mb" in sess:  # the cell's share of the weights: experts stream
        sess["device_budget_mb"] = max(1.0, 0.742 * counts.model_bytes(config) / 1e6)
    config["session"] = sess
    traffic = dict(cell.traffic, prompt_len=[8, 40], output_len=[3, 12], prime_s=0.5)
    if traffic["loop"] == "open":
        traffic.update(slots=4, phases=[{"share": 1.0, "rate_rps": 20.0}])
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
