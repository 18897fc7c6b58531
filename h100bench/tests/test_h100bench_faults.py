"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at smoke sizes (the port's plain paths) with one fault planted
in the session, and reads ``correct``.  A run with nothing planted comes
out correct, and the control (the reference in float8 e4m3 in the
program's place) fails the cell's limits.  One card serves each cell, so
no exchange between chips exists to leave out."""
import dataclasses
import time

import pytest
import torch

from h100bench.harness import check, runner
from conftest import smoke_cell

CELLS = ["mixtral-8x7b.offload", "internlm2-20b.chat"]
SEED = 2**31 + 77
#: the control's test size: deep and wide enough that float8's error adds
#: up as it does at the cells' widths (at smoke size it barely moves a token)
CONTROL_SIZE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8,
                    num_key_value_heads=2, head_dim=32, vocab_size=8192, num_hidden_layers=8)


def _run(name, plant=None, control=False, seconds=1.5, size=None):
    cell = smoke_cell(name, **(size or {}))
    return runner.run(cell, SEED, seconds, False, time.perf_counter(), device="cpu",
                      control=control, plant=plant)


def _wrap_step(session, edit):
    """Make the session's decode step return ``edit(logits)``."""
    inner = session._step

    def step(*args, **kw):
        logits, cache = inner(*args, **kw)
        return edit(logits), cache

    session._step = step


def alter_token(session):
    """Every other step's tokens altered where the step produces them (the
    next id wins)."""
    calls = [0]

    def edit(logits):
        calls[0] += 1
        if calls[0] % 2:
            return logits
        out = logits.clone()
        best = out[:, -1].argmax(dim=-1)
        rows = torch.arange(out.shape[0])
        out[rows, -1, (best + 1) % out.shape[-1]] = out[:, -1].amax(dim=-1) + 1.0
        return out
    _wrap_step(session, edit)


def half_batch(session):
    """Half of the slots (every other one) left out: each gets its
    neighbour's result."""
    def edit(logits):
        out = logits.clone()
        out[1::2] = out[0::2]
        return out
    _wrap_step(session, edit)


def state_unchanged(session):
    """The decode step's new keys and values are never kept."""
    session.pager.update_current = lambda new_cache: None


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res.correct, res.checks
    assert res.numbers["tokens_compared"] > 0 and res.attempted > 0


@pytest.mark.parametrize("fault", [alter_token, half_batch, state_unchanged])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_not_correct(name, fault):
    res = _run(name, plant=fault)
    assert not res.correct, (fault.__name__, res.checks)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    res = _run(name, control=True, size=CONTROL_SIZE)
    ctrl = {k[len("control_"):]: v for k, v in res.numbers.items() if k.startswith("control_")}
    ctrl["tokens_compared"] = res.numbers["tokens_compared"]
    ok, checks = check.judge(ctrl, smoke_cell(name).limits["limits"])
    assert not ok, checks
    assert torch.backends.cuda.matmul.allow_tf32 is False
