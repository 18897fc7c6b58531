"""The split decode-attention kernel: its plan on the CPU, its bits on a card.

The CUDA kernel splits each (row, KV head)'s keys across blocks of
``SPLIT_KV`` keys and merges the blocks' partials in split order.  On the CPU
the tests check ``ops.split_plan``, a model of what each block reads, and the
plain version against the JAX package's kernel at the split edges, on the
same numpy inputs (the JAX kernel in interpret mode, as ``test_kernels.py``
runs it).  Tests marked ``cuda`` hold the kernel against its plain version at
the split edges and check that a row's bits depend only on the row: not on
the ``PrefetchSpec``, the cache length, paging, or the batch's other rows.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_paged,
    decode_attention_ref,
    ops,
)

#: the JAX package's bf16 tolerance (test_kernels.py:_tol) and its f32
#: attention tolerance (test_kernels.py:93)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-4, atol=2e-4)

S = ops.SPLIT_KV
#: a cache length that is a multiple of neither the split nor the stage
T_EDGE = 3 * S + 37
#: every edge of the split: empty, one key, either side of a split boundary,
#: and either end of the cache
EDGE_LENGTHS = [0, 1, S - 1, S, S + 1, T_EDGE - 1, T_EDGE]
SPECS = [PrefetchSpec(1, 1, 0), PrefetchSpec(2, 1, 1), PrefetchSpec(3, 1, 2), PrefetchSpec(3, distance=AUTO)]


def _inputs(seed, shapes, scales):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * c).astype(np.float32) for s, c in zip(shapes, scales)]


# ---------------------------------------------------------------------------
# the split plan (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [1, S - 1, S, S + 1, T_EDGE, 2048])
def test_split_plan_covers_the_valid_prefix_once(cache_len):
    """Every key of ``[0, length)`` is read by exactly one block, in stages
    of at most ``BLOCK_KV`` keys inside splits of ``SPLIT_KV``; the grid has
    ``ceil(T / SPLIT_KV)`` blocks per (row, KV head) whatever the length.
    This checks ``split_plan``, a model of the kernel's walk, not the
    kernel: ``test_decode_kernel_split_edges_on_card`` holds the kernel to
    its plain version at the plan's edges."""
    assert S % ops.BLOCK_KV == 0
    for length in range(-1, cache_len + 2):
        plan = ops.split_plan(cache_len, length)
        assert len(plan) == ops.n_splits(cache_len) == -(-cache_len // S)
        keys = [t for split in plan for stage in split for t in stage]
        assert keys == list(range(max(0, min(length, cache_len))))
        for s, split in enumerate(plan):
            for stage in split:
                assert s * S <= stage.start < stage.stop <= (s + 1) * S
                assert stage.start % ops.BLOCK_KV == 0 and len(stage) <= ops.BLOCK_KV


def test_split_plan_depends_on_key_positions_only():
    """A split's keys are the same for every cache that holds the length,
    and the ``PrefetchSpec`` gives only the ring's (distance, slots)."""
    for length in EDGE_LENGTHS:
        plans = [ops.split_plan(t, length) for t in (max(length, 1), T_EDGE, 2048)]
        used = [p[: -(-length // S)] for p in plans]
        assert used[0] == used[1] == used[2]
        assert all(not stage for p in plans for split in p[len(used[0]):] for stage in split)
    for spec in SPECS:
        distance, slots = ops.ring_of(spec, T_EDGE, 256)
        assert slots >= distance + 1 and ops.smem_bytes(256, slots) <= ops.SMEM_LIMIT
    assert ops.ring_of(PrefetchSpec(3, distance=AUTO), T_EDGE, 64) == (1, 3)  # one split's 2 stages


def test_decode_smem_bytes_counts_the_swizzled_stage():
    """K and V of 64 keys in bf16 per stage, no pad, then the four key
    groups' m, l and merge weights for 16 rows in f32, and at head dim 256
    the 8 KB in which the two warps of each key group add their halves of
    S."""
    for h in ops.HEAD_DIMS:
        for slots in (1, 2, 3):
            exchange = 4 * 2 * 32 * 8 * 4 if h == 256 else 0
            assert ops.smem_bytes(h, slots) == slots * 64 * h * 4 + 3 * 4 * 16 * 4 + exchange
    assert ops.smem_bytes(256, 3) == 205_568 <= ops.SMEM_LIMIT < ops.smem_bytes(256, 4)


@pytest.mark.parametrize("h,g", [(64, 3), (128, 16), (256, 10)])
def test_decode_attention_split_edges_match_jax(h, g):
    """The plain version the kernel is held to, at every split edge, against
    the JAX package's kernel on the same inputs."""
    b, kh = len(EDGE_LENGTHS), 1
    arrays = _inputs(20 + h, [(b, g * kh, h), (b, T_EDGE, kh, h), (b, T_EDGE, kh, h)], [0.5, 0.5, 1.0])
    lengths = np.asarray(EDGE_LENGTHS, np.int32)
    ref = jax_decode_attention(*(jnp.asarray(a) for a in arrays), jnp.asarray(lengths), block_kv=128)
    out = decode_attention(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    assert torch.count_nonzero(out[0]) == 0  # length 0 gives 0, as both kernels give it


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(cuda, g, h, kh=2, t=T_EDGE, lens=EDGE_LENGTHS, seed=30):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
               _inputs(seed, [(len(lens), g * kh, h), (len(lens), t, kh, h), (len(lens), t, kh, h)],
                       [0.5, 0.5, 1.0]))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("h", ops.HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 3, 10, 16])
def test_decode_kernel_split_edges_on_card(cuda, g, h):
    q, k, v, lengths = _card_inputs(cuda, g, h)
    out = decode_attention(q, k, v, lengths)
    ref = decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)
    assert torch.count_nonzero(out[0]) == 0
    # the same bits for every ring
    for spec in SPECS:
        assert torch.equal(decode_attention(q, k, v, lengths, spec=spec), out), spec
    # paged equals dense
    pages = (T_EDGE + 99) // 100
    assert torch.equal(decode_attention_paged(q, k.tensor_split(pages, 1), v.tensor_split(pages, 1),
                                              lengths), out)
    # a row alone, in a cache cut to its length, and in a longer one, equals
    # the same row in the batch
    extra = torch.randn((1, 77) + tuple(k.shape[2:]), device=cuda).to(torch.bfloat16)
    for i, n in enumerate(EDGE_LENGTHS):
        row = slice(i, i + 1)
        for kk, vv in ((k[row], v[row]), (k[row, :max(n, 1)].contiguous(), v[row, :max(n, 1)].contiguous()),
                       (torch.cat([k[row], extra], 1), torch.cat([v[row], extra], 1))):
            assert torch.equal(decode_attention(q[row], kk, vv, lengths[row]), out[row]), (i, n)


@pytest.mark.cuda
def test_decode_wrapper_launches_once_and_never_reads_lengths_on_the_host(cuda, monkeypatch):
    """One ctypes call a decode, which launches two kernels (the split
    kernel and the combine, both counted), no host synchronisation (a
    ``.item()`` or ``.cpu()`` of the lengths would be one), and never the
    plain version."""
    q, k, v, lengths = _card_inputs(cuda, 10, 256)
    expect = decode_attention(q, k, v, lengths)
    lib = _build.load("decode_attention", ops._SIGNATURES)
    calls = []
    entry = lib.repro_decode_attention_bf16

    def counted(*args):
        calls.append(args)
        return entry(*args)

    monkeypatch.setattr(lib, "repro_decode_attention_bf16", counted)
    monkeypatch.setattr(ops, "decode_attention_ref", lambda *a: pytest.fail("the plain version ran"))
    before = decode_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = decode_attention(q, k, v, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(calls) == 1 and decode_attention.launches == before + 2
    assert torch.equal(out, expect)
    assert lib.repro_decode_attention_split_kv() == ops.SPLIT_KV
    assert calls[0][7] == T_EDGE  # T, the grid's size, from the shape alone


@pytest.mark.parametrize("script,attr", [("decode_split_sweep.py", "EDITS")])
def test_decode_tools_edit_lines_that_stand_once(script, attr):
    """``decode_split_sweep.py`` edits copies of the kernel and its wrapper
    line by line: each line must stand exactly once in the file it
    edits."""
    path = Path(__file__).resolve().parents[1] / script
    spec = importlib.util.spec_from_file_location(path.stem, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    edits = getattr(tool, attr)
    assert edits
    for edit in edits:
        rel, line = edit[0], edit[1]
        text = (_build.CSRC.parent / rel).read_text()
        assert text.count(line) == 1, (script, line)
