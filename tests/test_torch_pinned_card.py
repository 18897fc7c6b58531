"""The transfer engine's page-locked buffers on the card (marked ``cuda``;
skips without one).

From ``EXACT_PIN_BYTES`` up a buffer is registered with CUDA at its
exact size, not rounded up to a power of two by the CUDA host allocator;
copies through it give the card's bytes back.  No JAX here.
"""
import gc

import pytest
import torch

from repro_torch.core.engine import EXACT_PIN_BYTES, page_locked_empty


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory is CUDA's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, EXACT_PIN_BYTES + 4097])
def test_page_locked_buffers_copy_both_ways(cuda, n):
    src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda)
    buf = page_locked_empty((n,), torch.uint8)
    assert buf.is_pinned() and buf.untyped_storage().nbytes() == n
    buf.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    back = torch.empty_like(src).copy_(buf, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(back, src)
    view = buf[1:]  # a view outlives the tensor: its memory stays valid
    del buf
    gc.collect()
    assert torch.equal(view.to(cuda), src[1:])
