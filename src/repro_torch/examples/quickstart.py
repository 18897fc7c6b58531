"""Quickstart: the paper's offload abstractions in five minutes, on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The JAX package's ``examples/quickstart.py``, listing for listing: each
listing is checked against its plain answer and :func:`main` returns the
checks (``chip_smoke.py`` requires every one).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import HOST_OPT, OffloadRef, PrefetchSpec, offload
from repro_torch.core import memkind as mk
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.streamed_matmul import matmul_ref, streamed_matmul


def main(device: DeviceLike = None, seed: int = 0) -> dict[str, bool]:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    checks = {}

    # -----------------------------------------------------------------------
    # 1. Paper Listing 1: decorate a kernel; arguments are passed BY REFERENCE
    # -----------------------------------------------------------------------
    nums1 = rng.integers(0, 100, 1000).astype(np.float32)
    nums2 = rng.integers(0, 100, 1000).astype(np.float32)

    @offload(device=dev)
    def mykernel(a, b):
        return a + b

    out = mykernel(nums1, nums2)
    print("listing-1 sum:", out[:5].cpu().numpy(), "... on", out.device)
    checks["listing1"] = bool(np.array_equal(out.cpu().numpy(), nums1 + nums2))

    # -----------------------------------------------------------------------
    # 2. Paper Listing 2: add a prefetch annotation — same result, streamed
    #    through a bounded device buffer (buffer_size / elements_per_fetch /
    #    distance are the paper's exact knobs)
    # -----------------------------------------------------------------------
    spec = PrefetchSpec(buffer_size=10, elements_per_fetch=2, distance=4)

    @offload(refs=dict(
        a=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec),
        b=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec),
    ), device=dev)
    def mykernel2(a, b):
        return a + b

    big_a = rng.standard_normal((64, 1024)).astype(np.float32)  # lives at the Host kind
    big_b = rng.standard_normal((64, 1024)).astype(np.float32)
    out = mykernel2(big_a, big_b)
    checks["listing2"] = bool(np.array_equal(out.cpu().numpy(), big_a + big_b))
    print("listing-2 streamed:", checks["listing2"])

    # -----------------------------------------------------------------------
    # 3. Paper Listing 3 / §3.2: memory kinds — one line moves data between
    #    hierarchy levels; the kind handles the mechanics
    # -----------------------------------------------------------------------
    x = torch.arange(8.0)
    x_host = mk.place(x, mk.PINNED_HOST, dev)
    x_dev = mk.place(x_host, mk.DEVICE, dev)
    where = f"{mk.kind_of(x_host).jax_kind} -> {mk.kind_of(x_dev).jax_kind} ({x_dev.device})"
    checks["listing3"] = bool(torch.equal(x_dev.cpu(), x))
    print("kind round-trip:", checks["listing3"], where,
          f"(host-offload support: {mk.host_offload_supported(dev)})")
    # placement policies: the production form of the same idea
    print("policy:", HOST_OPT.name, "-> optimizer state lives at", HOST_OPT.opt_state.jax_kind)

    # -----------------------------------------------------------------------
    # 4. The kernel level: weights stay in device memory, prefetched on chip
    # -----------------------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(seed)
    xk = torch.randn((256, 512), generator=g, device=dev)
    wk = torch.randn((512, 256), generator=g, device=dev)
    y = streamed_matmul(xk, wk, spec=PrefetchSpec(buffer_size=3, elements_per_fetch=1, distance=2))
    checks["listing4"] = bool(torch.allclose(y, matmul_ref(xk, wk), atol=1e-3))
    print("streamed matmul matches oracle:", checks["listing4"])
    return checks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(0 if all(main(ap.parse_args().device).values()) else 1)
