#!/usr/bin/env python3
"""Time one-shot host buffers for copies to and from the card.

    python3 pinned_buffer_bench.py [BYTES]     # default 5e9

Three kinds of a BYTES-long uint8 buffer, each made, filled from the card
(D2H), copied back (H2D), checked and freed, twice in turn: the CUDA host
allocator's page-locked block (``pin_memory=True``: rounded up to a power of
two), a pageable allocation registered with ``cudaHostRegister`` at its exact
size (the transfer engine's ``page_locked_empty`` from
``EXACT_PIN_BYTES`` up), and a plain pageable allocation.  Prints the
seconds of each stage and the copies' GB/s, and the card's name and power
limit.  Needs a CUDA card.
"""
import subprocess
import sys
import time
import weakref

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("pinned_buffer_bench: no CUDA device is available", file=sys.stderr)
        return 1
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 5 * 10**9
    dev = torch.device("cuda")
    src = torch.randint(0, 255, (n,), dtype=torch.uint8, device=dev)
    cudart = torch.cuda.cudart()

    def caching():
        return torch.empty(n, dtype=torch.uint8, pin_memory=True)

    def registered():
        t = torch.empty(n, dtype=torch.uint8)
        if int(cudart.cudaHostRegister(t.data_ptr(), n, 0)) != 0:
            raise RuntimeError("cudaHostRegister failed")
        weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
        return t

    def pageable():
        return torch.empty(n, dtype=torch.uint8)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{n} B buffers; {smi}")
    for name, make in (("caching", caching), ("registered", registered),
                       ("pageable", pageable)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = make()
        t1 = time.perf_counter()
        buf.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        back = torch.empty_like(src).copy_(buf, non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ok = torch.equal(back, src)
        del buf, back
        if name == "caching":
            torch._C._host_emptyCache()
        t4 = time.perf_counter()
        print(f"{name}: make {t1 - t0:.3f} s, D2H {t2 - t1:.3f} s ({n / (t2 - t1) / 1e9:.1f} "
              f"GB/s), H2D {t3 - t2:.3f} s ({n / (t3 - t2) / 1e9:.1f} GB/s), free "
              f"{t4 - t3:.3f} s, equal {ok}", flush=True)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
