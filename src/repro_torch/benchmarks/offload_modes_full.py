"""Paper Fig 4 analogue: FULL-size images — data larger than fast memory.

    PYTHONPATH=src python -m repro_torch.benchmarks.offload_modes_full

The paper's headline: pass-by-reference + prefetch let micro-cores process
images far larger than their memory, impossible under eager copy.  The JAX
package's size (``benchmarks/offload_modes_full.py``): 1.8M pixels, 100
hidden units, batch 2, 120 groups, so ``w1`` is 720 MB of f32 homed on the
host and streamed 6 MB a group.  :func:`disk_run` streams the same feed
forward once more with the weights at ``DiskHost``, through ``@offload``'s
``stream_host(policy=DISK_PARAMS)``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Optional

import torch

from repro_torch.benchmarks import common as C
from repro_torch.benchmarks.offload_modes import home_on_host, modeled_link_rows, run
from repro_torch.core import memkind as mk
from repro_torch.core.hoststream import StreamStats
from repro_torch.core.offload import offload
from repro_torch.core.refspec import OffloadRef, PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device

N_PIXELS = 1_800_000
N_GROUPS = 120
BATCH = 2


def disk_run(cfg: C.LungNNConfig, *, groups: int, device: DeviceLike = None,
             spill_dir: Optional[str] = None) -> dict[str, Any]:
    """Feed forward through ``stream_host`` with ``x`` and ``w1`` streamed
    group by group, homed first at ``PinnedHost`` and then at ``DiskHost``
    (spilled, one chunk per group).  Each block's output is the group's
    ``x_g @ w1_g``; summing them in group order gives the executor's
    feed-forward carry bit for bit.  Returns both runs' outputs and stats."""
    dev = resolve_device(device)
    params = C.init_lung_nn(cfg, dev)
    xs, _ = C.make_images(cfg, cfg.batch_images, dev)
    gp = cfg.n_pixels // groups
    # one stream row per group: x as (groups, B, gp), w1 as (groups, gp, hidden)
    x3 = home_on_host(xs.reshape(cfg.batch_images, groups, gp).permute(1, 0, 2).contiguous().cpu(),
                      dev)
    w3 = home_on_host(params["w1"].reshape(groups, gp, cfg.n_hidden).cpu(), dev)
    spec = PrefetchSpec(buffer_size=4, elements_per_fetch=1, distance=2)

    @offload(refs=dict(x=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec),
                       w=OffloadRef(kind=mk.PINNED_HOST, prefetch=spec)), device=dev)
    def ff_block(x, w):
        return (x[0] @ w[0])[None]

    out = {}
    try:
        for name, policy in (("pinned_host", None), ("disk_host", mk.DISK_PARAMS)):
            st = StreamStats()
            res = ff_block.stream_host(x3, w3, stats=st, policy=policy, spill_dir=spill_dir)
            carry = torch.zeros((cfg.batch_images, cfg.n_hidden))
            for part in res:  # group order, as the executor accumulates
                carry = carry + part
            out[name] = {"blocks": res, "carry": carry, "stats": st}
    finally:
        ff_block.close()
    return out


def main(device: DeviceLike = None) -> int:
    dev = resolve_device(device)
    budget_bytes = 4 * 1024 * 1024  # device fast-memory budget per transfer
    image_bytes = N_PIXELS * 4
    print(f"full image: {image_bytes / 2**20:.1f} MiB vs fast-memory budget "
          f"{budget_bytes / 2**20:.1f} MiB -> eager per-argument copy infeasible; "
          f"streaming in {N_GROUPS} bounded groups")
    rows, _ = run(N_PIXELS, groups=N_GROUPS, batch_images=BATCH, tag="fig4_full", device=dev)
    modeled = {r["mode"]: r for r in modeled_link_rows(rows, N_PIXELS, BATCH)}
    speedup = modeled["on_demand_element"]["total_s"] / modeled["prefetch"]["total_s"]
    pf_vs_eager = modeled["eager"]["total_s"] / modeled["prefetch"]["total_s"]
    print(f"paper-link model: on-demand(element)/prefetch = {speedup:.0f}x "
          f"(paper Fig4: ~21x on Epiphany); eager/prefetch = {pf_vs_eager:.2f}x "
          f"(paper: prefetch up to 1.3x over eager)")
    return 0 if speedup >= 5.0 and pf_vs_eager >= 1.0 else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
