"""Paper Fig 3 analogue: the ML benchmark under eager / on-demand / prefetch.

    PYTHONPATH=src python -m repro_torch.benchmarks.offload_modes

The claim structure the JAX package's ``benchmarks/offload_modes.py``
reproduces:

  * on-demand  <<  eager  <=  prefetch   (end-to-end phase times)
  * the on-demand penalty comes from *request count*, not per-transfer time
  * model update is unaffected by the transfer mode (no data movement)

The images and the first-layer weights live at the paper's ``Host`` kind —
page-locked host memory on the card — and the
:class:`~repro_torch.core.hoststream.HostStreamExecutor` moves pixel groups
to the device according to the schedule.  On the CPU (``device="cpu"``)
host data is numpy, as in the JAX package.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any

import torch

from repro_torch.benchmarks import common as C
from repro_torch.core import memkind as mk
from repro_torch.core.hoststream import HostStreamExecutor, StreamStats
from repro_torch.core.refspec import PrefetchSpec
from repro_torch.device import DeviceLike, resolve_device

MODES = ("eager", "on_demand", "prefetch")
SPEC = PrefetchSpec(buffer_size=4, elements_per_fetch=1, distance=2)


def home_on_host(t: torch.Tensor, device: torch.device) -> Any:
    """The paper's ``Host`` kind for data computed on ``device``: pinned
    memory on the card; numpy on the CPU, where a tensor would already be
    device-resident and pass through the engine by reference."""
    if device.type == "cpu":
        return t.numpy()
    return mk.place(t, mk.PINNED_HOST, device)


def ff_apply(carry, group):
    """Feed forward, one pixel group: accumulate ``x_g @ w1_g``."""
    xg, wg = group
    return carry + xg @ wg


def grad_apply(carry, group):
    """Combine gradients, one pixel group: the group's first-layer gradient,
    written back to the host (``rw``)."""
    xg, wg, dh = group  # dh: (B, hidden) upstream grad, device-resident
    gw = xg.T @ dh
    return carry + torch.sum(gw * wg), gw


def run_modes(params: dict, xs: torch.Tensor, ys: torch.Tensor, *, groups: int,
              device: torch.device, repeats: int = 3) -> tuple[list[dict], dict]:
    """The three schedules over device-resident ``params``/``xs``/``ys``
    whose images and ``w1`` are homed on the host for the study.  Returns
    ``(rows, outputs)``: one row of times and per-run counters per mode, and
    per mode the feed-forward carry, the gradient carry and the written-back
    gradient groups."""
    n_pixels, n_hidden = params["w1"].shape
    batch = xs.shape[0]
    if n_pixels % groups:
        raise ValueError(f"{n_pixels} pixels do not split into {groups} groups")
    gp = n_pixels // groups
    xs_host = home_on_host(xs.cpu(), device)
    w1_host = home_on_host(params["w1"].cpu(), device)
    w1_groups = [w1_host[i * gp:(i + 1) * gp] for i in range(groups)]
    x_groups = [xs_host[:, i * gp:(i + 1) * gp] for i in range(groups)]

    # upstream pieces computed once on the device (not part of the study)
    h = torch.sigmoid(xs @ params["w1"])
    p = torch.sigmoid(h @ params["w2"])
    dh = ((p - ys) @ params["w2"].T) * h * (1 - h)

    rows, outputs = [], {}
    for mode in MODES:
        out: dict[str, Any] = {}
        # -- feed forward ----------------------------------------------------
        st = StreamStats()
        carry = torch.zeros((batch, n_hidden), device=device)
        with HostStreamExecutor(ff_apply, device=device) as ex:
            ff = C.timed(lambda: out.__setitem__("ff", ex.run(
                carry, list(zip(x_groups, w1_groups)), prefetch=SPEC, mode=mode, stats=st)[0]),
                stats=st, repeats=repeats)

        # -- combine gradients (rw: grads written back to host) ---------------
        st2 = StreamStats()
        with HostStreamExecutor(grad_apply, writeback=True, device=device) as ex2:
            def cg_run():
                out["cg"], out["cg_groups"] = ex2.run(
                    torch.zeros((), device=device), list(zip(x_groups, w1_groups, [dh] * groups)),
                    prefetch=SPEC, mode=mode, stats=st2)
            cg = C.timed(cg_run, stats=st2, repeats=repeats)

        # -- model update (no transfers — paper: identical across modes) ------
        grads = C.combine_gradients(params, xs, ys)
        mu = C.timed(lambda: C.model_update(params, grads), repeats=repeats)

        # stats were reset after the warmup: counters cover st.n_runs runs
        per = max(st.n_runs, 1)
        rows.append({
            "mode": mode,
            "feed_forward_s": ff["median_s"],
            "combine_grad_s": cg["median_s"],
            "model_update_s": mu["median_s"],
            "n_transfers": st.n_transfers // per,
            "bytes_h2d": st.bytes_h2d // per,
            "h2d_requests": st.h2d_requests // per,
            "requests_per_group": st.requests_per_group,
            "peak_inflight_bytes": st.peak_inflight_bytes,
            "transfer_wait_s": st.transfer_wait_s / per,
            "compute_s": st.compute_s / per,
            "cg_h2d_requests": st2.h2d_requests // max(st2.n_runs, 1),
            "cg_bytes_h2d": st2.bytes_h2d // max(st2.n_runs, 1),
            "cg_bytes_d2h": st2.bytes_d2h // max(st2.n_runs, 1),
            "cg_transfer_wait_s": st2.transfer_wait_s / max(st2.n_runs, 1),
            "n_runs": st.n_runs,
        })
        outputs[mode] = out
    return rows, outputs


def run(n_pixels: int = 3600, *, groups: int = 16, batch_images: int = 8,
        tag: str = "fig3_small", device: DeviceLike = None,
        repeats: int = 3) -> tuple[list[dict], dict]:
    """The study at ``n_pixels`` with weights and images from the config's
    seed; prints and saves the measured and the paper-link tables.  Returns
    :func:`run_modes`'s ``(rows, outputs)``."""
    dev = resolve_device(device)
    cfg = C.LungNNConfig(n_pixels=n_pixels, batch_images=batch_images)
    params = C.init_lung_nn(cfg, dev)
    xs, ys = C.make_images(cfg, batch_images, dev)
    rows, outputs = run_modes(params, xs, ys, groups=groups, device=dev, repeats=repeats)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    C.print_table(f"paper Fig3 analogue ({tag}, {n_pixels} px) — measured on {where}", rows,
                  ["mode", "feed_forward_s", "combine_grad_s", "model_update_s", "h2d_requests",
                   "transfer_wait_s"])
    C.save_rows(tag, rows)
    modeled = modeled_link_rows(rows, n_pixels, batch_images)
    C.print_table(
        f"paper-link model ({tag}): Epiphany 88 MB/s + 0.104 ms/request "
        f"(the paper's measured constants) applied to the RECORDED schedule",
        modeled, ["mode", "n_requests", "transfer_busy_s", "total_s", "vs_prefetch"])
    C.save_rows(tag + "_modeled", modeled)
    return rows, outputs


# the paper's measured link constants (§5.1): Epiphany observed 88 MB/s and
# a host-service latency of ~0.104 ms/request (Table 2, 128 B mean) — the
# paper's model, not a measurement of this port
PAPER_BW = 88e6
PAPER_LAT = 0.104e-3


def modeled_link_rows(rows: list[dict], n_pixels: int, batch_images: int) -> list[dict]:
    """Replay the recorded transfer schedule (requests, bytes, overlap)
    against the paper's own link constants.  ``on_demand_element`` is the
    paper's true on-demand mode: one request per element."""
    by = {r["mode"]: r for r in rows}
    bytes_total = by["prefetch"]["bytes_h2d"]
    compute = by["eager"]["compute_s"]
    n_groups = by["prefetch"]["n_transfers"]
    n_requests_chunked = by["prefetch"]["h2d_requests"]
    n_elements = n_pixels * batch_images
    out = []

    def total(n_req, overlap):
        busy = n_req * PAPER_LAT + bytes_total / PAPER_BW
        t = max(busy, compute) if overlap else busy + compute
        return busy, t

    for mode, n_req, overlap in (
        ("eager", 2, False),  # bulk copy, then compute
        ("on_demand_element", n_elements, False),  # paper's per-element fetch
        ("on_demand_chunk", n_groups, False),  # one request per group
        ("prefetch", n_requests_chunked, True),  # the engine's recorded count
    ):
        busy, t = total(n_req, overlap)
        out.append({"mode": mode, "n_requests": int(n_req), "transfer_busy_s": busy,
                    "total_s": t})
    ref = next(r for r in out if r["mode"] == "prefetch")["total_s"]
    for r in out:
        r["vs_prefetch"] = r["total_s"] / ref
    return out


def main(device: DeviceLike = None) -> int:
    rows, _ = run(3600, groups=16, tag="fig3_small", device=device)
    modeled = {r["mode"]: r for r in modeled_link_rows(rows, 3600, 8)}
    ok_order = (
        modeled["prefetch"]["total_s"]
        <= modeled["eager"]["total_s"]
        <= modeled["on_demand_element"]["total_s"]
    )
    ratio = modeled["on_demand_element"]["total_s"] / modeled["prefetch"]["total_s"]
    print(f"claim checks (paper-link model): prefetch <= eager <= on-demand: {ok_order}; "
          f"on-demand(element)/prefetch = {ratio:.0f}x (paper: 21-25x on Epiphany)")
    return 0 if ok_order and ratio > 5 else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
