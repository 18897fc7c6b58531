"""Streamed weights on the serving path: host- and disk-homed weights under a
device budget.

    PYTHONPATH=src python -m repro_torch.benchmarks.weight_stream [--device cpu]

The serving half of the JAX package's ``benchmarks/weight_stream.py``: the
weights of a 16-layer smollm-360m smoke model are homed at ``pinned_host``
or ``disk_host`` and streamed two layers a group through the transfer
engine for every prefill and paged decode step of a
:class:`~repro_torch.launch.serve.ServeSession`.  Gates:

  * **bitwise**: the decode tokens equal the device-resident run's for every
    ``param_kind`` x distance 0 / 1 / auto;
  * **budget**: the peak streamed bytes plus the residency cache's peak stay
    within the weights' share of the device budget (the budget less the KV
    hot window), while the model's bytes exceed the budget: streaming is
    forced;
  * **requests**: exactly one H2D request per fetched group (resident
    pass-throughs cost none);
  * **decode residency**: without a budget the cache keeps the model on the
    card, so the later decode steps fetch 0 groups; with
    ``param_cache_mb=0`` every step fetches all ``n_groups``.

Not here yet: the train gates (bitwise train steps, the on-demand overlap,
zero-slack and slack residency of the train step) and the sanitizer's
overhead gate need the streamed train step (ROADMAP.md, queue 1 item 6); the
expert gates need the MoE layers (item 7).  The script prints so.

Writes ``results/torch/BENCH_weights.json``.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.benchmarks import common as C
from repro_torch.configs import get_smoke_config
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import serve as sv
from repro_torch.train import steps as st

N_LAYERS = 16
LAYERS_PER_GROUP = 2
KINDS = ("pinned_host", "disk_host")
DISTANCES = (0, 1, "auto")
#: the JAX benchmark's decode run
SERVE = dict(batch=2, prompt_len=12, gen=6, kv_kind="pinned_host", kv_page_len=4, seed=7)


def _decode_run(cfg, params, device, kind, distance, budget_mb, param_cache_mb=None):
    """One paged serve with the weights at ``kind``; returns (tokens, row)."""
    res = sv.serve(cfg, **SERVE, param_kind=kind,
                   device_budget_mb=None if kind == "device" else budget_mb,
                   param_layers_per_group=LAYERS_PER_GROUP, param_distance=distance,
                   param_cache_mb=param_cache_mb, params=params, device=device)
    ps = res["param_stats"]
    rc = res["param_residency"] or {}
    row = {
        "phase": "decode",
        "param_kind": kind,
        "distance": str(distance),
        "generated": res["generated"].tolist(),
        "h2d_requests": ps.h2d_requests,
        "disk_requests": ps.disk_requests,
        "requests_per_fetched_device_group": (
            ps.per_tier()["h2d"]["requests_per_fetched_device_group"]),
        "unique_group_fetches": ps.unique_group_fetches,
        "cache_hits": ps.cache_hits,
        "step_fetches": res.get("param_step_fetches", []),
        "peak_inflight_bytes": ps.peak_inflight_bytes,
        "cache_peak_resident_bytes": rc.get("peak_resident_bytes", 0),
        "n_groups": res["param_plan"].n_groups if res["param_plan"] is not None else 0,
        "decode_s": res["decode_s"],
    }
    return res["generated"], row


def main(device: DeviceLike = None) -> int:
    device = resolve_device(device)
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), n_layers=N_LAYERS)
    plan = WeightStreamPlan(cfg, st.abstract_params(cfg), layers_per_group=LAYERS_PER_GROUP)
    # a budget that forces streaming: a distance-2 window of the weights (so
    # the adaptive controller has room), not the whole model
    budget_bytes = plan.peak_device_bytes(2)
    budget_mb = budget_bytes / 1e6
    params = st.init_params(cfg, SERVE["seed"], device)
    print(f"plan: {plan.n_groups} groups x {plan.layers_per_group} layers, total "
          f"{plan.total_param_bytes} B, budget {budget_bytes} B (shared with the KV hot window)")

    rows = []
    ref_tokens, ref_row = _decode_run(cfg, params, device, "device", "auto", budget_mb)
    ref_row["reference"] = True
    rows.append(ref_row)
    bitwise_ok = budget_ok = requests_ok = True
    forced = plan.total_param_bytes > budget_bytes
    for kind in KINDS:
        for dist in DISTANCES:
            toks, row = _decode_run(cfg, params, device, kind, dist, budget_mb)
            row["bitwise_equal_to_device"] = bool(np.array_equal(toks, ref_tokens))
            row["under_budget"] = forced and (
                row["peak_inflight_bytes"] + row["cache_peak_resident_bytes"] <= budget_bytes)
            bitwise_ok &= row["bitwise_equal_to_device"]
            budget_ok &= row["under_budget"]
            requests_ok &= row["requests_per_fetched_device_group"] == 1.0
            rows.append(row)

    # unbounded cache (no budget): after the first pass the model stays on
    # the card and the later steps fetch nothing; param_cache_mb=0 is the
    # uncached schedule, n_groups fetches a step
    decode_residency_ok = True
    for cache_mb, tail_of in ((None, lambda row: 0), (0.0, lambda row: row["n_groups"])):
        toks, row = _decode_run(cfg, params, device, "pinned_host", "auto", None,
                                param_cache_mb=cache_mb)
        row["phase"] = "decode_residency"
        row["param_cache_mb"] = cache_mb
        row["bitwise_equal_to_device"] = bool(np.array_equal(toks, ref_tokens))
        bitwise_ok &= row["bitwise_equal_to_device"]
        tail = row["step_fetches"][len(row["step_fetches"]) // 2:]
        row["steady_step_fetches"] = tail
        decode_residency_ok &= bool(tail) and all(f == tail_of(row) for f in tail)
        rows.append(row)

    C.print_table(
        f"streamed weights, paged decode ({device})",
        rows,
        ["phase", "param_kind", "distance", "requests_per_fetched_device_group",
         "unique_group_fetches", "cache_hits", "peak_inflight_bytes",
         "cache_peak_resident_bytes", "bitwise_equal_to_device"],
    )
    C.save_rows("BENCH_weights", rows)
    print(f"bitwise (decode tokens, every kind x distance): {bitwise_ok}; streamed + cached "
          f"<= budget {budget_bytes} B < total {plan.total_param_bytes} B: {budget_ok}; "
          f"1 req/fetched group: {requests_ok}; decode steady-state "
          f"fetches (no budget -> 0, no cache -> {plan.n_groups}/step): {decode_residency_ok}")
    print("not run here: the train gates and the sanitizer-overhead gate (the streamed "
          "train step, ROADMAP.md queue 1 item 6); the expert gates (the MoE layers, item 7)")
    return 0 if (bitwise_ok and budget_ok and requests_ok and decode_residency_ok) else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
