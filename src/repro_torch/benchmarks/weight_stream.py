"""Streamed weights: host- and disk-homed weights under a device budget, for
training and serving.

    PYTHONPATH=src python -m repro_torch.benchmarks.weight_stream [--device cpu]

The JAX package's ``benchmarks/weight_stream.py`` without its expert gates:
the weights of a 16-layer smollm-360m smoke model (12 under
``REPRO_BENCH_SMOKE=1``) are homed at ``pinned_host`` or ``disk_host`` and
streamed two layers a group through the transfer engine.  Gates:

  * **bitwise**: the streamed train step (losses and updated parameters,
    from the group-wise init) and the paged decode (tokens of a
    :class:`~repro_torch.launch.serve.ServeSession`) equal the device home's
    run for every ``param_kind`` x distance 0 / 1 / auto;
  * **budget**: the peak streamed bytes (plus the residency cache's peak,
    where the budget has slack or is shared with the KV hot window) stay
    within the budget, while the model's bytes exceed it: streaming is
    forced;
  * **requests**: exactly one H2D request per fetched group (resident
    pass-throughs cost none);
  * **overlap**: on a modeled link whose latency prefetch can hide, the
    train step's steady per-group wait at ``distance="auto"`` is at least 2x
    lower than at ``distance=0`` (the paper's on-demand penalty);
  * **zero slack**: at the tight budget the train step's residency cache has
    no capacity, and every consumed group is a fetch (``unique_group_fetches
    == n_groups``), the uncached schedule's traffic exactly;
  * **steady state**: a budget with slack for the whole model keeps it
    resident: at least 2x fewer H2D requests than the zero-slack run, with
    cache hits, bitwise all the same;
  * **decode residency**: without a budget the cache keeps the model on the
    card, so the later decode steps fetch 0 groups; with
    ``param_cache_mb=0`` every step fetches all ``n_groups``;
  * **sanitizer overhead**: the hazard sanitizer (``REPRO_SANITIZE=1``)
    costs at most 5% of the plain streamed train step (plus the JAX
    package's 5 ms floor for scheduling noise), bitwise all the same.  Each
    side's step cost is its median step wall, as in the JAX package, the
    two sides' steps interleaved so that both see the same machine.

Not here: the expert gates need the MoE layers (ROADMAP.md, queue 1 item 7).
The script prints so.

Writes ``results/torch/BENCH_weights.json``.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks import common as C
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as tr
from repro_torch.core.arrays import host_tensor
from repro_torch.core.engine import EngineConfig, LinkModel, TransferEngine
from repro_torch.core.refspec import AUTO, PrefetchSpec
from repro_torch.core.residency import ResidencyCache
from repro_torch.core.spillstore import SpillStore
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import serve as sv
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as st

SMOKE = bool(int(os.environ.get("REPRO_BENCH_SMOKE", "0")))

N_LAYERS = 12 if SMOKE else 16
LAYERS_PER_GROUP = 2
KINDS = ("pinned_host", "disk_host")
DISTANCES = (0, 1, AUTO)
#: the train runs: steps (the first untimed), batch and sequence
STEPS = 4 if SMOKE else 6
BATCH, SEQ = 2, 64
#: the JAX package's modeled link for the train runs: request- and
#: latency-dominated (the latency is what the prefetch window hides), with
#: bandwidth high enough that the gradients' writebacks do not saturate it
LINK_KW = dict(request_s=0.15e-3, bandwidth_Bps=5e9, latency_s=2.5e-3)
#: steps of the overhead gate's plain and sanitized train steps, interleaved
SANITIZE_STEPS = 32
#: the JAX benchmark's decode run
SERVE = dict(batch=2, prompt_len=12, gen=6, kv_kind="pinned_host", kv_page_len=4, seed=7)


def _bits(x) -> np.ndarray:
    return host_tensor(x).detach().cpu().contiguous().view(torch.uint8).numpy().copy()


def _train_run(cfg, plan, budget_bytes, kind, distance, device):
    """``STEPS`` streamed train steps at (kind, distance) on the modeled
    link; returns (losses, the final parameters' bytes, a row).  The first
    step is untimed and the counters are reset after it."""
    engine = TransferEngine(EngineConfig(link=LinkModel(**LINK_KW),
                                         max_distance=plan.max_distance_for_budget()),
                            device=device)
    tmp = tempfile.mkdtemp(prefix="repro-torch-bench-wp-") if kind == "disk_host" else None
    store = SpillStore(tmp, ephemeral=True) if tmp else None
    step = st.make_weight_streamed_train_step(
        cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=64), plan=plan,
        prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=distance),
        engine=engine, spill_store=store, param_kind=kind)
    try:
        state = st.init_weight_streamed_state(cfg, plan, 0, device)
        if kind == "disk_host":
            state = st.spill_weight_streamed_state(plan, state, store)
        elif kind == "device":
            state = st.device_weight_streamed_state(plan, state, device)
        sc = SyntheticConfig(cfg.vocab_size, SEQ, BATCH, seed=0)

        def batch(k):
            return {n: v.to(device) for n, v in synthetic_batch(cfg, sc, k).items()}

        state, m0 = step(state, batch(0))
        losses = [float(m0["loss"])]
        step.param_stats.reset()
        step.opt_stats.reset()
        walls = []
        for k in range(1, STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch(k))
            losses.append(float(m["loss"]))  # reads the loss: the step has ended
            walls.append(time.perf_counter() - t0)
        final = {key: [_bits(x) for x in tr.leaves(tree)]
                 for key, tree in state["params"]["groups"].items()}
        stats, cache = step.param_stats, step.residency
        waits = list(stats.wait_per_group)
        row = {
            "phase": "train",
            "param_kind": kind,
            "distance": str(distance),
            "losses": losses,
            "h2d_requests": stats.h2d_requests,
            "n_groups": stats.n_groups,
            "requests_per_fetched_device_group": (
                stats.per_tier()["h2d"]["requests_per_fetched_device_group"]),
            "unique_group_fetches": stats.unique_group_fetches,
            "cache_hits": stats.cache_hits,
            "cache_capacity_bytes": cache.capacity_bytes if cache is not None else None,
            "cache_peak_resident_bytes": cache.peak_resident_bytes if cache is not None else 0,
            "disk_requests": stats.disk_requests,
            "peak_inflight_bytes": stats.peak_inflight_bytes,
            "budget_bytes": budget_bytes,
            "total_param_bytes": plan.total_param_bytes,
            "steady_wait_per_group_s": float(np.median(waits[len(waits) // 2:] or [0.0])),
            "step_wall_s": walls,
            "transfer_wait_s": stats.transfer_wait_s,
            "final_distance": stats.distance_trace[-1] if stats.distance_trace else None,
        }
    finally:
        step.close()
        engine.close()
        if store is not None:
            store.close()
    return losses, final, row


def _sanitizer_overhead(cfg, plan, budget_bytes, device) -> dict:
    """The plain and the sanitized streamed train step (pinned host,
    ``distance="auto"``, the modeled link) side by side, their steps
    interleaved (each side first in turn) so that both see the same
    machine: each side's median step wall after its first step (the JAX
    package's statistic), and both sides' losses."""
    sides = []
    for sanitize in (False, True):
        engine = TransferEngine(EngineConfig(link=LinkModel(**LINK_KW), sanitize=sanitize,
                                             max_distance=plan.max_distance_for_budget()),
                                device=device)
        step = st.make_weight_streamed_train_step(
            cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=64), plan=plan,
            prefetch=PrefetchSpec(buffer_size=plan.n_groups + 2, distance=AUTO), engine=engine,
            residency=ResidencyCache(plan.residency_capacity_bytes(), sanitize=sanitize),
            param_kind="pinned_host")
        sides.append({"engine": engine, "step": step, "losses": [], "walls": [],
                      "state": st.init_weight_streamed_state(cfg, plan, 0, device)})
    sc = SyntheticConfig(cfg.vocab_size, SEQ, BATCH, seed=0)
    try:
        for k in range(SANITIZE_STEPS):
            batch = {n: v.to(device) for n, v in synthetic_batch(cfg, sc, k).items()}
            for side in (sides if k % 2 else sides[::-1]):  # each side first in turn
                t0 = time.perf_counter()
                side["state"], m = side["step"](side["state"], batch)
                side["losses"].append(float(m["loss"]))  # the step has ended
                if k:
                    side["walls"].append(time.perf_counter() - t0)
        plain, sanitized = sides
        checks = sanitized["engine"].sanitizer.checks
        stats = sanitized["step"].param_stats
    finally:
        for side in sides:
            side["step"].close()
            side["engine"].close()
    plain_s, san_s = float(np.median(plain["walls"])), float(np.median(sanitized["walls"]))
    return {
        "phase": "train_sanitized", "param_kind": "pinned_host", "distance": str(AUTO),
        "losses": sanitized["losses"], "plain_losses": plain["losses"],
        "requests_per_fetched_device_group": (
            stats.per_tier()["h2d"]["requests_per_fetched_device_group"]),
        "unique_group_fetches": stats.unique_group_fetches, "cache_hits": stats.cache_hits,
        "peak_inflight_bytes": stats.peak_inflight_bytes, "budget_bytes": budget_bytes,
        "steady_wait_per_group_s": None,
        "final_distance": stats.distance_trace[-1] if stats.distance_trace else None,
        "sanitizer_checks": checks, "step_wall_s": sanitized["walls"],
        "plain_step_wall_s": plain["walls"], "median_step_s": san_s,
        "plain_median_step_s": plain_s, "overhead_vs_plain": san_s / max(plain_s, 1e-9),
    }


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
        for k in a)


def train_gates(cfg, device) -> tuple[list, dict, str]:
    """The train half: every gate's verdict and its rows."""
    abs_p = st.abstract_params(cfg)
    free = WeightStreamPlan(cfg, abs_p, layers_per_group=LAYERS_PER_GROUP)
    # a budget that forces streaming: a distance-2 window (room for the
    # adaptive controller), not the whole model
    budget_bytes = free.peak_device_bytes(2)
    plan = WeightStreamPlan(cfg, abs_p, layers_per_group=LAYERS_PER_GROUP,
                            device_budget_mb=budget_bytes / 1e6)
    # a slack budget: the widest window plus every home group
    slack_bytes = sum(plan.fetch_sequence_bytes()) + plan.total_param_bytes
    slack_plan = WeightStreamPlan(cfg, abs_p, layers_per_group=LAYERS_PER_GROUP,
                                  device_budget_mb=slack_bytes / 1e6)
    assert (slack_plan.residency_capacity_bytes() or 0) >= plan.total_param_bytes
    print(f"train plan: {plan.n_groups} groups x {plan.layers_per_group} layers, total "
          f"{plan.total_param_bytes} B, budget {budget_bytes} B (slack run: {slack_bytes} B), "
          f"max distance {plan.max_distance_for_budget()}")
    rows = []
    ref_losses, ref_params, ref_row = _train_run(cfg, plan, budget_bytes, "device", 1, device)
    ref_row["reference"] = True
    rows.append(ref_row)
    ok = dict(bitwise=True, budget=True, requests=True, zero_slack=True)
    for kind in KINDS:
        for dist in DISTANCES:
            losses, params, row = _train_run(cfg, plan, budget_bytes, kind, dist, device)
            row["bitwise_equal_to_device"] = losses == ref_losses and _same(params, ref_params)
            row["under_budget"] = (row["peak_inflight_bytes"] <= budget_bytes
                                   < plan.total_param_bytes)
            ok["bitwise"] &= row["bitwise_equal_to_device"]
            ok["budget"] &= row["under_budget"]
            ok["requests"] &= row["requests_per_fetched_device_group"] == 1.0
            # no slack: the cache has no capacity and every consumed group
            # crosses the link, the uncached schedule's traffic exactly
            ok["zero_slack"] &= (row["cache_capacity_bytes"] == 0
                                 and row["unique_group_fetches"] == row["n_groups"])
            rows.append(row)
    by = {(r["param_kind"], r["distance"]): r for r in rows if r["phase"] == "train"}

    # budget slack: the model stays resident, the re-fetch traffic collapses
    ok["residency"] = ok["cached_budget"] = True
    for kind in KINDS:
        losses, params, row = _train_run(cfg, slack_plan, slack_bytes, kind, AUTO, device)
        row["phase"] = "train_slack"
        row["bitwise_equal_to_device"] = losses == ref_losses and _same(params, ref_params)
        ok["bitwise"] &= row["bitwise_equal_to_device"]
        tight = by[(kind, str(AUTO))]
        row["traffic_reduction_vs_zero_slack"] = tight["h2d_requests"] / max(row["h2d_requests"], 1)
        ok["residency"] &= (2 * row["h2d_requests"] <= tight["h2d_requests"]
                            and row["cache_hits"] > 0)
        row["under_budget"] = (row["peak_inflight_bytes"] + row["cache_peak_resident_bytes"]
                               <= slack_bytes)
        ok["cached_budget"] &= row["under_budget"]
        rows.append(row)

    # overlap: distance "auto" against the on-demand schedule
    w0 = by[("pinned_host", "0")]["steady_wait_per_group_s"]
    wa = by[("pinned_host", str(AUTO))]["steady_wait_per_group_s"]
    collapse = w0 / max(wa, 1e-9)
    ok["overlap"] = collapse >= 2.0

    # the sanitizer's overhead on the clean streamed path
    row = _sanitizer_overhead(cfg, plan, budget_bytes, device)
    row["bitwise_equal_to_device"] = (row["losses"][:STEPS] == ref_losses
                                      and row["plain_losses"] == row["losses"])
    ok["bitwise"] &= row["bitwise_equal_to_device"]
    plain_s, san_s = row["plain_median_step_s"], row["median_step_s"]
    ok["sanitize_overhead"] = row["sanitizer_checks"] > 0 and san_s <= plain_s * 1.05 + 0.005
    rows.append(row)

    C.print_table(
        f"streamed weights, train (modeled link, {device})",
        [r for r in rows if r["phase"].startswith("train")],
        ["phase", "param_kind", "distance", "requests_per_fetched_device_group",
         "unique_group_fetches", "cache_hits", "peak_inflight_bytes",
         "steady_wait_per_group_s", "final_distance", "bitwise_equal_to_device"],
    )
    summary = (
        f"train: bitwise (losses + parameters, every kind x distance, slack and sanitized): "
        f"{ok['bitwise']}; peak streamed {by[('pinned_host', str(AUTO))]['peak_inflight_bytes']} B "
        f"<= budget {budget_bytes} B < total {plan.total_param_bytes} B: {ok['budget']}; "
        f"1 req/fetched group: {ok['requests']}; steady wait on-demand/auto = {collapse:.1f}x "
        f"(gate >= 2x): {ok['overlap']}\n"
        f"train residency: zero slack = plain streaming: {ok['zero_slack']}; slack steady-state "
        f"traffic collapse >= 2x: {ok['residency']}; streamed + cached <= budget: "
        f"{ok['cached_budget']}\n"
        f"sanitizer (REPRO_SANITIZE=1): median step {san_s * 1e3:.2f} ms vs plain "
        f"{plain_s * 1e3:.2f} ms = {row['overhead_vs_plain']:.3f}x (gate <= 1.05x + 5 ms), "
        f"{row['sanitizer_checks']} sanitizer checks: "
        f"{ok['sanitize_overhead']}")
    return rows, ok, summary


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
    # on the CPU the train half runs on one intra-op thread: at these shapes
    # more threads only add scheduling noise to the step walls it compares
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        train_rows, train_ok, train_summary = train_gates(cfg, device)
    finally:
        torch.set_num_threads(threads)
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
    C.save_rows("BENCH_weights", train_rows + rows)
    print(train_summary)
    print(f"decode: bitwise (tokens, every kind x distance): {bitwise_ok}; streamed + cached "
          f"<= budget {budget_bytes} B < total {plan.total_param_bytes} B: {budget_ok}; "
          f"1 req/fetched group: {requests_ok}; decode steady-state "
          f"fetches (no budget -> 0, no cache -> {plan.n_groups}/step): {decode_residency_ok}")
    print("not run here: the expert gates (the MoE layers, ROADMAP.md queue 1 item 7)")
    return 0 if (all(train_ok.values()) and bitwise_ok and budget_ok and requests_ok
                 and decode_residency_ok) else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
