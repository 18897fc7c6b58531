"""SLO serving study: goodput under load + copy-on-write prefix sharing.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_slo [--device cpu]

The JAX package's ``benchmarks/serve_slo.py`` on the port.  Two experiments
over the paged serve session, both under the modeled Epiphany-class link:

1. **Prefix sharing A/B** — a batch whose prompts share a page-aligned
   system prefix, served with COW prefix sharing ON vs OFF at the
   pinned-host and disk tiers.  Sharing aliases the shared cold pages under
   one content key, so the whole batch pays ONE fetch (and one spill chunk)
   per shared page per step instead of one per request.

2. **Open-loop SLO run** — a seeded Poisson trace (bursty phases, mixed
   prompt/output lengths, shared system prompt) through the admission-
   controlled scheduler on a deterministic virtual clock, reporting
   TTFT/TPOT percentiles, SLO attainment, goodput-under-SLO, and per-tier
   request counts.

Gates:

  * sharing ON decodes bitwise-identical tokens to sharing OFF,
  * sharing ON performs >= 2x fewer unique cold-page fetches — and, at the
    disk tier, >= 2x fewer disk requests — than the no-sharing baseline,
  * the SLO report carries goodput-under-SLO, TTFT/TPOT percentiles and
    per-tier request counts, and is reproducible across two runs of the
    same seed (virtual clock).

Writes ``results/torch/BENCH_serve_slo.json``.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.benchmarks import common as C
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import EngineConfig, LinkModel, TransferEngine
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import serve as sv
from repro_torch.serve import SLO, LoadGenConfig, Phase, SLOScheduler, generate

#: shared-system-prompt workload: 4 cohabiting slots whose prompts agree on
#: the first 32 tokens (4 pages of 8) with an 8-token private tail — the
#: cold set is dominated by the shared pages
SLOTS = 4
PAGE_LEN = 8
SHARED_PREFIX = 32
PROMPT = 40
GEN = 16

HOST_LINK = LinkModel(request_s=0.3e-3, bandwidth_Bps=40e6, latency_s=0.0)
DISK_LINK = LinkModel(request_s=0.5e-3, bandwidth_Bps=40e6, latency_s=2e-3)


def _engine(device) -> TransferEngine:
    return TransferEngine(EngineConfig(link=HOST_LINK, disk_link=DISK_LINK), device=device)


def _ab_row(kind: str, sharing: bool, res) -> dict:
    st = res["stats"]
    return {
        "kv_kind": kind,
        "prefix_sharing": sharing,
        "unique_group_fetches": st.unique_group_fetches,
        "disk_requests": st.disk_requests,
        "d2h_requests": st.d2h_requests,
        "shared_hits": st.shared_hits,
        "shared_skipped_writebacks": res["shared_skipped_writebacks"],
        "h2d_requests": st.h2d_requests,
        "n_groups": st.n_groups,
        "tokens_per_s": res["tokens_per_s"],
        "per_tier": st.per_tier(),
    }


def _sharing_ab(cfg, device) -> tuple[list, bool, bool]:
    rows, bitwise_ok, ratio_ok = [], True, True
    for kind in ("pinned_host", "disk_host"):
        gens = {}
        for sharing in (True, False):
            with _engine(device) as engine:
                res = sv.serve(cfg, batch=SLOTS, prompt_len=PROMPT, gen=GEN, kv_kind=kind,
                               kv_page_len=PAGE_LEN, hot_pages=1, seed=0,
                               shared_prefix_len=SHARED_PREFIX, prefix_sharing=sharing,
                               engine=engine, warmup=False, device=device)
            gens[sharing] = res["generated"]
            rows.append(_ab_row(kind, sharing, res))
        on = next(r for r in rows if r["kv_kind"] == kind and r["prefix_sharing"])
        off = next(r for r in rows if r["kv_kind"] == kind and not r["prefix_sharing"])
        bitwise_ok &= bool(np.array_equal(gens[True], gens[False]))
        # >= 2x fewer unique cold-page fetches, and >= 2x fewer disk
        # requests at the disk tier
        ratio_ok &= on["unique_group_fetches"] * 2 <= off["unique_group_fetches"]
        if kind == "disk_host":
            ratio_ok &= on["disk_requests"] * 2 <= off["disk_requests"]
    return rows, bitwise_ok, ratio_ok


def _slo_trace() -> LoadGenConfig:
    return LoadGenConfig(
        seed=7,
        phases=(
            Phase(duration_s=3.0, rate_rps=3.0),
            Phase(duration_s=1.0, rate_rps=10.0),
            Phase(duration_s=3.0, rate_rps=3.0),
        ),
        prompt_lens=(12, 24, 40),
        prompt_mix=(0.4, 0.3, 0.3),
        gen_lens=(4, 8),
        gen_mix=(0.6, 0.4),
        shared_prefix_len=SHARED_PREFIX,
        shared_frac=0.75,
        vocab_size=256,
    )


def _slo_run(cfg, device) -> dict:
    with _engine(device) as engine:
        with sv.ServeSession(cfg, slots=SLOTS, max_len=PROMPT + 16, kv_kind="disk_host",
                             page_len=PAGE_LEN, hot_pages=1, seed=0, engine=engine,
                             device=device) as session:
            sched = SLOScheduler(session, generate(_slo_trace()),
                                 slo=SLO(ttft_s=0.25, tpot_s=0.05), max_queue=16,
                                 virtual_step_s=0.01)
            return sched.run()


def run(device, tag: str = "BENCH_serve_slo") -> list[dict]:
    cfg = get_smoke_config("smollm-360m")

    rows, bitwise_ok, ratio_ok = _sharing_ab(cfg, device)
    C.print_table(
        f"COW prefix sharing A/B (shared 32-token system prompt, {device})",
        rows,
        ["kv_kind", "prefix_sharing", "unique_group_fetches", "disk_requests", "d2h_requests",
         "shared_hits", "shared_skipped_writebacks"],
    )

    rep1 = _slo_run(cfg, device)
    rep2 = _slo_run(cfg, device)  # same seed, fresh session: must reproduce
    det_fields = (
        "offered", "submitted", "completed", "rejected_oversize",
        "rejected_overload", "emitted_tokens", "n_steps", "makespan_s",
        "slo_attainment", "goodput_rps", "goodput_tokens_per_s",
        "shared_hits", "unique_group_fetches", "disk_requests",
    )
    deterministic = all(rep1[f] == rep2[f] for f in det_fields) and (
        rep1["ttft_s"] == rep2["ttft_s"] and rep1["tpot_s"] == rep2["tpot_s"]
    )
    report_ok = (
        0.0 <= rep1["slo_attainment"] <= 1.0
        and rep1["goodput_tokens_per_s"] >= 0.0
        and {"h2d", "d2h", "disk"} <= set(rep1["per_tier"])
        and rep1["completed"] <= rep1["submitted"]
    )
    slo_row = {
        "kv_kind": "disk_host",
        "suite": "slo_loadgen",
        **{k: rep1[k] for k in det_fields + ("ttft_s", "tpot_s", "per_tier", "prefill_compiles",
                                               "shared_skipped_writebacks")},
        "deterministic": deterministic,
    }
    C.print_table(
        f"open-loop SLO run (virtual clock, disk tier, {device})",
        [slo_row],
        ["offered", "completed", "rejected_overload", "slo_attainment", "goodput_rps",
         "goodput_tokens_per_s", "n_steps", "prefill_compiles", "shared_hits", "deterministic"],
    )

    rows.append(slo_row)
    rows.append({"suite": "gates", "bitwise_ok": bitwise_ok, "ratio_ok": ratio_ok,
                 "report_ok": report_ok, "deterministic": deterministic})
    C.save_rows(tag, rows)
    return rows


def main(device: DeviceLike = None) -> int:
    rows = run(resolve_device(device))
    gates = rows[-1]
    by = {(r["kv_kind"], r["prefix_sharing"]): r for r in rows if "prefix_sharing" in r}
    disk_on, disk_off = by[("disk_host", True)], by[("disk_host", False)]
    ratio = disk_off["unique_group_fetches"] / max(1, disk_on["unique_group_fetches"])
    print(
        f"sharing: {disk_on['unique_group_fetches']} vs "
        f"{disk_off['unique_group_fetches']} unique fetches "
        f"({ratio:.1f}x, gate >= 2x), "
        f"{disk_on['disk_requests']} vs {disk_off['disk_requests']} disk req; "
        f"bitwise={gates['bitwise_ok']}, report_ok={gates['report_ok']}, "
        f"deterministic={gates['deterministic']}"
    )
    ok = gates["bitwise_ok"] and gates["ratio_ok"] and gates["report_ok"] and gates["deterministic"]
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    sys.exit(main(ap.parse_args().device))
