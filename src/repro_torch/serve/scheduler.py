"""Admission-controlled SLO scheduler over a :class:`ServeSession`.

A copy of the JAX package's ``repro.serve.scheduler`` (numpy only), with the
same names, so that a report compares field by field.

The serving loop treats device residency the way the paper's host-side
scheduler treats Epiphany SRAM: a shared, contended resource.  Offered
requests (an arrival-stamped trace from :mod:`repro_torch.serve.loadgen`) flow
through a bounded admission queue into the session's continuous batch;
anything beyond the queue bound is shed (``rejected_overload``), anything
that cannot ever fit is rejected by the session itself
(``rejected_oversize``), and every completed request is scored against its
latency SLOs:

``TTFT``  time from arrival to the first emitted token (prompt queueing +
          prefill), and
``TPOT``  mean time per output token after the first (decode cadence).

**Goodput under SLO** — the headline metric — counts only requests that met
*both* targets: ``goodput_rps`` (SLO-attaining requests per second of
makespan) and ``goodput_tokens_per_s`` (their tokens).  Throughput that
arrives too late to be useful does not count; this is the difference
between a server that is fast and a server that is merely busy.

Two clocks: ``virtual_step_s`` advances time a fixed amount per decode
step (fully deterministic — what the tests and bench gates run), or wall
clock (``virtual_step_s=None``) for real measurements.  Under the wall
clock a token is stamped when the step that emitted it has returned; the
JAX package stamps it with the clock read before that step, which leaves
the step's own time out of TTFT and TPOT.  Under the virtual clock both
stamp the step's end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

__all__ = ["SLO", "SLOScheduler"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets."""

    ttft_s: float = 0.5
    tpot_s: float = 0.1


@dataclasses.dataclass
class _Tracked:
    """Per-admitted-request latency bookkeeping."""

    arrival_s: float
    shared: bool
    first_emit_s: Optional[float] = None
    last_emit_s: Optional[float] = None
    n_emitted: int = 0


class SLOScheduler:
    """Drives one session over one offered trace; collects the SLO report.

    ``max_queue`` bounds the admission queue (arrived-but-not-admitted
    requests); arrivals beyond it are shed instead of growing an unbounded
    backlog — open-loop overload must degrade goodput, not crash the
    server.
    """

    def __init__(
        self,
        session,
        offered,
        *,
        slo: Optional[SLO] = None,
        max_queue: int = 32,
        virtual_step_s: Optional[float] = 0.01,
    ) -> None:
        self.session = session
        self.offered = sorted(offered, key=lambda o: o.arrival_s)
        self.slo = slo or SLO()
        self.max_queue = max_queue
        self.virtual_step_s = virtual_step_s
        self.rejected_overload = 0
        self.tracked: dict[int, _Tracked] = {}

    def run(self) -> dict[str, Any]:
        session = self.session
        virtual = self.virtual_step_s is not None
        t0 = time.perf_counter()
        now = 0.0
        i = 0  # next offered arrival
        n = len(self.offered)

        def record(emitted: dict, at: float) -> None:
            for rid, _tok in emitted.items():
                tr = self.tracked.get(rid)
                if tr is None:
                    continue
                if tr.first_emit_s is None:
                    tr.first_emit_s = at
                tr.last_emit_s = at
                tr.n_emitted += 1

        while True:
            if not virtual:
                now = time.perf_counter() - t0
            # arrivals up to the current clock enter the admission queue;
            # the queue bound is the admission-control knob — overflow is
            # shed, not buffered forever
            while i < n and self.offered[i].arrival_s <= now:
                o = self.offered[i]
                i += 1
                if len(session.queue) >= self.max_queue:
                    self.rejected_overload += 1
                    continue
                rid = session.submit(o.prompt, o.gen)
                if rid is None:  # oversize: counted by session.rejected
                    continue
                self.tracked[rid] = _Tracked(
                    arrival_s=o.arrival_s, shared=o.shared
                )
            if session.pending_work():
                emitted = session.step()
                # a token is stamped when its step is over: at the virtual
                # step's end, or on the wall clock read after the step
                # (which waits for the card as it reads the tokens)
                if virtual:
                    now += self.virtual_step_s
                else:
                    now = time.perf_counter() - t0
                record(emitted, now)
            elif i < n:
                # idle: jump the clock to the next arrival (virtual) or
                # spin the wall clock forward
                if virtual:
                    now = self.offered[i].arrival_s
                else:
                    now = time.perf_counter() - t0
                    if now < self.offered[i].arrival_s:
                        time.sleep(
                            min(self.offered[i].arrival_s - now, 0.01)
                        )
            else:
                break
        makespan = now if virtual else time.perf_counter() - t0
        return self.report(makespan)

    # -- scoring ------------------------------------------------------------
    def _latencies(self) -> tuple[list, list, list]:
        """(ttft, tpot, met) over completed requests, rid order."""
        ttfts, tpots, met = [], [], []
        for rid, tr in sorted(self.tracked.items()):
            if tr.first_emit_s is None:
                continue
            ttft = tr.first_emit_s - tr.arrival_s
            if tr.n_emitted > 1:
                tpot = (tr.last_emit_s - tr.first_emit_s) / (tr.n_emitted - 1)
            else:
                tpot = 0.0
            ttfts.append(ttft)
            tpots.append(tpot)
            met.append(ttft <= self.slo.ttft_s and tpot <= self.slo.tpot_s)
        return ttfts, tpots, met

    @staticmethod
    def _pcts(xs: list) -> dict[str, float]:
        if not xs:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
        a = np.asarray(xs, np.float64)
        return {
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
        }

    def report(self, makespan_s: float) -> dict[str, Any]:
        session = self.session
        ttfts, tpots, met = self._latencies()
        good = [
            tr
            for ok, (rid, tr) in zip(met, sorted(self.tracked.items()))
            if ok
        ]
        good_tokens = sum(tr.n_emitted for tr in good)
        completed = len(ttfts)
        return {
            "offered": len(self.offered),
            "submitted": len(self.tracked),
            "completed": completed,
            "rejected_oversize": session.rejected,
            "rejected_overload": self.rejected_overload,
            "shared_offered": sum(
                1 for tr in self.tracked.values() if tr.shared
            ),
            "makespan_s": makespan_s,
            "ttft_s": self._pcts(ttfts),
            "tpot_s": self._pcts(tpots),
            "slo": dataclasses.asdict(self.slo),
            "slo_attainment": (sum(met) / completed) if completed else 0.0,
            "goodput_rps": (len(good) / makespan_s) if makespan_s else 0.0,
            "goodput_tokens_per_s": (
                good_tokens / makespan_s if makespan_s else 0.0
            ),
            "emitted_tokens": sum(
                tr.n_emitted for tr in self.tracked.values()
            ),
            "n_steps": session.n_steps,
            "prefill_compiles": session.prefill_compiles(),
            "shared_hits": session.stats.shared_hits,
            "shared_skipped_writebacks": (
                session.pager.shared_skipped_writebacks
            ),
            "unique_group_fetches": session.stats.unique_group_fetches,
            "disk_requests": session.stats.disk_requests,
            "per_tier": session.stats.per_tier(),
        }
