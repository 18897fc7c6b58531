"""The device trace of a ``--trace 1`` window: ``torch.profiler`` over the
card's activity alone (no host operators, so the host's loop is not slowed
by their recording), read once the window has closed.

Device events carry unix-epoch nanoseconds, as ``time.time_ns`` does, so
the idle gaps between them are put beside what the harness's loop was
doing then (a step, a prefill, or the loop between calls).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: dict  # kernel or copy name -> seconds inside the window
    gaps: list  # (seconds, start_ns) of idle intervals, longest first

    def seconds_of(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of ``parts``."""
        return sum(v for k, v in self.by_name.items() if any(p in k for p in parts))


def available(device) -> bool:
    """Whether the profiler traces ``device``'s operations (a CUDA card)."""
    return torch.device(device).type == "cuda"


class Tracer:
    """``with Tracer(on): ...`` profiles the card while ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def device_events(self) -> list:
        """``(name, start_ns, end_ns)`` of every operation that ran on the card."""
        if self.prof is None:
            return []
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
                continue
            d = e.duration_ns()
            if d > 0:
                out.append((e.name(), e.start_ns(), e.start_ns() + d))
        return out


def summarize(events: list, t0_ns: int, t1_ns: int) -> Optional[Summary]:
    """Busy time (the union of the events' intervals), time by name and the
    idle gaps, all clipped to ``[t0_ns, t1_ns]``."""
    if not events:
        return None
    by_name: dict = collections.defaultdict(float)
    spans = []
    for name, a, b in events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        by_name[name] += (b - a) / 1e9
        spans.append((a, b))
    spans.sort()
    busy = 0
    gaps = []
    cur_a, cur_b = None, t0_ns
    for a, b in spans:
        if a > cur_b:
            gaps.append(((a - cur_b) / 1e9, cur_b))
            if cur_a is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_a = a if cur_a is None else cur_a
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if t1_ns > cur_b:
        gaps.append(((t1_ns - cur_b) / 1e9, cur_b))
    gaps.sort(reverse=True)
    return Summary((t1_ns - t0_ns) / 1e9, busy / 1e9, dict(by_name), gaps)


def host_activity(window, t_ns: int) -> str:
    """What the loop was doing at ``t_ns``: in a step, in a prefill, or
    between calls."""
    t = (t_ns / 1e9) - window.start_wall
    for a, b, _ in window.admissions:
        if a <= t <= b:
            return "prefill"
    for a, b, _ in window.steps:
        if a <= t <= b:
            return "step"
    return "between calls"


def breakdown(summary: Summary, window, top: int = 10) -> dict:
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [[host_activity(window, start + int(sec * 5e8)), sec]
            for sec, start in summary.gaps[:top]]
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": gaps}
