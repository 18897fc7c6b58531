"""Arithmetic over one window's stamps: percentiles over all samples and
rates over the whole window.  No medians of chunks."""
from __future__ import annotations

import math
from typing import Optional


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    r = (len(xs) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def in_window(window) -> list:
    """The requests the window offered (due inside it) or served (a token
    inside it)."""
    end = window.seconds
    return [s for s in window.served
            if 0.0 <= s.due_s < end or any(0.0 <= t <= end for t in s.token_s)]


def tokens_in_window(window) -> int:
    """Output tokens emitted inside the window (first tokens included)."""
    return sum(1 for s in window.served for t in s.token_s if 0.0 <= t <= window.seconds)


def token_gaps(window) -> list:
    """Every gap between consecutive tokens of a request that ends inside
    the window and starts inside it, and for every request still decoding
    at the window's end, the open gap from its last token to the end (a
    stall at the end shows)."""
    end = window.seconds
    out = []
    for s in window.served:
        ts = s.token_s
        for a, b in zip(ts, ts[1:]):
            if a >= 0.0 and b <= end:
                out.append(b - a)
        inside = [t for t in ts if t <= end]
        if inside and inside[-1] >= 0.0 and len(inside) < s.gen:
            out.append(end - inside[-1])
    return out


def ttfts(window) -> list:
    """Time to first token of every request due inside the window, from
    when it was due; one not served by the window's end counts at its age
    then."""
    end = window.seconds
    out = []
    for s in window.served:
        if not 0.0 <= s.due_s < end:
            continue
        first = s.token_s[0] if s.token_s else math.inf
        out.append(min(first, end) - s.due_s)
    return out


def queue_waits(window) -> list:
    """From due time to the start of the request's prefill, for requests
    admitted inside the window."""
    return [s.prefill_start_s - s.due_s for s in window.served
            if s.prefill_start_s is not None and 0.0 <= s.prefill_start_s <= window.seconds
            and s.due_s >= 0.0]


def step_walls(window) -> list:
    return [b - a for a, b, _ in window.steps if b <= window.seconds]


def prefill_walls(window) -> list:
    return [b - a for a, b, _ in window.admissions if b <= window.seconds]
