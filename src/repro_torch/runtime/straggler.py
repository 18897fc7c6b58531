"""Straggler detection + step watchdog.

On a pod, a straggling host shows up as a slowly-creeping step time (its
collectives gate everyone).  The monitor keeps a rolling window of step
durations; a step exceeding ``z_threshold`` robust z-scores (median/MAD) is
flagged, and ``deadline_s`` bounds any single step (hang detection) — the
driver's restart loop treats a tripped deadline as a node failure and
restarts from the last checkpoint.

The JAX package's ``runtime/straggler.py`` as it is: the monitor touches no
framework.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    z: float


class StragglerMonitor:
    def __init__(
        self,
        *,
        window: int = 50,
        z_threshold: float = 6.0,
        deadline_s: Optional[float] = None,
        on_event: Optional[Callable[[StragglerEvent], None]] = None,
    ) -> None:
        self.window: deque[float] = deque(maxlen=window)
        self.z_threshold = z_threshold
        self.deadline_s = deadline_s
        #: called with each flagged event — the driver wires this to
        #: ``TransferEngine.widen`` so a straggling step buys the stream
        #: more prefetch headroom instead of just a log line
        self.on_event = on_event
        self.events: list[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def check_deadline(self) -> bool:
        """True if the in-flight step blew its deadline (hang)."""
        if self._t0 is None or self.deadline_s is None:
            return False
        return (time.perf_counter() - self._t0) > self.deadline_s

    def end_step(self) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "end_step without start_step"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        ev = None
        if len(self.window) >= 8:
            med = statistics.median(self.window)
            mad = statistics.median(abs(x - med) for x in self.window)
            # floor the MAD at 1% of the median: a window of near-identical
            # step times has MAD ~ 0, and the raw z-score then flags
            # microsecond jitter as a straggler (found by the unit sweep)
            mad = max(mad, 0.01 * med, 1e-9)
            z = 0.6745 * (dt - med) / mad
            if z > self.z_threshold:
                ev = StragglerEvent(self._step, dt, med, z)
                self.events.append(ev)
                if self.on_event is not None:
                    self.on_event(ev)
        self.window.append(dt)
        return ev
