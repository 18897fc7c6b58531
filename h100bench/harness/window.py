"""The measured window: a server's loop over one ``ServeSession``.

The loop submits each request when it is due (open loop) or when a slot
frees (closed loop), from the set-up's priming on (the traffic runs for a
while before the window opens, so the window sees the cell's load and not
the fill of an empty session), admits it into a free slot at once (``submit`` then
``admit_pending``: one prefill, its first token), and otherwise runs
``step`` over the active slots.  Every token is stamped when the call that
produced it returns; each call ends in the session's host sync of the
tokens, and an admission is followed by a synchronize so that its page
copies are charged to it and not to the next step.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Served:
    """One request as the window saw it (times from the window's start)."""

    index: int
    prompt_len: int
    gen: int
    due_s: float  # when it was due (a closed loop: when its slot freed)
    rid: Optional[int] = None
    prefill_start_s: Optional[float] = None
    prefill_end_s: Optional[float] = None
    token_s: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    rejected: bool = False

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.gen


@dataclasses.dataclass
class Window:
    """What one window recorded."""

    seconds: float
    served: list  # Served, in order of offer
    steps: list  # (start_s, end_s, lengths of the active slots before the step)
    admissions: list  # (start_s, end_s, prompt_len)
    gen_lag_s: list  # how late each open-loop request due in it was offered
    start_wall: float = 0.0  # time.time() at the window's start


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """One session's calls, stamped on ``clock`` (seconds); a ``Driver``
    decides what to call when."""

    def __init__(self, session, device, clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.session = session
        self.device = device
        self.clock = clock
        self.sleep = sleep
        self.t0 = clock()
        self.by_rid: dict = {}
        self.steps: list = []
        self.admissions: list = []

    def now(self) -> float:
        return self.clock() - self.t0

    def admit(self, req, due_s: float) -> "Served":
        s = Served(req.index, len(req.prompt), req.gen, due_s)
        s.rid = self.session.submit(req.prompt, req.gen)
        if s.rid is None:
            s.rejected = True
            return s
        s.prefill_start_s = self.now()
        emitted = self.session.admit_pending()
        _sync(self.device)
        s.prefill_end_s = self.now()
        self.admissions.append((s.prefill_start_s, s.prefill_end_s, s.prompt_len))
        self.by_rid[s.rid] = s
        self._stamp(emitted, s.prefill_end_s)
        return s

    def step(self) -> list:
        """One decode step; returns the requests that finished in it."""
        lengths = [len(self.by_rid[r].tokens) + self.by_rid[r].prompt_len
                   for r in self.session.active]
        t0 = self.now()
        emitted = self.session.step()
        t1 = self.now()
        self.steps.append((t0, t1, lengths))
        return self._stamp(emitted, t1)

    def _stamp(self, emitted: dict, t: float) -> list:
        finished = []
        for rid, tok in emitted.items():
            s = self.by_rid.get(rid)
            if s is None:
                continue
            s.tokens.append(int(tok))
            s.token_s.append(t)
            if s.done:
                finished.append(s)
        return finished

    def free_slots(self) -> int:
        return self.session.slots - len(self.session.active)


class Driver:
    """Feeds one session from ``reqs`` on the loop's clock, which reads
    ``start`` now: a negative start runs the traffic before the window (its
    set-up), so the window opens on a session already under its load.

    Open loop: each request is offered at its due time and admitted into a
    free slot in order of arrival; the loop steps while any slot is active
    and sleeps until the next arrival otherwise.  A request's clock starts
    when it was due, not when the loop got to it.  Closed loop: a freed slot
    takes the pool's next request at once (due then); the pool starts over
    when it runs out."""

    def __init__(self, loop: Loop, reqs: list, closed: bool, start: float = 0.0):
        loop.t0 = loop.clock() - start
        self.loop, self.reqs, self.closed = loop, reqs, closed
        self.served: list = []
        self.pending: collections.deque = collections.deque()
        self.i = 0
        self.lag: list = []  # (due_s, how late the loop offered it)

    def run_until(self, end: float) -> None:
        loop, reqs = self.loop, self.reqs
        while loop.now() < end:
            if self.closed:
                while loop.free_slots() > 0 and loop.now() < end:
                    self.served.append(loop.admit(reqs[self.i % len(reqs)], loop.now()))
                    self.i += 1
                if not loop.session.active:
                    return
                loop.step()
                continue
            now = loop.now()
            while self.i < len(reqs) and reqs[self.i].due_s <= now:
                self.lag.append((reqs[self.i].due_s, now - reqs[self.i].due_s))
                self.pending.append(reqs[self.i])
                self.i += 1
            while self.pending and loop.free_slots() > 0 and loop.now() < end:
                r = self.pending.popleft()
                self.served.append(loop.admit(r, r.due_s))
            if loop.session.active:
                loop.step()
            elif not self.pending:
                nxt = reqs[self.i].due_s if self.i < len(reqs) else end
                loop.sleep(max(0.0, min(nxt, end) - loop.now()))

    def window(self, start: float, seconds: float) -> Window:
        """What the loop recorded from ``start`` for ``seconds``, as it
        stands now, on a clock that reads 0 at ``start``.  Requests due in it
        but never admitted count with no token; requests admitted before it
        keep their earlier (negative) stamps."""
        end = start + seconds
        served = [_shifted(s, start) for s in self.served if s.due_s < end]
        if not self.closed:
            waiting = list(self.pending) + list(self.reqs[self.i:])
            served += [Served(r.index, len(r.prompt), r.gen, r.due_s - start)
                       for r in waiting if r.due_s < end]
        loop = self.loop
        steps = [(a - start, b - start, n) for a, b, n in loop.steps if a >= start]
        adm = [(a - start, b - start, n) for a, b, n in loop.admissions if a >= start]
        lag = [g for d, g in self.lag if start <= d < end]
        return Window(seconds, served, steps, adm, lag, time.time() - (loop.now() - start))


def _shifted(s: Served, d: float) -> Served:
    """A copy of ``s`` on a clock ``d`` seconds later."""
    def sh(t):
        return None if t is None else t - d
    return dataclasses.replace(s, due_s=s.due_s - d, prefill_start_s=sh(s.prefill_start_s),
                               prefill_end_s=sh(s.prefill_end_s),
                               token_s=[t - d for t in s.token_s], tokens=list(s.tokens))


def run(loop: Loop, reqs: list, seconds: float, closed: bool, start: float = 0.0) -> Window:
    """Run the traffic from ``start`` (set-up) and return the window
    ``[0, seconds)``."""
    d = Driver(loop, reqs, closed, start)
    d.run_until(seconds)
    return d.window(0.0, seconds)
