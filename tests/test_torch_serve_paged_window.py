"""The paged-serving prefetch window held against the JAX package's.

``benchmarks/serve_paged.py``'s smoke trace (smollm-360m, 2 requests, a
96-token prompt, 32 generated, 32-token pages, cold pages at pinned host)
through both packages' ``serve`` with a transfer engine whose link runs on a
virtual clock: a fetch holds one serial link from when it is submitted (or
the link frees) for the benchmark's modeled occupancy, waiting on it moves
the clock to its end, and each decode step's compute moves it by a fixed
time.  So the waits are a function of the schedule alone, not of either
host: each request's ``auto`` window (``distance_trace``), each popped page
group's wait and the groups a step must be the JAX package's, step for step.

The port's wall-clock fault this guards lay under the schedule: the engine's
link emulation yielded the GIL in ``sleep(0)`` steps, each of which the eager
compute thread could hold for up to the 5 ms switch interval, so an emulated
0.45 ms transfer took ~2 ms while a step computed and the groups a window
put in flight landed only after it.  ``test_precise_sleep_takes_the_gil_back_once``
pins the repair.
"""
import time

import pytest
import torch

from benchmarks import serve_paged as jax_bench
from repro.configs import get_smoke_config as jax_smoke
from repro.core import engine as jax_engine
from repro.core import kvpager as jax_kvpager
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_local_mesh
from repro_torch.benchmarks import serve_paged as bench
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.core import kvpager
from repro_torch.core.refspec import AUTO
from repro_torch.launch import serve as sv

#: the decode step's compute on the virtual clock: longer than one page
#: group's link time (~0.43 ms), shorter than the four a step pops
STEP_S = 1.0e-3


class _Clock:
    def __init__(self, link):
        self.link, self.now, self.free = link, 0.0, 0.0


class _VirtualFuture:
    """A transfer future whose wait is read off the virtual clock."""

    def __init__(self, fut, clock, end):
        self._fut, self._clock, self._end = fut, clock, end

    def wait(self) -> float:
        self._fut.wait()  # the real transfer, on the engine's worker
        w = max(0.0, self._end - self._clock.now)
        self._clock.now += w
        return w

    def __getattr__(self, name):
        return getattr(self._fut, name)


def _virtual_engine(pkg_engine, clock, **kw):
    class VirtualLinkEngine(pkg_engine.TransferEngine):
        def submit_group(self, index, group, **skw):
            fut = super().submit_group(index, group, **skw)
            start = max(clock.now, clock.free)
            clock.free = start + clock.link.occupancy_s(fut.n_requests, fut.nbytes)
            return _VirtualFuture(fut, clock, clock.free + clock.link.latency_s)

    return VirtualLinkEngine(pkg_engine.EngineConfig(), **kw)


def _compute_advances(monkeypatch, pager_cls, clock):
    """Each decode step's compute moves the clock (the pager cuts the step's
    pages out right after it)."""
    real = pager_cls.update_current

    def update_current(self, new_cache):
        clock.now += STEP_S
        return real(self, new_cache)

    monkeypatch.setattr(pager_cls, "update_current", update_current)


def _trace(res) -> dict:
    st = res["stats"]
    per_step = len(st.wait_per_group) // max(res["n_steps"], 1)
    return {"distance_trace": list(st.distance_trace),
            "wait_per_group": [round(w, 12) for w in st.wait_per_group],
            "step_waits": [round(w, 12) for w in res["step_waits"]],
            "groups_a_step": per_step, "h2d_requests": st.h2d_requests, "n_groups": st.n_groups,
            "bytes_h2d": st.bytes_h2d}


@pytest.fixture(scope="module")
def jax_traces():
    """The JAX package's serve of the benchmark's trace on the virtual link,
    at distance 1 and auto."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for dist in (1, AUTO):
            clock = _Clock(jax_bench.HOST_LINK)
            _compute_advances(mp, jax_kvpager.KVPager, clock)
            eng = _virtual_engine(jax_engine, clock)
            try:
                res = jax_serve.serve(jax_smoke("smollm-360m"), make_local_mesh(),
                                      batch=bench.BATCH, prompt_len=bench.PROMPT, gen=bench.GEN,
                                      seed=0, kv_kind="pinned_host", kv_page_len=bench.PAGE_LEN,
                                      distance=dist, engine=eng)
            finally:
                eng.close()
            out[dist] = _trace(res)
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("dist", [1, AUTO], ids=["d1", "auto"])
def test_prefetch_window_and_waits_follow_jax(monkeypatch, jax_traces, dist):
    """Each request's window, each page group's wait and the groups a step
    equal the JAX package's on the same trace and link, and every request
    and byte count.  (The tokens differ: each package draws its own weights
    from the seed.)"""
    clock = _Clock(bench.HOST_LINK)
    _compute_advances(monkeypatch, kvpager.KVPager, clock)
    dev = torch.device("cpu")
    with _virtual_engine(engine, clock, device=dev) as eng:
        res = sv.serve(get_smoke_config("smollm-360m"), batch=bench.BATCH,
                       prompt_len=bench.PROMPT, gen=bench.GEN, seed=0, device=dev,
                       kv_kind="pinned_host", kv_page_len=bench.PAGE_LEN, distance=dist,
                       engine=eng)
    ours, theirs = _trace(res), jax_traces[dist]
    assert ours == theirs
    assert ours["groups_a_step"] == 4 and ours["h2d_requests"] == ours["n_groups"]


def test_auto_window_waits_no_longer_than_d1_on_the_virtual_link(jax_traces):
    """On the modeled link the adaptive window's steady per-step wait is at
    most the fixed minimal window's (the suite's gate, host-free)."""
    tail = {d: bench._tail(t["step_waits"]) for d, t in jax_traces.items()}
    assert tail[AUTO] <= tail[1]
    assert max(jax_traces[AUTO]["distance_trace"]) > 1


def test_precise_sleep_takes_the_gil_back_once(monkeypatch):
    """The link emulation's wait is one ``time.sleep`` up to a ~0.1 ms tail
    of ``sleep(0)`` yields, where the JAX package yields for its last 1.5 ms:
    the port's compute thread runs eager ops that hold the GIL between
    them, so each yield could stall the engine's worker."""
    calls = []
    real = time.sleep

    def sleep(s):
        calls.append(s)
        real(s)

    monkeypatch.setattr(engine.time, "sleep", sleep)
    t0 = time.perf_counter()
    engine._sleep_precise(450e-6)
    took = time.perf_counter() - t0
    assert took >= 450e-6
    assert calls[0] > 0 and abs(calls[0] - (450e-6 - engine._SPIN_TAIL_S)) < 50e-6
    assert all(s == 0 for s in calls[1:])
