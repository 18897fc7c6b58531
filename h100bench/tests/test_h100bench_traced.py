"""A traced run on the CPU, with a stand-in profiler: the end-to-end window
runs untraced, the device's metrics come from the traced window that
follows it, and the host's metrics from the untraced one."""
import time

import pytest

from h100bench.harness import runner, trace
from conftest import smoke_cell


class FakeTracer:
    """Reports one 'flash_attention_kernel' event of 1 ms every 10 ms while
    it is on, stamped in unix-epoch nanoseconds as the profiler's are."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        return False

    def device_events(self):
        step = 10_000_000
        return [("flash_attention_kernel", t, t + step // 10)
                for t in range(self.t0, self.t1, step)]


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(trace, "available", lambda device: True)
    monkeypatch.setattr(trace, "Tracer", FakeTracer)


def test_a_traced_run_reads_the_device_from_a_second_window(traced):
    cell = smoke_cell("internlm2-20b.chat")
    seconds = 1.5
    res = runner.run(cell, 2**33 + 9, seconds, True, time.perf_counter(), device="cpu")
    assert res.correct, res.checks
    assert res.device["window_s"] == pytest.approx(min(seconds, runner.TRACE_S))
    # one 1 ms event every 10 ms: the card is busy a tenth of the window
    assert res.device["busy_s"] == pytest.approx(0.1 * res.device["window_s"], rel=0.2)
    assert res.metrics["idle_share.chat"]["value"] == pytest.approx(90.0, abs=2.0)
    assert 0 < res.metrics["flash_roofline.chat"]["value"]
    # the host's metrics are the untraced window's
    for name in ("step_ms_p50.chat", "prefill_ms_p50.chat", "queue_wait_p50_ms.chat"):
        assert res.metrics[name]["value"] > 0
    assert res.breakdown["device_ops"][0][0] == "flash_attention_kernel"
    assert len(res.breakdown["idle_gaps"]) <= 10
