"""The harness's arithmetic on synthetic timestamps: percentiles over all
samples, rates over the whole window, the open loop's due-time clock, the
traffic generator's arithmetic, and a stall that has to show."""
import numpy as np
import pytest

from h100bench.harness import stats, traffic, window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class FakeSession:
    """A session whose prefill and step take fixed times on ``clock``; a
    step at ``stall_at`` (window seconds) takes ``stall`` more."""

    def __init__(self, clock, slots=4, prefill=0.05, step=0.02, stall_at=None, stall=0.0):
        self.clock, self.slots = clock, slots
        self.prefill, self.step_s = prefill, step
        self.stall_at, self.stall = stall_at, stall
        self.active, self.queue, self.left = {}, [], {}
        self.next = 0
        self.t0 = None

    def submit(self, prompt, gen):
        rid = self.next
        self.next += 1
        self.queue.append((rid, gen))
        return rid

    def admit_pending(self):
        out = {}
        while self.queue and len(self.active) < self.slots:
            rid, gen = self.queue.pop(0)
            self.clock.t += self.prefill
            self.active[rid] = len(self.active)
            self.left[rid] = gen - 1
            out[rid] = 1
            if self.left[rid] == 0:
                del self.active[rid]
        return out

    def step(self):
        self.clock.t += self.step_s
        if self.stall_at is not None and self.clock.t >= self.stall_at:
            self.clock.t += self.stall
            self.stall_at = None
        out = {}
        for rid in list(self.active):
            out[rid] = 2
            self.left[rid] -= 1
            if self.left[rid] == 0:
                del self.active[rid]
        return out


def _open(seconds=20.0, rate=8.0, **kw):
    clock = Clock()
    spec = {"loop": "open", "slots": 4, "prompt_len": [8, 64], "output_len": [2, 4],
            "phases": [{"share": 1.0, "rate_rps": rate}]}
    reqs = traffic.generate(spec, 5, seconds, 100)
    session = FakeSession(clock, **kw)
    loop = window.Loop(session, "cpu", clock=clock, sleep=clock.sleep)
    return window.run(loop, reqs, seconds, False)


def _primed(prime_s=5.0, seconds=10.0, after=0.0, rate=8.0):
    clock = Clock()
    spec = {"loop": "open", "slots": 8, "prompt_len": [8, 64], "output_len": [20, 40],
            "phases": [{"share": 1.0, "rate_rps": rate}], "prime_s": prime_s}
    reqs, start = traffic.timeline(spec, 9, seconds, 100, after=after)
    loop = window.Loop(FakeSession(clock, slots=8), "cpu", clock=clock, sleep=clock.sleep)
    return window.Driver(loop, reqs, False, start), reqs, start


def test_percentile_interpolates_over_all_samples():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    xs = list(range(1, 11))
    assert stats.percentile(xs, 50) == 5.5
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(list(reversed(xs)), 90) == pytest.approx(9.1)


def test_open_loop_times_requests_from_their_due_time():
    w = _open()
    assert w.served and all(s.due_s >= 0 for s in w.served)
    # every request the loop reached was admitted no earlier than it was due
    for s in w.served:
        if s.prefill_start_s is not None:
            assert s.prefill_start_s >= s.due_s - 1e-9
            assert s.token_s[0] >= s.due_s + 0.05 - 1e-9
    t = stats.ttfts(w)
    assert len(t) == len(w.served) and min(t) >= 0.05 - 1e-9


def test_rate_is_over_the_whole_window():
    w = _open()
    n = sum(1 for s in w.served for t in s.token_s if 0 <= t <= w.seconds)
    assert stats.tokens_in_window(w) == n
    # 160 requests of 2-4 tokens offered over 20 s, all served
    assert 2 * 160 <= n <= 4 * 160


def test_one_stall_moves_both_tails():
    calm = _open()
    stalled = _open(stall_at=8.0, stall=4.0)
    # a 4 s stall: the requests due in it wait, and the queue it leaves
    # drains by prefills between the steps, so the gaps widen too
    assert stats.percentile(stats.ttfts(stalled), 90) > 10 * stats.percentile(stats.ttfts(calm), 90)
    assert (stats.percentile(stats.token_gaps(stalled), 90)
            > 1.5 * stats.percentile(stats.token_gaps(calm), 90))


def test_a_stall_at_the_end_counts_at_its_age():
    w = _open(stall_at=18.0, stall=10.0)
    # requests in flight when the window closes count their open gap
    assert max(stats.token_gaps(w)) >= 1.5
    assert max(stats.ttfts(w)) >= 1.5


def test_closed_loop_keeps_every_slot_busy():
    clock = Clock()
    spec = {"loop": "closed", "slots": 4, "pool": 40, "prompt_len": [8, 64],
            "output_len": [3, 9], "prime_s": 0.5}
    reqs, start = traffic.timeline(spec, 11, 3.0, 100)
    loop = window.Loop(FakeSession(clock), "cpu", clock=clock, sleep=clock.sleep)
    w = window.run(loop, reqs, 3.0, True, start)
    primed = [s for s in w.served if s.due_s < 0]
    assert len(primed) >= 4  # the slots were filled in the set-up
    assert all(s.prefill_start_s < 0 for s in primed)  # admitted in the set-up
    assert all(a >= 0 for a, _, _ in w.steps)
    assert all(len(lengths) == 4 for _, _, lengths in w.steps[:-1])
    assert len(w.admissions) >= 4


def test_priming_opens_the_window_under_load():
    drv, reqs, start = _primed()
    assert start == -5.0
    drv.run_until(0.0)
    assert drv.loop.now() >= 0.0 and len(drv.loop.session.active) >= 4
    drv.run_until(10.0)
    w = drv.window(0.0, 10.0)
    # the window's steps and prefills are its own; primed requests keep
    # their earlier stamps, and only requests due in it count for TTFT
    assert w.steps and all(a >= 0 for a, _, _ in w.steps)
    assert all(a >= 0 for a, _, _ in w.admissions)
    assert any(s.due_s < 0 and s.token_s[0] < 0 for s in w.served)
    due = [s for s in w.served if 0 <= s.due_s < 10.0]
    assert len(stats.ttfts(w)) == len(due) == sum(1 for r in reqs if 0 <= r.due_s < 10.0)
    assert len(w.gen_lag_s) <= len(due)
    # a request in flight when the window opens counts among its gaps
    assert min(stats.token_gaps(w)) > 0
    assert {s.index for s in stats.in_window(w)} >= {s.index for s in due}


def test_a_traced_window_follows_on_the_same_clock():
    drv, reqs, _ = _primed(after=10.0)
    drv.run_until(10.0)
    first = drv.window(0.0, 10.0)
    n_first = [len(s.tokens) for s in first.served]
    drv.run_until(20.0)
    second = drv.window(10.0, 10.0)
    # the first window is a snapshot: the later tokens are not in it
    assert [len(s.tokens) for s in first.served] == n_first
    assert second.steps and all(0 <= a < 10.0 for a, _, _ in second.steps)
    offered = sorted(s.index for s in second.served if 0 <= s.due_s < 10.0)
    assert offered == [r.index for r in reqs if 10.0 <= r.due_s < 20.0]


def test_the_timeline_primes_at_the_first_rate_and_numbers_every_request():
    spec = {"loop": "open", "slots": 4, "prompt_len": [8, 64], "output_len": [2, 4],
            "phases": [{"share": 1.0, "rate_rps": 2.0}, {"share": 1.0, "rate_rps": 6.0}],
            "prime_s": 10.0}
    for seed in (3, 2**40 + 1):
        reqs, start = traffic.timeline(spec, seed, 20.0, 100, after=20.0)
        assert start == -10.0
        assert [r.index for r in reqs] == list(range(len(reqs)))
        due = np.array([r.due_s for r in reqs])
        assert np.all(np.diff(due) > 0)
        assert np.sum(due < 0) == 20  # 10 s at the first phase's 2 rps
        window_part = traffic.generate(spec, seed, 20.0, 100)
        assert [r.due_s for r in reqs if 0 <= r.due_s < 20] == [r.due_s for r in window_part]
        assert np.sum(due >= 20) == len(window_part)  # the traced part: the same mix
    assert traffic.timeline(dict(spec, prime_s=0), 3, 20.0, 100)[1] == 0.0


def test_quantile_lengths_span_the_range_log_uniformly():
    x = traffic.quantile_lengths(256, 1024, 64)
    assert x.min() >= 256 and x.max() <= 1024
    assert np.median(x) == pytest.approx(512, rel=0.03)  # the log-uniform median
    assert np.all(np.diff(x) >= 0)


def test_exponential_gaps_have_the_rate():
    g = traffic.exponential_gaps(2.5, 1000)
    assert g.mean() == pytest.approx(1 / 2.5, rel=0.01)
    assert np.median(g) == pytest.approx(np.log(2) / 2.5, rel=0.01)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -3])
def test_every_seed_gets_the_same_work_in_another_order(seed):
    spec = {"loop": "open", "slots": 32, "prompt_len": [256, 2048], "output_len": [16, 128],
            "phases": [{"share": 1.0, "rate_rps": 2.0}]}
    a = traffic.generate(spec, seed, 45.0, 1000)
    b = traffic.generate(spec, 12345, 45.0, 1000)
    assert len(a) == len(b) == 90
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.gen for r in a) == sorted(r.gen for r in b)
    gaps_a = np.diff([0.0] + [r.due_s for r in a])
    gaps_b = np.diff([0.0] + [r.due_s for r in b])
    assert np.allclose(sorted(gaps_a), sorted(gaps_b))
    assert 0 < a[0].due_s and a[-1].due_s < 45.0
    assert all(0 < t for r in a for t in r.prompt) and all(t < 1000 for r in a for t in r.prompt)
    again = traffic.generate(spec, seed, 45.0, 1000)
    assert all(np.array_equal(x.prompt, y.prompt) and x.due_s == y.due_s
               for x, y in zip(a, again))


def test_phases_split_the_window():
    spec = {"loop": "open", "slots": 4, "prompt_len": [8, 16], "output_len": [2, 4],
            "phases": [{"share": 1, "rate_rps": 1.0}, {"share": 1, "rate_rps": 9.0}]}
    r = traffic.generate(spec, 3, 20.0, 50)
    due = np.array([x.due_s for x in r])
    assert (due < 10).sum() == 10 and (due >= 10).sum() == 90


def test_a_closed_loop_fills_its_slots_alike_for_every_seed():
    spec = {"loop": "closed", "slots": 4, "pool": 64, "prompt_len": [256, 1024],
            "output_len": [32, 256]}
    runs = [traffic.generate(spec, seed, 45.0, 32000) for seed in (1, 2, 2**40 + 3)]
    for r in range(0, 64, 4):  # each round holds the same sizes
        assert len({tuple(sorted(x.gen for x in run[r:r + 4])) for run in runs}) == 1
        assert len({tuple(sorted(len(x.prompt) for x in run[r:r + 4])) for run in runs}) == 1
    assert [x.gen for x in runs[0][:4]] != [x.gen for x in runs[1][:4]] or \
        [len(x.prompt) for x in runs[0][:4]] != [len(x.prompt) for x in runs[1][:4]]
