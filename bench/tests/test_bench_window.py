"""Window arithmetic against a scripted engine: the rate over the whole
window, percentiles over every request due in it, refused and unfinished
requests counted as failed and as missing their latency."""
import numpy as np

from bench.core.traffic import Req
from bench.core.window import drive, end_to_end, failures, percentile


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeEngine:
    """One token per running request per step; a step takes ``dt``.
    Refuses the submits listed in ``refuse`` (by order)."""

    def __init__(self, clock, dt=0.1, refuse=(), stall=()):
        self.clock, self.dt = clock, dt
        self.refuse, self.stall = set(refuse), set(stall)
        self.n, self.running = 0, {}

    def submit(self, prompt, max_new_tokens):
        k = self.n
        self.n += 1
        if k in self.refuse:
            return None
        self.running[k] = max_new_tokens
        return k

    @property
    def busy(self):
        return bool(self.running)

    def step(self, stream):
        self.clock.t += self.dt
        for rid in list(self.running):
            if rid in self.stall:
                continue
            self.running[rid] -= 1
            done = self.running[rid] == 0
            stream(rid, 1, done)
            if done:
                del self.running[rid]


class Script:
    """Requests at fixed due times, no follow-ups."""

    def __init__(self, dues, max_new=3, stop_t=1e9):
        self.reqs = [Req(i, 0, np.arange(4), max_new, d)
                     for i, d in enumerate(dues)]
        self.stop_t = stop_t

    def pop_due(self, now):
        out = [r for r in self.reqs if r.due <= now and r.due < self.stop_t]
        self.reqs = [r for r in self.reqs if r not in out]
        return out

    def next_due(self):
        return min((r.due for r in self.reqs), default=None)

    def complete(self, req, t):
        pass


def test_rate_and_percentiles_over_the_window():
    clock = Clock()
    eng = FakeEngine(clock, dt=0.1)
    dues = [0.05 * i for i in range(40)]           # 0 .. 1.95
    run = drive(eng, Script(dues, stop_t=2.0), window_start=0.5,
                window_end=1.5, drain_s=5.0, clock=clock)
    m = end_to_end(run)
    measured = run.measured
    assert [r.due for r in measured] == [d for d in dues if 0.5 <= d < 1.5]
    inside = sum(1 for r in run.requests for t in r.times if 0.5 <= t < 1.5)
    assert m["serve_tok_s"] == inside / 1.0
    ttft = [r.times[0] - r.due for r in measured]
    assert m["ttft_p95_ms"] == 1e3 * percentile(ttft, 95)
    tpot = [(r.times[-1] - r.times[0]) / 2 for r in measured]
    assert np.isclose(m["tpot_p95_ms"], 1e3 * percentile(tpot, 95))
    assert failures(run) == 0
    # nothing due after the window is sent
    assert max(r.due for r in run.requests) < 1.5


def test_refused_and_unfinished_count_as_failed_and_missing():
    clock = Clock()
    eng = FakeEngine(clock, dt=0.1, refuse={1}, stall={2})
    run = drive(eng, Script([0.0, 0.0, 0.0, 0.0]), window_start=0.0,
                window_end=0.5, drain_s=1.0, clock=clock)
    assert failures(run) == 2                      # refused + never done
    m = end_to_end(run)
    # the refused request waits until the harness stopped: the p95 of four
    # is the largest, a lower bound on the missing request's wait
    assert np.isclose(m["ttft_p95_ms"], 1e3 * run.stop_t)
    assert run.stop_t >= 1.5                       # drained to the bound


def test_percentile_nearest_rank():
    xs = list(range(1, 21))
    assert percentile(xs, 95) == 19 and percentile(xs, 50) == 10
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, float("inf")], 95) == float("inf")
