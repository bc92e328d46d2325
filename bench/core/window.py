"""The measured window: requests submitted when due, the engine stepped,
every token timestamped as the stream hands it over.

The loop runs the traffic from ``start_t`` (a pre-roll that fills the
engine and its prefix cache to a steady state, counted as set-up) through
the window ``[window_start, window_end)``.  Requests due in the window are
the measured ones.  At ``window_end`` the harness stops sending and drains:
it steps on until every measured request has completed, or until
``window_end + drain_s``.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

from bench.core.traffic import Req, SessionTraffic


class Run:
    """What one drive of the engine produced."""

    def __init__(self, window_start: float, window_end: float):
        self.window_start, self.window_end = window_start, window_end
        self.requests: List[Req] = []
        self.by_rid: Dict[int, Req] = {}
        self.step = 0                         # engine steps taken
        self.step_tokens = defaultdict(list)  # step -> [(req, j)]
        self.stop_t: Optional[float] = None
        self.late_s: List[float] = []         # submit - due (generator lag)
        self.counters: Dict[str, dict] = {}   # "start" / "end" snapshots

    @property
    def measured(self) -> List[Req]:
        return [r for r in self.requests if r.measured]


def drive(engine, traffic: SessionTraffic, *, window_start: float,
          window_end: float, drain_s: float,
          clock: Callable[[], float] = time.perf_counter,
          hooks=None, counters: Callable[[], dict] = dict) -> Run:
    """Drive ``engine`` with ``traffic`` to the end of the drain.
    ``hooks`` (optional) gets ``tick(run)`` at every step boundary,
    ``close(run)`` at the end and ``span(name)`` context managers (the
    traced run's profiler slice).
    ``counters()`` is read as the window opens and as it closes."""
    run = Run(window_start, window_end)
    span = hooks.span if hooks is not None else (lambda name: nullcontext())

    def stream(rid: int, tok: int, done: bool) -> None:
        t = clock()
        req = run.by_rid[rid]
        run.step_tokens[run.step].append((req, len(req.tokens)))
        req.tokens.append(int(tok))
        req.times.append(t)
        if done:
            req.done_t = t
            traffic.complete(req, t)

    deadline = window_end + drain_s
    while True:
        if hooks is not None:
            hooks.tick(run)
        now = clock()
        for key, edge in (("start", window_start), ("end", window_end)):
            if key not in run.counters and now >= edge:
                run.counters[key] = counters()
        with span("bench.traffic"):
            due = [r for r in traffic.pop_due(min(now, window_end))
                   if r.due < window_end]
        for req in due:
            req.measured = window_start <= req.due < window_end
            with span("engine.submit"):
                rid = engine.submit(req.prompt.tolist(),
                                    max_new_tokens=req.max_new)
            req.submit_t = clock()
            run.late_s.append(req.submit_t - req.due)
            run.requests.append(req)
            if rid is None:
                req.refused = True
            else:
                req.rid = rid
                run.by_rid[rid] = req
        if now >= window_end and (now >= deadline or all(
                r.done_t is not None or r.refused for r in run.measured)):
            break
        if engine.busy:
            with span("engine.step"):
                engine.step(stream)
            run.step += 1
            continue
        nxt = traffic.next_due()
        wait = (min(nxt, window_end) if nxt is not None else window_end) \
            - clock()
        if wait > 0:
            with span("bench.idle"):
                time.sleep(min(wait, 0.001))
    run.stop_t = clock()
    if hooks is not None:
        hooks.close(run)
    return run


def percentile(xs: List[float], p: float) -> float:
    """Nearest rank: the smallest value with at least p% of the sample at
    or below it (inf counts as the largest)."""
    s = sorted(xs)
    k = max(math.ceil(p / 100.0 * len(s)), 1) - 1
    return s[min(k, len(s) - 1)]


def end_to_end(run: Run) -> Dict[str, Optional[float]]:
    """The window's user-facing numbers.

    * ``serve_tok_s``: tokens the stream handed over inside the window,
      over the window's seconds;
    * ``ttft_p95_ms``: over every request due in the window, first token
      minus due time; a request refused, or with no first token when the
      harness stopped, counts as its wait until the stop (a lower bound);
    * ``tpot_p95_ms``: over every measured request that completed with two
      tokens or more, (last - first) / (tokens - 1).
    """
    ws, we = run.window_start, run.window_end
    n_tok = sum(1 for r in run.requests for t in r.times if ws <= t < we)
    ttft, tpot = [], []
    for r in run.measured:
        first = r.times[0] if r.times else run.stop_t
        ttft.append(first - r.due)
        if r.done_t is not None and len(r.times) > 1:
            tpot.append((r.times[-1] - r.times[0]) / (len(r.times) - 1))
    return {"serve_tok_s": n_tok / (we - ws),
            "ttft_p95_ms": 1e3 * percentile(ttft, 95) if ttft else None,
            "tpot_p95_ms": 1e3 * percentile(tpot, 95) if tpot else None}


def spread_of_waits(run: Run) -> Dict[str, float]:
    """Median, 90th and 95th percentiles of the measured requests'
    first-token waits and token gaps: printed beside the metrics, not
    metrics."""
    ttft = [(r.times[0] if r.times else run.stop_t) - r.due
            for r in run.measured]
    tpot = [(r.times[-1] - r.times[0]) / (len(r.times) - 1)
            for r in run.measured if r.done_t is not None and len(r.times) > 1]
    out = {}
    for name, xs in (("ttft", ttft), ("tpot", tpot)):
        for p in (50, 90, 95):
            if xs:
                out[f"{name}_p{p}_ms"] = 1e3 * percentile(xs, p)
    return out


def failures(run: Run) -> int:
    """Measured requests refused or not completed when the harness
    stopped."""
    return sum(1 for r in run.measured if r.refused or r.done_t is None)
