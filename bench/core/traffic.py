"""The one traffic generator: sessions of turns, read from a data file.

A traffic file (``bench/traffic/<name>.json``) gives

* ``arrivals``: ``{"kind": "poisson", "rate_per_s": r}`` (an open loop of
  independent sessions) or ``{"kind": "closed", "clients": n}`` (n
  sessions whose first requests are due at uniform times over the
  pre-roll, ``preroll_s``, so that the clients do not move in step; each
  client sends its next request when the previous one completes — a
  closed loop);
* ``turns`` {min, max} per session (uniform), ``history`` (whether each
  turn's prompt carries the session's earlier turns), ``shared_prefix_tokens``
  (one system prompt that opens every session's prompts);
* ``user_tokens`` / ``answer_tokens``: lognormal {median, sigma} clipped to
  {min, max}; ``think_s`` {mean}: exponential pause after an answer
  completes before the session's next turn is due (0: at once);
* ``base_seed``: the sizes (turn counts, lengths, think times, arrival
  gaps and start times) are drawn from it, in one fixed order, so every
  run seed gets the same sizes at the same times; the run seed draws
  every token (and the harness the weights).  Runs of different seeds
  then differ only in content, which moves the work only through MoE
  routing.

A turn's history holds the traffic's own answer tokens, not the served ones,
so the inputs depend on the seed alone.  A turn that would not fit in
``max_seq_len`` (prompt + answer) ends its session.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Req:
    """One request and what the harness saw of it."""
    session: int
    turn: int
    prompt: np.ndarray
    max_new: int
    due: float
    rid: Optional[int] = None
    submit_t: Optional[float] = None
    refused: bool = False
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    done_t: Optional[float] = None
    measured: bool = False


def _lognormal(rng, spec: Dict, n: int) -> np.ndarray:
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.round(x), spec["min"], spec["max"]).astype(np.int64)


@dataclass
class _Template:
    users: np.ndarray
    answers: np.ndarray
    thinks: np.ndarray


class SessionTraffic:
    """Requests of one run: ``pop_due(now)`` hands out those due by
    ``now`` (and before ``stop_t``), ``complete(req, t)`` schedules the
    session's next turn."""

    def __init__(self, spec: Dict, seed: int, vocab: int, max_seq_len: int,
                 start_t: float, stop_t: float):
        self.spec, self.seed, self.vocab = spec, seed, vocab
        self.max_seq_len, self.stop_t = max_seq_len, stop_t
        arr = spec["arrivals"]
        base = np.random.default_rng(spec.get("base_seed", 0))
        span = stop_t - start_t
        if arr["kind"] == "poisson":
            n = max(int(math.ceil(arr["rate_per_s"] * span)), 1)
            gaps = base.exponential(1.0, n + 1)
        elif arr["kind"] == "closed":
            n = int(arr["clients"])
            gaps = None
        else:
            raise ValueError(f"unknown arrivals kind {arr['kind']!r}")
        self.templates = [self._template(base) for _ in range(n)]
        if gaps is None:
            starts = start_t + base.uniform(0.0, spec["preroll_s"], n)
        else:
            starts = start_t + np.cumsum(gaps)[:n] * span / gaps.sum()
        rng = np.random.default_rng([seed, 3])
        self.shared = rng.integers(0, vocab, spec.get(
            "shared_prefix_tokens", 0)).astype(np.int64)
        self.history: Dict[int, List[np.ndarray]] = {}
        self._heap: List = []
        for s, t in enumerate(starts):
            heapq.heappush(self._heap, (float(t), s, 0))

    def _template(self, base) -> _Template:
        lo, hi = self.spec["turns"]["min"], self.spec["turns"]["max"]
        n = int(base.integers(lo, hi + 1))
        mean = self.spec.get("think_s", {}).get("mean", 0.0)
        return _Template(_lognormal(base, self.spec["user_tokens"], n),
                         _lognormal(base, self.spec["answer_tokens"], n),
                         base.exponential(mean, n) if mean > 0
                         else np.zeros(n))

    def _make(self, due: float, s: int, turn: int) -> Optional[Req]:
        tpl = self.templates[s]
        rng = np.random.default_rng([self.seed, 4, s, turn])
        user = rng.integers(0, self.vocab, int(tpl.users[turn]))
        answer = rng.integers(0, self.vocab, int(tpl.answers[turn]))
        past = self.history.get(s, []) if self.spec.get("history") else []
        prompt = np.concatenate([self.shared, *past, user]).astype(np.int64)
        if len(prompt) + len(answer) > self.max_seq_len:
            return None
        self.history[s] = past + [user, answer]
        return Req(s, turn, prompt, len(answer), due)

    def pop_due(self, now: float) -> List[Req]:
        out = []
        while self._heap and self._heap[0][0] <= now:
            due, s, turn = heapq.heappop(self._heap)
            if due >= self.stop_t:
                continue
            req = self._make(due, s, turn)
            if req is not None:
                out.append(req)
        return out

    def next_due(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def complete(self, req: Req, t: float) -> None:
        """``req`` finished at ``t``: its session's next turn is due a
        think time later."""
        tpl = self.templates[req.session]
        nxt = req.turn + 1
        if nxt < len(tpl.users):
            heapq.heappush(self._heap, (t + float(tpl.thinks[req.turn]),
                                        req.session, nxt))
