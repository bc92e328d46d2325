"""Admission + batching scheduler for the continuous-batching engine.

Pure host-side logic (no torch): a bounded request queue plus the policy that
decides which waiting requests are prefilled into free KV slots each engine
cycle, and — under the ``priority`` policy — which running request to
preempt when something more urgent is waiting.

Policies
  * ``fcfs``      — strict arrival order, no preemption.
  * ``priority``  — higher ``priority`` first; ties broken by earlier
                    ``deadline`` (None = no deadline = latest), then arrival.
                    A waiting request with strictly higher priority than the
                    lowest-priority running one preempts it: the victim's
                    slot is evicted and the victim re-queued with its
                    generated tokens folded into the prompt, so its eventual
                    output is unchanged (greedy decode is deterministic, and
                    sampled decode keys its PRNG by absolute token index —
                    see ``serving/sampling.py`` — so resume replays exactly).

``max_prefills_per_step`` (formerly ``prefill_chunk``, kept as a deprecated
``ServeConfig`` alias) bounds how many *requests* may start prefilling per
cycle — one of two prefill/decode interleaving knobs.  The other,
``prefill_chunk_tokens``, lives in the engine: it splits a single long
prompt into token chunks run across cycles, so neither many short prompts
nor one long prompt can stall running streams' inter-token latency.  The
scheduler only sees the per-request admission bound; token chunking and
prefix-cache admission (pages shared with cached prompts) are engine/pool
concerns.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ServeConfig
from repro_torch.obs import NULL_TRACER
from repro_torch.serving.sampling import GREEDY, SamplingParams


@dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""
    rid: int
    prompt: Tuple[int, ...]               # token ids
    max_new_tokens: int
    priority: int = 0                     # higher = more urgent
    deadline: Optional[float] = None      # absolute time, policy tiebreak
    sampling: SamplingParams = GREEDY     # per-request generation params
    arrival_seq: int = 0                  # monotone admission counter
    # runtime state (owned by the engine)
    tokens: List[int] = field(default_factory=list)   # generated so far
    preempted: int = 0                    # times this request was evicted

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def resume_prompt(self) -> Tuple[int, ...]:
        """Prompt to re-prefill after preemption: original + generated."""
        return self.prompt + tuple(self.tokens)


class Scheduler:
    """Bounded FCFS/priority queue feeding KV slots.

    The scheduler never touches device state: the engine asks it *which*
    requests to prefill (``next_prefills``) and *which* running request to
    evict (``preemption``); slot bookkeeping itself lives in the KV pool.
    """

    def __init__(self, cfg: ServeConfig, tracer=None):
        cfg.validate()
        self.cfg = cfg
        # queue-side trace events (engine passes its Tracer; NULL when off)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.waiting: List[Request] = []
        self._seq = itertools.count()
        # requeue sequence: monotone *decrementing* so every re-queued
        # request sorts before fresh arrivals AND no two requeues collide
        # (the old ``-1 - preempted`` scheme collided two once-preempted
        # requests at -2 and let a twice-preempted one jump an earlier
        # once-preempted one)
        self._requeue_seq = itertools.count(-1, -1)

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit into the waiting queue; False when over ``max_queue``."""
        if len(self.waiting) >= self.cfg.max_queue:
            self.tracer.instant("queue.reject", rid=req.rid)
            return False
        req.arrival_seq = next(self._seq)
        self.waiting.append(req)
        self.tracer.counter("queue_depth", len(self.waiting))
        return True

    def depth(self) -> int:
        return len(self.waiting)

    # -- ordering ----------------------------------------------------------

    def _rank(self, r: Request):
        """Sort key: most-urgent first."""
        if self.cfg.policy == "priority":
            dl = r.deadline if r.deadline is not None else float("inf")
            return (-r.priority, dl, r.arrival_seq)
        return (r.arrival_seq,)

    def _sorted_waiting(self) -> List[Request]:
        return sorted(self.waiting, key=self._rank)

    def peek(self) -> Optional[Request]:
        """Most urgent waiting request without popping it (None if empty)."""
        return self._sorted_waiting()[0] if self.waiting else None

    # -- batching ----------------------------------------------------------

    def next_prefills(self, free_slots: int,
                      skip_rids=frozenset()) -> List[Request]:
        """Pop up to min(free_slots, max_prefills_per_step) requests to
        start prefilling now.

        ``skip_rids`` holds requests that must not be admitted this cycle —
        the pipelined engine passes the rids with device results still in
        flight (a preempted victim's un-retired tokens would be missing
        from its resume prompt).  The guard keeps head-of-line order: a
        skipped head *blocks* admission rather than letting later arrivals
        jump it, matching the synchronous engine's strict ordering; the
        skip clears at the next retire, one cycle later.
        """
        n = min(free_slots, self.cfg.max_prefills_per_step, len(self.waiting))
        if n <= 0:
            return []
        picked = []
        for r in self._sorted_waiting()[:n]:
            if r.rid in skip_rids:
                break
            picked.append(r)
        for r in picked:
            self.waiting.remove(r)
        return picked

    def preemption(self, running: Dict[int, Request]) -> List[Tuple[int, Request]]:
        """(slot, victim) pairs to evict for strictly-higher-priority waiters.

        Only meaningful under the ``priority`` policy and only when
        admission is blocked — no free slot, or (paged pool) too few free
        pages for the most urgent waiter.  At most one victim per waiting
        challenger, and never more victims than ``max_prefills_per_step`` —
        a freed slot the next admission round cannot refill would idle
        while its victim needlessly loses decode progress.  A challenger
        never preempts a peer of equal priority (avoids livelock).
        """
        if self.cfg.policy != "priority" or not running or not self.waiting:
            return []
        victims: List[Tuple[int, Request]] = []
        # running requests, least-urgent first
        by_urgency = sorted(running.items(), key=lambda kv: self._rank(kv[1]),
                            reverse=True)
        challengers = self._sorted_waiting()[:self.cfg.max_prefills_per_step]
        taken = set()
        for ch in challengers:
            for slot, victim in by_urgency:
                if slot in taken:
                    continue
                if ch.priority > victim.priority:
                    victims.append((slot, victim))
                    taken.add(slot)
                    break
            else:
                break       # most-urgent challenger found no victim: stop
        return victims

    def requeue(self, req: Request) -> None:
        """Return a preempted request to the queue (front of its rank class).

        Preempted requests bypass ``max_queue`` — they were already admitted
        once; bouncing them would drop accepted work.  Victims of one
        preemption round arrive here least-urgent-first (``preemption``'s
        order), so the decrementing counter hands the most urgent victim the
        most negative seq: within a rank class, re-queued requests resume in
        their original arrival order.
        """
        req.preempted += 1
        self.push_front(req)

    def drop(self, req: Request) -> bool:
        """Remove a waiting request outright (no requeue).  The pipelined
        engine needs this when a preempted-and-requeued request's in-flight
        tokens turn out to *complete* it at retire time — the finished
        request must not be re-admitted and re-served."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def push_front(self, req: Request) -> None:
        """Put a popped-but-not-admitted request back at the queue head
        (no preemption bookkeeping) — e.g. when the paged pool briefly has
        a slot but not the pages for its prompt."""
        req.arrival_seq = next(self._requeue_seq)
        self.waiting.append(req)
        self.tracer.instant("queue.push_front", rid=req.rid,
                            preempted=req.preempted)
