"""Serving telemetry: TTFT, inter-token latency, queue depth, tokens/sec.

``ServingMetrics`` is a plain host-side accumulator — the engine calls the
``record_*`` hooks from its event loop; nothing here touches torch.  The clock
is injectable so tests can drive deterministic timelines.

``summary()`` is the export surface: a flat dict (JSON-friendly) consumed by
``launch/serve.py`` (pretty print).  When the engine runs traced
(``ServeConfig(trace=True)``) the attached ``repro_torch.obs.Tracer``'s
per-phase seconds fold into the same dict — the host's step and plan
seconds, the card's prefill / decode / verify seconds from stream events,
and the prefill-vs-decode throughput split those device times enable.

Per-cycle samples (queue depth, KV bytes held) are kept as running max,
sum and count, so a long-lived engine's metrics do not grow; the queue
depth also keeps a thinned history (``queue_depth``: at most
``QUEUE_HISTORY`` samples, evenly spaced over the cycles since reset).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Union

from repro_torch.obs import NULL_TRACER, phase_snapshot

#: queue-depth samples kept: past this many, every second one is dropped
#: and the stride between kept cycles doubles
QUEUE_HISTORY = 1 << 14


def percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile without numpy (metrics must stay import-light).

    Standard ceil-based nearest rank: the smallest value with at least
    ``p%`` of the sample at or below it.  (An earlier version rounded the
    rank with Python's banker's rounding — ``round(0.5) == 0`` — biasing
    p50/p99 low on small samples.)
    """
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(math.ceil((p / 100.0) * len(s)), 1) - 1
    return s[min(k, len(s) - 1)]


class ServingMetrics:
    """Per-request latency + engine throughput counters.

    Timeline per request: submit -> first_token (TTFT, covers queueing +
    prefill) -> token* (inter-token latency) -> completion.

    ``tracer`` (a ``repro_torch.obs.Tracer`` / ``NULL_TRACER``) is attached by
    the engine; ``summary()`` folds its per-phase seconds in.  The tracer
    is engine-owned and survives ``reset()`` — reset it separately when a
    measured window must start clean.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 tracer=None,
                 held_picks: Optional[Callable[[], int]] = None):
        self._clock = clock or time.monotonic
        self.tracer = tracer
        # the MoE layers' device counter of picks that landed on held
        # experts (a model holding only some of them), read at summary()
        self._held_picks = held_picks
        self.reset()

    def reset(self) -> None:
        """Zero every counter (benchmarks reuse warm engines).  The
        attached tracer is NOT reset — it is engine-owned state."""
        self._submit_t: Dict[int, float] = {}
        self._last_token_t: Dict[int, float] = {}
        self.ttft: List[float] = []
        self.itl: List[float] = []                 # inter-token latencies
        # sampled once per cycle: running max / sum / count
        self._queue = [0, 0, 0]
        self._kv = [0, 0, 0]
        # thinned history (bench/sweep.py reads its first and last quarter)
        self.queue_depth: List[int] = []
        self._queue_stride = 1
        self.kv_bytes_slotted = 0                  # slot-pool equivalent
        self.preemptions = 0
        self.rejected = 0
        self.completed = 0
        self.tokens_out = 0
        self.decode_tokens = 0                     # emitted by decode steps
        self.drafted_tokens = 0                    # speculative proposals
        self.accepted_tokens = 0                   # proposals that matched
        self.prefill_tokens = 0
        self.prefix_hit_tokens = 0                 # served from cached pages
        self.prefill_compiles = 0                  # distinct prefill shapes
        # two-kind pools: ring cells bound at admission, and the most
        # global (contiguous) pages held at once; any paged pool samples
        # the latter
        self.ring_cells = 0
        self.global_pages_peak = 0
        self._held_base = self._held_picks() if self._held_picks else 0
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None

    def now(self) -> float:
        return self._clock()

    # -- engine hooks ------------------------------------------------------

    def record_submit(self, rid: int) -> None:
        t = self.now()
        if self._t_start is None:
            self._t_start = t
        self._submit_t[rid] = t

    def record_reject(self) -> None:
        self.rejected += 1

    def record_prefill(self, n_prompt_tokens: int) -> None:
        """Prompt tokens actually *run* through prefill (bucket padding and
        prefix-cache hits excluded — this is the FLOPs-proportional count)."""
        self.prefill_tokens += n_prompt_tokens

    def record_decode_token(self) -> None:
        """A token produced by a batched *decode* step (as opposed to the
        token a prefill's final logits emit) — the numerator of
        ``decode_tokens_per_sec``."""
        self.decode_tokens += 1

    def record_spec(self, drafted: int, accepted: int) -> None:
        """One speculative verify retired: ``drafted`` tokens were
        proposed, ``accepted`` of them matched the engine's own output
        (``accept_rate = accepted / drafted`` in the summary).  The
        accepted tokens themselves also flow through
        ``record_decode_token`` — they are real output tokens."""
        self.drafted_tokens += drafted
        self.accepted_tokens += accepted

    def record_prefix_hit(self, n_tokens: int) -> None:
        """Prompt tokens served from shared cached pages instead of being
        re-prefilled (the prefix cache's compute saving)."""
        self.prefix_hit_tokens += n_tokens

    def record_prefill_compile(self) -> None:
        """The engine ran a new prefill bucket shape.  With
        power-of-two bucketing this stays O(log max_seq_len); unbounded
        growth here is one shape per prompt length."""
        self.prefill_compiles += 1

    def record_ring_cells(self, n: int) -> None:
        """An admission bound ``n`` ring cells (a two-kind pool's slot: one
        ring per windowed layer, counted once)."""
        self.ring_cells += n

    def sample_global_pages(self, held: int) -> None:
        """Global pages the pool holds this cycle (peak kept)."""
        self.global_pages_peak = max(self.global_pages_peak, held)

    @property
    def moe_held_picks(self) -> int:
        """Picks that landed on held experts since ``reset()`` (0 unless
        the model holds only some experts); reading it syncs the host."""
        if self._held_picks is None:
            return 0
        return self._held_picks() - self._held_base

    def record_first_token(self, rid: int) -> None:
        t = self.now()
        if rid in self._submit_t:
            self.ttft.append(t - self._submit_t[rid])
        self._last_token_t[rid] = t
        self.tokens_out += 1
        self._t_end = t

    def record_token(self, rid: int) -> None:
        t = self.now()
        last = self._last_token_t.get(rid)
        if last is not None:
            self.itl.append(t - last)
        self._last_token_t[rid] = t
        self.tokens_out += 1
        self._t_end = t

    def record_completion(self, rid: int) -> None:
        self.completed += 1
        self._t_end = self.now()
        self._submit_t.pop(rid, None)
        self._last_token_t.pop(rid, None)

    def record_preemption(self, rid: Optional[int] = None) -> None:
        """A running request was evicted.  Dropping its last-token timestamp
        keeps eviction + re-queue + re-prefill time *out* of inter-token
        latency: the first token after resume sets a fresh baseline instead
        of recording the whole preemption gap as one giant ITL sample."""
        self.preemptions += 1
        if rid is not None:
            self._last_token_t.pop(rid, None)

    def drop_itl_baseline(self, rid: int) -> None:
        """Forget a request's last-token timestamp without counting a
        preemption.  The pipelined engine's retire phase calls this after
        emitting a preempted victim's in-flight tokens — those emissions
        re-seed the baseline ``record_preemption`` had just dropped, and
        without this the requeue -> resume gap would land in ITL as one
        giant sample."""
        self._last_token_t.pop(rid, None)

    def sample_queue_depth(self, depth: int) -> None:
        _accumulate(self._queue, depth)
        if (self._queue[2] - 1) % self._queue_stride == 0:
            self.queue_depth.append(depth)
            if len(self.queue_depth) >= QUEUE_HISTORY:
                del self.queue_depth[1::2]
                self._queue_stride *= 2

    def sample_kv_bytes(self, held: int, slotted_equiv: int) -> None:
        """KV bytes currently held by the pool vs what a slot-granular pool
        would statically preallocate.  Sampled once per admission cycle and
        (paged) after each decode-step page growth, so the peak is the true
        high-water mark, not the per-cycle snapshot."""
        _accumulate(self._kv, held)
        self.kv_bytes_slotted = slotted_equiv

    # -- export ------------------------------------------------------------

    def elapsed(self) -> float:
        """Measurement window in seconds: first ``record_submit`` to the
        last token/completion event (submit -> last-token, NOT process
        lifetime — queueing is inside the window, engine idle time after
        the last completion is not).  0.0 when nothing was ever admitted
        (e.g. a run where every request was rejected): the throughput
        fields then report honest zeros while ``rejected`` still counts
        the shed load."""
        if self._t_start is None or self._t_end is None:
            return 0.0
        return max(self._t_end - self._t_start, 0.0)

    def summary(self) -> Dict[str, Union[int, float]]:
        """Flat JSON-friendly export (int counters + float gauges; an
        earlier annotation claimed all-float).  Rate fields divide by
        ``elapsed()`` / traced phase seconds and report 0.0 whenever the
        denominator is 0 — a rejected-everything run or an untraced engine
        yields honest zeros, never a ZeroDivisionError.

        ``decode_tokens_per_sec`` / ``prefill_tokens_per_sec`` split the
        combined ``tokens_per_sec`` by the card's seconds in each phase
        (stream events of a traced engine): decode tokens over decode
        seconds, prefill tokens *run* (prefix hits excluded) over prefill
        seconds.  Both are 0.0 with tracing off; on the CPU, which has no
        device clock, the phases' host seconds stand in.
        """
        dt = self.elapsed()
        prompt_tokens = self.prefill_tokens + self.prefix_hit_tokens
        phases = phase_snapshot(self.tracer if self.tracer is not None
                                else NULL_TRACER)
        dec_t, pre_t = phases["decode_time_s"], phases["prefill_time_s"]
        return {
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "decode_tokens": self.decode_tokens,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": (self.accepted_tokens / self.drafted_tokens
                            if self.drafted_tokens else 0.0),
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens / prompt_tokens
                                if prompt_tokens else 0.0),
            "prefill_tokens_saved": self.prefix_hit_tokens,
            "compile_count": self.prefill_compiles,
            "elapsed_s": dt,
            "tokens_per_sec": (self.tokens_out / dt) if dt > 0 else 0.0,
            "decode_tokens_per_sec": (self.decode_tokens / dec_t
                                      if dec_t > 0 else 0.0),
            "prefill_tokens_per_sec": (self.prefill_tokens / pre_t
                                       if pre_t > 0 else 0.0),
            **phases,
            "ttft_mean_s": sum(self.ttft) / len(self.ttft) if self.ttft else 0.0,
            "ttft_p50_s": percentile(self.ttft, 50),
            "ttft_p99_s": percentile(self.ttft, 99),
            "itl_p50_s": percentile(self.itl, 50),
            "itl_p99_s": percentile(self.itl, 99),
            "queue_depth_max": self._queue[0],
            "queue_depth_mean": _mean(self._queue),
            "preemptions": self.preemptions,
            "rejected": self.rejected,
            "kv_bytes_peak": self._kv[0],
            "kv_bytes_mean": _mean(self._kv),
            "kv_bytes_slotted": self.kv_bytes_slotted,
            "ring_cells": self.ring_cells,
            "global_pages_peak": self.global_pages_peak,
            "moe_held_picks": self.moe_held_picks,
        }


def _accumulate(stat: List[int], x: int) -> None:
    """Fold one sample into a running [max, sum, count]."""
    stat[0] = max(stat[0], x)
    stat[1] += x
    stat[2] += 1


def _mean(stat: List[int]) -> float:
    return stat[1] / stat[2] if stat[2] else 0.0
