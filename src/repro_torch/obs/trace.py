"""Structured engine tracing: nestable spans, counters, instant events.

The serving engine's user-transparency promise cuts both ways — users never
see the runtime, but operators must be able to see *inside* it.  The
TensorFlow whitepaper leans on built-in timeline tracing (EEG) to attribute
step time; this module is that capability for the serving stack: every
engine cycle decomposes into phase spans (preemption check, admission,
chunked prefill, host planning, device decode), every request gets a
lifecycle track (queued -> prefill chunks -> decode -> complete), and the
page pool emits cache events (alloc, COW, ring rotation, LRU traffic,
prefix hit/miss).

Design constraints, in order:

  * **~zero cost when off** — tracing is opt-in (``ServeConfig(trace=True)``).
    The disabled path is :data:`NULL_TRACER`, whose methods are empty and
    whose ``span()`` returns one shared context-manager singleton: no
    allocation, no clock read, no branch in the engine beyond an attribute
    call.  The hot decode loop must not regress when tracing is off.
  * **no fences** — a traced engine runs the schedule an untraced one
    does.  Device phases (``device_span``) are timed by a pair of stream
    events from a *device clock* the engine hands in (``serving/
    profiling.py``'s ``CudaClock``: record / done / seconds, anchored to
    this tracer's clock at ``reset``); :meth:`Tracer.resolve` turns the
    pairs whose end has completed into spans on :data:`DEVICE_TRACK`
    without waiting, and the engine calls it after retire, which has
    already waited for them.  Without a device clock (the CPU) a device
    span is a host span only.
  * **one set of spans for every consumer** — while a ``torch.profiler``
    session is active, each lexical span (of a :class:`Tracer` or of
    :data:`NULL_TRACER`) is also entered as a ``record_function`` range of
    the same name, so the profile of an untraced engine carries the
    engine's phases on the kernels' clock.  Whether a profile is active is
    one attribute of the module :func:`install_profiler` installs
    (``serving`` installs ``torch.autograd.profiler``), read per span.
  * **bounded memory** — events land in a ring buffer (``capacity``, default
    64Ki); when full the *oldest* events drop (``dropped`` counts them), so
    a long-lived engine keeps the recent window instead of growing without
    limit.
  * **deterministic under test** — the clock is injectable
    (``Tracer(clock=...)``), the same pattern ``ServingMetrics`` uses, so
    tests drive exact timelines.

Two kinds of span API:

  * ``with tracer.span("decode.device"): ...`` — lexically scoped phases
    (the engine loop).  Nesting is just lexical nesting; the exporter
    renders it as stacked slices.
  * ``tracer.begin("decode", track=...)`` / ``tracer.end("decode",
    track=...)`` — spans that open and close in *different* engine cycles
    (a request's queued / prefill / decode lifecycle).  ``end`` of a span
    that is not open is a silent no-op (returns False), so preemption
    paths can close "whichever of prefill/decode is open" without
    bookkeeping; balance is checked via :meth:`Tracer.open_spans`.

Per-phase attribution: every closed span accumulates into
``phase_seconds[name]`` / ``phase_counts[name]`` *for the engine track
only* — per-request spans overlap engine phases wall-clock-wise and would
double count — as host seconds; each resolved device interval into
``device_seconds[name]``.  ``repro_torch.obs.export.phase_snapshot``
flattens those totals into the dict ``ServingMetrics.summary()`` merges.

Events are stored as plain tuples ``(ph, name, track, ts, value, args)``
with Chrome trace-event phase codes (``"X"`` complete span with
``value=duration``, ``"i"`` instant, ``"C"`` counter with
``value=counter``); ``repro_torch.obs.export`` turns them into a
Perfetto-loadable Chrome trace JSON.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the engine-loop track; phase attribution accumulates spans on it only
ENGINE_TRACK = "engine"
#: the track of the device phases' intervals (stream events, host clock)
DEVICE_TRACK = "device"

#: event tuple layout (ph, name, track, ts, value, args) — ph follows the
#: Chrome trace-event phase codes so the exporter is a dumb transcription
Event = Tuple[str, str, str, float, float, Optional[Dict[str, Any]]]


class _NullSpan:
    """The shared no-op context manager ``NULL_TRACER.span`` hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _NoProfiler:
    """Stands for the profiler's state until :func:`install_profiler`: no
    profile is ever active."""

    _is_profiler_enabled = False


#: whose ``_is_profiler_enabled`` says a profile is active, and the range
#: each span enters then (``install_profiler``)
_profiler: Any = _NoProfiler
_record_function: Optional[Callable[[str], Any]] = None


def install_profiler(profiler: Any, record_function: Callable[[str], Any]
                     ) -> None:
    """Enter every lexical span as ``record_function(name)`` while
    ``profiler._is_profiler_enabled`` holds (``serving`` installs
    ``torch.autograd.profiler`` and ``torch.profiler.record_function``)."""
    global _profiler, _record_function
    _profiler, _record_function = profiler, record_function


def profile_range(name: str):
    """``record_function(name)`` while a profile is active, else the shared
    no-op span: a range for code outside the engine's tracer (the MoE
    layer's sorted route)."""
    if _profiler._is_profiler_enabled:
        return _record_function(name)
    return _NULL_SPAN


class _SpanCtx:
    """Lexically scoped span (``with tracer.span(...)``); a device span
    also records a stream event at each end."""

    __slots__ = ("_tr", "_name", "_track", "_args", "_t0", "_range",
                 "_device", "_ev0")

    def __init__(self, tr: "Tracer", name: str, track: str,
                 args: Optional[Dict[str, Any]], device: bool = False):
        self._tr = tr
        self._name = name
        self._track = track
        self._args = args
        self._device = device

    def __enter__(self) -> "_SpanCtx":
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _record_function(self._name)
            self._range.__enter__()
        tr = self._tr
        if self._device:
            self._ev0 = tr.device_clock.record()
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        if self._device:
            tr._pending.append((self._name, self._args, self._ev0,
                                tr.device_clock.record()))
        tr._span(self._name, self._track, self._t0, tr._clock(), self._args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Bounded-ring span/counter/instant recorder with per-phase totals."""

    enabled = True

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 1 << 16,
                 meta: Optional[Dict[str, Any]] = None,
                 device_clock: Any = None):
        assert capacity >= 1, capacity
        self._clock = clock or time.perf_counter
        self.device_clock = device_clock
        self.capacity = capacity
        self.meta: Dict[str, Any] = dict(meta or {})
        self.reset()

    def reset(self) -> None:
        """Drop every event, phase total and unresolved device pair, and
        re-anchor the device clock on this tracer's clock (benchmarks reuse
        warm engines; the clocks, capacity and meta survive)."""
        self.events: deque = deque()
        self.dropped = 0
        self._open: Dict[Tuple[str, str], Tuple[float,
                                                Optional[Dict[str, Any]]]] = {}
        self._pending: deque = deque()
        self.phase_seconds: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.device_seconds: Dict[str, float] = {}
        if self.device_clock is not None:
            self.device_clock.anchor(self._clock)
        self.t0 = self._clock()

    def now(self) -> float:
        return self._clock()

    # -- recording ---------------------------------------------------------

    def _push(self, ev: Event) -> None:
        if len(self.events) >= self.capacity:
            self.events.popleft()
            self.dropped += 1
        self.events.append(ev)

    def _span(self, name: str, track: str, t0: float, t1: float,
              args: Optional[Dict[str, Any]]) -> None:
        self._push(("X", name, track, t0, t1 - t0, args))
        if track == ENGINE_TRACK:
            self.phase_seconds[name] = \
                self.phase_seconds.get(name, 0.0) + (t1 - t0)
            self.phase_counts[name] = self.phase_counts.get(name, 0) + 1

    def span(self, name: str, track: str = ENGINE_TRACK,
             **args: Any) -> _SpanCtx:
        """Lexically scoped span; nest freely (``with`` blocks)."""
        return _SpanCtx(self, name, track, args or None)

    def device_span(self, name: str, **args: Any) -> _SpanCtx:
        """An engine-track span around device launches, whose device
        interval (a stream event at each end) lands on
        :data:`DEVICE_TRACK` once :meth:`resolve` finds it complete."""
        return _SpanCtx(self, name, ENGINE_TRACK, args or None,
                        device=self.device_clock is not None)

    def resolve(self, wait: bool = False) -> int:
        """Turn the device pairs whose end event has completed into spans
        on :data:`DEVICE_TRACK` and ``device_seconds``, in stream order; a
        pair still running stops the scan, and nothing waits for it unless
        ``wait`` (export: one synchronize).  Returns how many resolved."""
        dev, pending = self.device_clock, self._pending
        if wait and pending:
            dev.synchronize()
        n = 0
        while pending and dev.done(pending[0][3]):
            name, args, ev0, ev1 = pending.popleft()
            t0, t1 = dev.seconds(ev0), dev.seconds(ev1)
            self._push(("X", name, DEVICE_TRACK, t0, t1 - t0, args))
            self.device_seconds[name] = \
                self.device_seconds.get(name, 0.0) + (t1 - t0)
            n += 1
        return n

    def begin(self, name: str, track: str = ENGINE_TRACK,
              **args: Any) -> None:
        """Open a cross-cycle span.  Re-opening an already open (track,
        name) closes the stale one first (balance over silent leaks)."""
        key = (track, name)
        stale = self._open.pop(key, None)
        if stale is not None:
            self._span(name, track, stale[0], self._clock(),
                       dict(stale[1] or {}, reopened=True))
        self._open[key] = (self._clock(), args or None)

    def end(self, name: str, track: str = ENGINE_TRACK, **args: Any) -> bool:
        """Close a cross-cycle span; False (and no event) when it is not
        open — callers may unconditionally close alternatives."""
        o = self._open.pop((track, name), None)
        if o is None:
            return False
        merged = dict(o[1] or {})
        merged.update(args)
        self._span(name, track, o[0], self._clock(), merged or None)
        return True

    def instant(self, name: str, track: str = ENGINE_TRACK,
                **args: Any) -> None:
        """Point event (page alloc, COW, preemption, compile, ...)."""
        self._push(("i", name, track, self._clock(), 0.0, args or None))

    def counter(self, name: str, value: float,
                track: str = ENGINE_TRACK) -> None:
        """Sampled counter series (queue depth, pages held, ...)."""
        self._push(("C", name, track, self._clock(), float(value), None))

    # -- inspection --------------------------------------------------------

    def open_spans(self) -> List[Tuple[str, str]]:
        """(track, name) of every begin() without a matching end() — the
        balance tests assert this drains to [] when the engine drains."""
        return sorted(self._open)

    def close_all(self, **args: Any) -> int:
        """Close every open cross-cycle span (export hygiene for traces
        snapshotted mid-flight); returns how many were closed."""
        n = 0
        for track, name in list(self._open):
            self.end(name, track=track, **args)
            n += 1
        return n


_EMPTY_DICT: Dict[str, Any] = {}


class NullTracer:
    """Strict no-op twin of :class:`Tracer` — the disabled hot path.

    Every method returns immediately without reading the clock or
    allocating; ``span()`` returns one module-level singleton context
    manager — or, while a profile is active, the span's
    ``record_function`` range.  ``events`` / ``phase_seconds`` present the
    empty shapes so consumers (metrics merge, exporters) need no
    enabled-check branches.
    """

    enabled = False
    events: Tuple[Event, ...] = ()
    dropped = 0
    capacity = 0
    t0 = 0.0
    meta = _EMPTY_DICT
    phase_seconds: Dict[str, float] = _EMPTY_DICT
    phase_counts: Dict[str, int] = _EMPTY_DICT
    device_seconds: Dict[str, float] = _EMPTY_DICT
    device_clock = None

    def reset(self) -> None:
        pass

    def now(self) -> float:
        return 0.0

    def span(self, name: str, track: str = ENGINE_TRACK, **args: Any):
        if _profiler._is_profiler_enabled:
            return _record_function(name)
        return _NULL_SPAN

    device_span = span

    def resolve(self, wait: bool = False) -> int:
        return 0

    def begin(self, name: str, track: str = ENGINE_TRACK,
              **args: Any) -> None:
        pass

    def end(self, name: str, track: str = ENGINE_TRACK, **args: Any) -> bool:
        return False

    def instant(self, name: str, track: str = ENGINE_TRACK,
                **args: Any) -> None:
        pass

    def counter(self, name: str, value: float,
                track: str = ENGINE_TRACK) -> None:
        pass

    def open_spans(self) -> List[Tuple[str, str]]:
        return []

    def close_all(self, **args: Any) -> int:
        return 0


#: the one NullTracer every disabled engine shares
NULL_TRACER = NullTracer()


def request_track(rid: int) -> str:
    """Track name of one request's lifecycle spans (one Perfetto row per
    request, per the whitepaper-style timeline view)."""
    return f"req{rid}"
