"""Trace exporters: Chrome trace-event JSON (Perfetto) + flat snapshots.

Two consumers, two shapes:

  * **Chrome trace JSON** (:func:`chrome_trace` / :func:`write_chrome_trace`)
    — the ``{"traceEvents": [...]}`` format `Perfetto <https://ui.perfetto.
    dev>`_ (and ``chrome://tracing``) loads directly.  One track (tid) for
    the engine loop, one for the device phases' intervals (stream events
    put on the tracer's host clock, so the card's idle gaps sit under the
    engine's host spans), one per request; spans are complete events
    (``"X"``), cache/pool happenings are instants (``"i"``), sampled series
    (queue depth, pages held) are counters (``"C"``).  Timestamps are
    microseconds relative to the tracer's epoch.  Every event carries
    ``ph/ts/pid/tid``.
  * **flat phase snapshot** (:func:`phase_snapshot`) — the per-phase time
    totals as plain floats, merged into ``ServingMetrics.summary()``.

Phase model (engine track span names):

  * ``step`` wraps one engine cycle; its sections ``step.plan`` (host
    planning: scheduler decisions, admission, page-table and chunk
    construction), ``step.draft`` (host n-gram drafting for speculative
    decoding — near-zero when spec is off), ``step.submit`` (device
    dispatch of the plan) and ``step.retire`` (materialize a completed
    cycle's tokens: stream, completion, page frees) tile it.  With
    ``pipeline_depth=2`` a step's retire section drains the *previous*
    cycle, so in a trace submit(N+1) begins before retire(N) ends — the
    overlap the ``engine.inflight`` counter makes visible in Perfetto;
  * ``plan`` (host-side prefix planning / page bookkeeping, nested under
    whichever section triggered it) and the device phases
    ``prefill.device``, ``decode.device`` and ``verify.device``: host
    spans around the launches, and on the device track the card's
    interval from the stream event at the span's start to the one at its
    end.  ``step``, ``plan`` and ``step.draft`` are host seconds; the
    device phases' seconds are the card's.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import DEVICE_TRACK, ENGINE_TRACK

#: Perfetto counter track: device cycles submitted but not yet retired
INFLIGHT_COUNTER = "engine.inflight"


def chrome_trace(tracer, *, pid: int = 1) -> Dict[str, Any]:
    """Convert a tracer's ring buffer into a Chrome trace-event dict.

    Still-open cross-cycle spans (a trace snapshotted mid-serve) are
    emitted as spans up to ``now`` with ``args.unfinished = true`` rather
    than dangling ``"B"`` events Perfetto would render unmatched; device
    pairs not yet resolved are, after one synchronize.
    """
    tracer.resolve(wait=True)
    t0 = tracer.t0
    tids: Dict[str, int] = {ENGINE_TRACK: 0}
    if tracer.device_seconds:
        tids[DEVICE_TRACK] = 1
    events: List[Dict[str, Any]] = []

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids)
        return tids[track]

    def us(t: float) -> float:
        return (t - t0) * 1e6

    for ph, name, track, ts, value, args in tracer.events:
        ev: Dict[str, Any] = {"name": name, "ph": ph, "ts": us(ts),
                              "pid": pid, "tid": tid(track),
                              "cat": "serving"}
        if ph == "X":
            ev["dur"] = value * 1e6
            if args:
                ev["args"] = args
        elif ph == "i":
            ev["s"] = "t"                      # thread-scoped instant
            if args:
                ev["args"] = args
        elif ph == "C":
            ev["args"] = {"value": value}
        events.append(ev)
    if getattr(tracer, "_open", None):
        now = tracer.now()
        for (track, name), (ts, args) in sorted(tracer._open.items()):
            events.append({"name": name, "ph": "X", "ts": us(ts),
                           "dur": (now - ts) * 1e6, "pid": pid,
                           "tid": tid(track), "cat": "serving",
                           "args": dict(args or {}, unfinished=True)})
    meta_events = [{"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                    "tid": 0, "args": {"name": "repro_torch.serving"}}]
    for track, t in sorted(tids.items(), key=lambda kv: kv[1]):
        meta_events.append({"name": "thread_name", "ph": "M", "ts": 0,
                            "pid": pid, "tid": t, "args": {"name": track}})
        meta_events.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                            "pid": pid, "tid": t,
                            "args": {"sort_index": t}})
    return {"traceEvents": meta_events + events,
            "displayTimeUnit": "ms",
            "otherData": dict(tracer.meta, dropped_events=tracer.dropped)}


def write_chrome_trace(tracer, path: str, *, pid: int = 1) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, pid=pid), f)
    return path


def phase_snapshot(tracer) -> Dict[str, float]:
    """Flat per-phase totals (seconds) for the summary merge: the host's
    ``step`` wall with its ``plan`` and ``step.draft`` parts, and the
    card's seconds in prefill, decode and verify from the stream events
    (unresolved pairs resolved first: one synchronize).  Without a device
    clock (the CPU, where host and device time coincide) the device phases
    are their host spans' seconds.  All zeros for a :class:`NullTracer`
    (tracing off), so the summary schema is stable either way.
    """
    tracer.resolve(wait=True)
    ph = tracer.phase_seconds
    dev = tracer.device_seconds if tracer.device_clock is not None else ph
    return {
        "step_time_s": ph.get("step", 0.0),
        "plan_time_s": ph.get("plan", 0.0),
        "draft_time_s": ph.get("step.draft", 0.0),
        "prefill_time_s": dev.get("prefill.device", 0.0),
        "decode_time_s": dev.get("decode.device", 0.0),
        "verify_time_s": dev.get("verify.device", 0.0),
    }


__all__ = ["chrome_trace", "write_chrome_trace", "phase_snapshot",
           "INFLIGHT_COUNTER"]
