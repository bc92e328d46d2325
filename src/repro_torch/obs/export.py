"""Trace exporters: Chrome trace-event JSON (Perfetto) + flat snapshots.

Two consumers, two shapes:

  * **Chrome trace JSON** (:func:`chrome_trace` / :func:`write_chrome_trace`)
    — the ``{"traceEvents": [...]}`` format `Perfetto <https://ui.perfetto.
    dev>`_ (and ``chrome://tracing``) loads directly.  One track (tid) for
    the engine loop, one per request; spans are complete events (``"X"``),
    cache/pool happenings are instants (``"i"``), sampled series (queue
    depth, pages held) are counters (``"C"``).  Timestamps are microseconds
    relative to the tracer's epoch.  Every event carries ``ph/ts/pid/tid``
    — asserted by the schema test and the CI smoke gate.
  * **flat phase snapshot** (:func:`phase_snapshot`) — the per-phase time
    totals as plain floats, merged into ``ServingMetrics.summary()`` so
    one JSON record answers "where did the cycle go" without opening a
    trace; :func:`prometheus_text` renders the same summary as a
    Prometheus-style text exposition for scrape-shaped consumers.

Phase model (engine track span names):

  * ``step`` wraps one engine cycle; the pipeline *sections* ``step.plan``
    (pure host planning: scheduler decisions, admission, page-table and
    chunk construction), ``step.draft`` (host n-gram drafting for
    speculative decoding — near-zero when spec is off), ``step.submit``
    (device dispatch of the plan) and ``step.retire`` (materialize a
    completed cycle's tokens: stream, completion, page frees) tile it
    (:data:`STEP_SECTIONS` — their sum over a run is the cycle wall time
    minus loop glue, asserted >= 95% by the tests).  With
    ``pipeline_depth=2`` a step's retire section drains the *previous*
    cycle, so in a trace submit(N+1) begins before retire(N) ends — the
    overlap the ``engine.inflight`` counter makes visible in Perfetto;
  * the *leaves* ``plan`` (host-side prefix planning / page bookkeeping,
    nested under whichever section triggered it), ``prefill.device``,
    ``decode.device`` and ``verify.device`` (device launches, fenced with
    ``torch.cuda.synchronize`` in traced mode) are mutually disjoint, so
    ``other = step - plan - step.draft - prefill.device - decode.device
    - verify.device`` is the well-defined "everything else" — scheduling,
    numpy glue, stream callbacks — and ``host_overhead_frac = other /
    step`` is the number the async-pipeline work drives down (gated
    <= 0.25 by the CI smoke).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import ENGINE_TRACK

#: engine-track spans that tile one ``step`` span (coverage denominator)
STEP_SECTIONS = ("step.plan", "step.draft", "step.submit", "step.retire")

#: disjoint leaf phases the summary attributes wall time to
LEAF_PHASES = ("plan", "prefill.device", "decode.device", "verify.device")

#: Perfetto counter track: device cycles submitted but not yet retired
INFLIGHT_COUNTER = "engine.inflight"

#: named phase keys shared by :func:`phase_snapshot`,
#: ``ServingMetrics.summary()`` and the bench schema gate — one spelling,
#: three consumers, no drift
STEP_TIME_S = "step_time_s"
PLAN_TIME_S = "plan_time_s"
DRAFT_TIME_S = "draft_time_s"
PREFILL_TIME_S = "prefill_time_s"
DECODE_TIME_S = "decode_time_s"
VERIFY_TIME_S = "verify_time_s"
OTHER_TIME_S = "other_time_s"
HOST_OVERHEAD_FRAC = "host_overhead_frac"
PHASE_TIME_KEYS = (STEP_TIME_S, PLAN_TIME_S, DRAFT_TIME_S, PREFILL_TIME_S,
                   DECODE_TIME_S, VERIFY_TIME_S, OTHER_TIME_S)
#: phase-derived summary keys that are meaningless untraced (the traced
#: attribution pass owns them; untraced bench records must omit them)
TRACED_ONLY_KEYS = PHASE_TIME_KEYS + (
    HOST_OVERHEAD_FRAC, "decode_tokens_per_sec", "prefill_tokens_per_sec")


def chrome_trace(tracer, *, pid: int = 1) -> Dict[str, Any]:
    """Convert a tracer's ring buffer into a Chrome trace-event dict.

    Still-open cross-cycle spans (a trace snapshotted mid-serve) are
    emitted as spans up to ``now`` with ``args.unfinished = true`` rather
    than dangling ``"B"`` events Perfetto would render unmatched.
    """
    t0 = tracer.t0
    tids: Dict[str, int] = {ENGINE_TRACK: 0}
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
    """Flat per-phase attribution totals (seconds) for the summary merge.

    ``*_time_s`` keys are the disjoint leaves plus the enclosing ``step``
    wall; ``other_time_s`` is step minus the leaves — host scheduling,
    numpy glue, stream callbacks.  All zeros for a :class:`NullTracer`
    (tracing off), so the summary schema is stable either way.
    """
    ph = tracer.phase_seconds
    step = ph.get("step", 0.0)
    plan = ph.get("plan", 0.0)
    draft = ph.get("step.draft", 0.0)
    prefill = ph.get("prefill.device", 0.0)
    decode = ph.get("decode.device", 0.0)
    verify = ph.get("verify.device", 0.0)
    other = max(step - plan - draft - prefill - decode - verify, 0.0)
    return {
        STEP_TIME_S: step,
        PLAN_TIME_S: plan,
        DRAFT_TIME_S: draft,
        PREFILL_TIME_S: prefill,
        DECODE_TIME_S: decode,
        VERIFY_TIME_S: verify,
        OTHER_TIME_S: other,
        HOST_OVERHEAD_FRAC: (other / step) if step > 0 else 0.0,
    }


def phase_coverage(tracer) -> float:
    """Fraction of engine-loop wall time the section spans account for
    (the acceptance bar: >= 0.95 on a traced smoke serve).  1.0 when
    nothing was traced — an empty trace has no unattributed time."""
    ph = tracer.phase_seconds
    step = ph.get("step", 0.0)
    if step <= 0.0:
        return 1.0
    return min(sum(ph.get(s, 0.0) for s in STEP_SECTIONS) / step, 1.0)


def prometheus_text(summary: Dict[str, Any], tracer=None,
                    prefix: str = "repro_serving") -> str:
    """Prometheus-style text exposition of a ``ServingMetrics.summary()``
    dict (numeric fields only), plus per-phase seconds as one labelled
    series when a tracer is supplied."""
    lines = [f"# {prefix}: serving engine snapshot"]
    for k, v in summary.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        lines.append(f"{prefix}_{k} {v}")
    if tracer is not None:
        for name, secs in sorted(tracer.phase_seconds.items()):
            lines.append(
                f'{prefix}_phase_seconds{{phase="{name}"}} {secs}')
            lines.append(
                f'{prefix}_phase_calls{{phase="{name}"}} '
                f"{tracer.phase_counts.get(name, 0)}")
    return "\n".join(lines) + "\n"


__all__ = ["chrome_trace", "write_chrome_trace", "phase_snapshot",
           "phase_coverage", "prometheus_text", "STEP_SECTIONS",
           "LEAF_PHASES", "INFLIGHT_COUNTER", "PHASE_TIME_KEYS",
           "TRACED_ONLY_KEYS", "STEP_TIME_S", "PLAN_TIME_S",
           "DRAFT_TIME_S", "PREFILL_TIME_S", "DECODE_TIME_S",
           "VERIFY_TIME_S", "OTHER_TIME_S", "HOST_OVERHEAD_FRAC"]
