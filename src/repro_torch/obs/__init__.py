"""repro_torch.obs — engine tracing and per-phase attribution.

The observability counterpart of the serving stack's user-transparency:
operators flip ``ServeConfig(trace=True)`` (or ``--trace out.json`` on any
launch entrypoint) and every serving cycle explains itself — phase spans on
the engine track, lifecycle spans per request, cache events from the page
pool — exportable as a Perfetto-loadable Chrome trace or folded into
``ServingMetrics.summary()`` as flat per-phase seconds.

Import discipline: this package depends on the standard library only (no
torch, no numpy) — it sits below every serving module that emits into it.
"""
from repro_torch.obs.export import (HOST_OVERHEAD_FRAC, INFLIGHT_COUNTER,
                              LEAF_PHASES, PHASE_TIME_KEYS, STEP_SECTIONS,
                              TRACED_ONLY_KEYS, chrome_trace,
                              phase_coverage, phase_snapshot,
                              prometheus_text, write_chrome_trace)
from repro_torch.obs.trace import (ENGINE_TRACK, NULL_TRACER, NullTracer, Tracer,
                             request_track)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "ENGINE_TRACK",
           "request_track", "chrome_trace", "write_chrome_trace",
           "phase_snapshot", "phase_coverage", "prometheus_text",
           "STEP_SECTIONS", "LEAF_PHASES", "INFLIGHT_COUNTER",
           "PHASE_TIME_KEYS", "TRACED_ONLY_KEYS", "HOST_OVERHEAD_FRAC"]
