"""repro_torch.obs — engine tracing and per-phase attribution.

The observability counterpart of the serving stack's user-transparency:
operators flip ``ServeConfig(trace=True)`` (or ``--trace out.json`` on any
launch entrypoint) and every serving cycle explains itself — phase spans on
the engine track, the card's intervals of the device phases on a device
track (stream events, no fences), lifecycle spans per request, cache
events from the page pool — exportable as a Perfetto-loadable Chrome trace
or folded into ``ServingMetrics.summary()`` as flat per-phase seconds.
While a ``torch.profiler`` session is active the same spans, traced or
not, are ``record_function`` ranges in its profile.

Import discipline: this package depends on the standard library only (no
torch, no numpy) — it sits below every serving module that emits into it;
``serving/profiling.py`` hands it torch's profiler and the card's clock.
"""
from repro_torch.obs.export import (INFLIGHT_COUNTER, chrome_trace,
                                    phase_snapshot, write_chrome_trace)
from repro_torch.obs.trace import (DEVICE_TRACK, ENGINE_TRACK, NULL_TRACER,
                                   NullTracer, Tracer, install_profiler,
                                   profile_range, request_track)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "ENGINE_TRACK",
           "DEVICE_TRACK", "request_track", "install_profiler",
           "profile_range", "chrome_trace", "write_chrome_trace",
           "phase_snapshot", "INFLIGHT_COUNTER"]
