"""Milliseconds the card sat idle inside the engine's ``prefill.chunk``
ranges of the profiled slice, over the number of chunks there
(``phases.prefill_idle_ms``).

The same reader as ``prefill_idle_ms.batch``: a per-layer metric
moves one end-to-end metric, and the cells that report this quantity
move different ones.
"""
from bench.core.phases import prefill_idle_ms as read  # noqa: F401
