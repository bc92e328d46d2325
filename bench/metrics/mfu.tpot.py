"""The whole step's share of the card's bf16 peak in the profiled slice
(``work.step_mfu``).

The same reader as ``mfu.serve``: a per-layer metric moves one end-to-end
metric, and the cells that report this quantity move different ones.
"""
from bench.core.work import step_mfu as read  # noqa: F401
