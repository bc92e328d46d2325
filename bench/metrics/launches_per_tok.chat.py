"""Kernel and graph launches the host made in the profiled slice, per
output token computed there (``work.launches_per_token``).

The same reader as ``launches_per_tok.batch``: a per-layer metric
moves one end-to-end metric, and the cells that report this quantity
move different ones.
"""
from bench.core.work import launches_per_token as read  # noqa: F401
