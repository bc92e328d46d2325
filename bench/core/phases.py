"""The card's idle time inside the program's own ranges of a profile.

While a profile is active the engine enters its phases as
``record_function`` ranges (``step``, ``prefill.chunk``,
``decode.device``, ...), and the MoE layer its sorted route
(``moe.sorted``); ``reduce_profile`` keeps them among the slice's host
events.  The device's idle gaps that fall inside the ranges of one name
say how long the card waited while the program was in that phase: for
the host to launch an eager chunk, to sync and loop over the experts, to
upload a decode cycle's operands and launch its graph.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from bench.core.trace import union

Intervals = List[Tuple[float, float]]


def overlap(a: Intervals, b: Intervals) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(ctx, name: str, per: Optional[str] = None) -> Optional[float]:
    """Milliseconds the card was idle inside the ranges named ``name``
    (``ctx.gaps``, us), over the number of ranges named ``per`` (``name``
    by default); None where the slice has none of either, as in a program
    that enters no such range."""
    if ctx.red is None:
        return None
    host = ctx.red["host"]
    ranges = union([(s, e) for n, s, e in host if n == name])
    count = sum(1 for n, _, _ in host if n == (per or name))
    if not ranges or not count:
        return None
    return overlap(ctx.gaps, ranges) / 1e3 / count


def prefill_idle_ms(ctx) -> Optional[float]:
    """Idle card inside the engine's eager prefill chunks, a chunk."""
    return idle_ms(ctx, "prefill.chunk")
