"""Milliseconds the card sat idle inside the MoE layer's ``moe.sorted``
ranges (the sorted route's grouping, its host sync and the loop over the
experts) of the profiled slice, over the number of ``prefill.chunk``
ranges there: the part of ``prefill_idle_ms.batch`` the route takes."""
from bench.core.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, "moe.sorted", per="prefill.chunk")
