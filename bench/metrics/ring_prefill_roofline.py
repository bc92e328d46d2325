"""K5 (csrc/paged_ring_prefill.cu, the tensor-core body with RING true,
and its split merges) over the windowed layers' chunks at their window:
least time over device time in the slice."""
from bench.core.work import roofline_share
from bench.core.work_hybrid import dims, prefill_seconds, ring_prefill_time


def read(ctx):
    if ctx.red is None:
        return None
    return roofline_share(ring_prefill_time(dims(ctx.config), ctx.chunks),
                          prefill_seconds(ctx.red)[1])
