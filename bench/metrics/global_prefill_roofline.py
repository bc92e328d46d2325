"""K2 (csrc/paged_prefill.cu, the tensor-core body with RING false, and
its split merges) over the global layers' chunks: least time over device
time in the slice."""
from bench.core.work import roofline_share
from bench.core.work_hybrid import dims, global_prefill_time, prefill_seconds


def read(ctx):
    if ctx.red is None:
        return None
    return roofline_share(global_prefill_time(dims(ctx.config), ctx.chunks),
                          prefill_seconds(ctx.red)[0])
