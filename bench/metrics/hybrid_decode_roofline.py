"""K1 and K4 (csrc/paged_attention.cu, one symbol: paged decode over the
global layers' pages and the windowed layers' rings): the least time of
the slice's decode steps on both (``work_hybrid.decode_time``) over the
symbol's device time."""
from bench.core.trace import kernel_seconds
from bench.core.work import roofline_share
from bench.core.work_hybrid import decode_time, dims


def read(ctx):
    if ctx.red is None:
        return None
    return roofline_share(decode_time(dims(ctx.config), ctx.groups),
                          kernel_seconds(ctx.red, ("paged_decode_kernel",)))
