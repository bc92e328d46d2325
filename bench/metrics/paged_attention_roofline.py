"""K1 (csrc/paged_attention.cu, paged decode over per-head pages): the
least time its decode steps need (``work.decode_kernel_time``) over its
device time in the slice (split merge in the same launch)."""
from bench.core.trace import kernel_seconds
from bench.core.work import decode_kernel_time, roofline_share


def read(ctx):
    if ctx.red is None or ctx.dims["mla"]:
        return None
    return roofline_share(decode_kernel_time(ctx.dims, ctx.groups, False),
                          kernel_seconds(ctx.red, ("paged_decode_kernel",)))
