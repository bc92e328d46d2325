"""K6 (csrc/paged_mla.cu, absorbed MLA decode over latent pages of 576
values a token a layer): least time over device time in the slice."""
from bench.core.trace import kernel_seconds
from bench.core.work import decode_kernel_time, roofline_share


def read(ctx):
    if ctx.red is None or not ctx.dims["mla"]:
        return None
    return roofline_share(decode_kernel_time(ctx.dims, ctx.groups, True),
                          kernel_seconds(ctx.red,
                                         ("paged_mla_decode_kernel",)))
