"""K2 (csrc/paged_prefill.cu over csrc/paged_prefill_body.cuh, chunked
prefill over per-head pages, its split merge included): the least time
of the chunks the slice ran over their device time."""
from bench.core.trace import kernel_seconds
from bench.core.work import prefill_kernel_time, roofline_share


def read(ctx):
    if ctx.red is None or ctx.dims["mla"]:
        return None
    dev = kernel_seconds(ctx.red, ("paged_prefill_wgmma_kernel",
                                   "paged_prefill_kernel",
                                   "prefill_merge_kernel"),
                         skip=("ring", "mla"))
    return roofline_share(prefill_kernel_time(ctx.dims, ctx.chunks), dev)
