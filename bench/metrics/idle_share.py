"""The share of the profiled slice in which no kernel or copy ran on the
card: one less the union of their intervals over the slice."""


def read(ctx):
    if ctx.red is None or ctx.wall <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy / ctx.wall)
