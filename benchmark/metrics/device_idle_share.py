"""% of the traced segment's wall time in which no device operation ran
(kernels, copies and memsets: the union of their intervals)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / 1e6 / t["window_s"])
