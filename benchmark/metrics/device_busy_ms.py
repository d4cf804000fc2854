"""Device busy ms per batch in the traced segment (the union of the device
operations' intervals over the steps)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_us"] <= 0:
        return None
    return t["busy_us"] / 1e3 / t["steps"]
