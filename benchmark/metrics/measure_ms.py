"""Device ms of the program's ``measure`` span (mask statistics, stitches,
envelope, millimetres) per batch."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "measure")
