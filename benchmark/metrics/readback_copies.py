"""Device-to-host copies per read-back, the program's count
``d2h_copies``."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "readback_copies")
