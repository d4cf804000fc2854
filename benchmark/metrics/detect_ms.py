"""Device ms of the program's ``detect`` span (DFL decode and NMS) per
batch."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "detect")
