"""Device ms of the program's ``preprocess`` span (letterbox and the
two-pass warp) per batch."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "preprocess")
