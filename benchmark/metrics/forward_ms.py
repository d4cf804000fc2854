"""Device ms of the program's ``forward`` span (``YOLOv8Seg.forward``) per
batch."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "forward")
