"""Device ms from a batch's ``batch`` span's end to its ``to_host``
span's start: how long finished results wait on the stream behind later
work before their first copy runs."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "readback_queued_ms")
