"""Host ms of the program's ``to_host`` span less its ``to_host.wait``:
the read-back's copies after the first returned, which in the one-deep
loop run with nothing else queued on the card."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "readback_tail_ms")
