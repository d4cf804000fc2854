"""Host ms of the program's ``batch`` span, around each hand-over
(``process_batch_async`` or ``step``): ``dispatch_ms`` seen from inside."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "batch_host_ms")
