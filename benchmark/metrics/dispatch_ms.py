"""Host ms of the call that hands a batch to the program
(``process_batch_async`` or ``step``), by the host clock around each call
of the window, averaged over the window's batches."""


def read(ctx):
    d = ctx.window["dispatch_s"]
    return 1e3 * sum(d) / len(d) if d else None
