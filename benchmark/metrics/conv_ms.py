"""Device ms per batch in the "cuDNN convolution" category of the traced
segment (:func:`benchmark.trace.categorize`)."""

from benchmark.metrics import category_ms


def read(ctx):
    return category_ms(ctx, "cuDNN convolution")
