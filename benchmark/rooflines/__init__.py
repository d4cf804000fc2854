"""Roofline counts of the hand-written kernels, one module per kernel,
found by name: ``bound_ms(ctx, outs) -> (ms, what bounds it, counts)``
for one launch on the inputs that the step whose host outputs are
``outs`` handed the kernel, or None where the cell's step does not launch
it; ``CATEGORY`` names its device operations (:func:`benchmark.trace.categorize`). The arithmetic is frozen from
``chip_smoke.py`` at commit bb8100e: bytes each input read once and each
output written once over the peak bandwidth, against the operations over
the peak for their type (:mod:`benchmark.peaks`)."""
