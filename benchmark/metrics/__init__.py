"""Per-layer metric readers, one module per metric, named as the metric in
``BENCHMARK.json``: ``read(ctx) -> float | None`` from the run's
:class:`benchmark.harness.Context` (the window's host-clock records, the
traced segment's device operations, the step's outputs). A reader that
finds nothing to read returns None and the metric is left out of the
line; none returns 0 for a share of a roofline or a peak."""

from __future__ import annotations

import importlib

from benchmark.trace import categorize


def device_ms(ctx, match) -> float | None:
    """Device ms per step of the traced operations whose name ``match``
    accepts, or None where the trace has none."""
    if ctx.trace is None:
        return None
    durs = [d for name, _, _, d in ctx.trace["ops"] if match(name)]
    return sum(durs) / 1e3 / ctx.trace["steps"] if durs else None


def category_ms(ctx, category: str) -> float | None:
    return device_ms(ctx, lambda name: categorize(name) == category)


def roofline_share(ctx, kernel: str) -> float | None:
    """% of the kernel's least time (``benchmark/rooflines/<kernel>.py``,
    averaged over the steps whose outputs the run kept) that its traced
    device time per launch reaches; one launch per step."""
    mod = importlib.import_module(f"benchmark.rooflines.{kernel}")
    ms = category_ms(ctx, mod.CATEGORY)
    bounds = [mod.bound_ms(ctx, outs) for outs in ctx.step_outputs]
    if ms is None or not bounds or any(b is None for b in bounds):
        return None
    return 100.0 * sum(b[0] for b in bounds) / len(bounds) / ms
