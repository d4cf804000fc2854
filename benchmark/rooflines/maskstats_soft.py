"""Kernel A (``kernels/maskstats.py``, mask_stats_soft): its least time
on the step's inputs (:mod:`benchmark.rooflines.maskstats`)."""

from __future__ import annotations

from benchmark.rooflines.maskstats import bound_ms as _bound
from benchmark.rooflines.maskstats import step_inputs

CATEGORY = "A mask stats soft"


def bound_ms(ctx, outs: dict):
    if ctx.readout_soft is not True:
        return None
    protos_bytes = 2 if ctx.config["model"]["dtype"] == "bfloat16" else 4
    shape, grid, valid = step_inputs(ctx, outs)
    return _bound(True, shape, protos_bytes, grid, valid)
