"""Kernel D (``kernels/nms.py``, greedy_keep): its least time on the
step's (B, K) candidates, a frozen copy of ``nms_bound_ms`` in
``chip_smoke.py`` at commit bb8100e: bytes (boxes, classes and ok read
once, keep written once) over the bandwidth against 16 float32 operations
per candidate pair j < i (the IoU and the test) over the float32 peak."""

from __future__ import annotations

from benchmark.peaks import HBM_BYTES_PER_S, PEAK_OPS

CATEGORY = "D greedy NMS"


def bound(b: int, k: int) -> tuple[float, str, dict]:
    nbytes = b * k * (16 + 4 + 1 + 1)
    ops = 16.0 * b * k * (k - 1) / 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
    info = {"bytes": nbytes, "ops": ops}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def bound_ms(ctx, outs: dict):
    return bound(ctx.batch, ctx.config["run"]["nms"]["pre_topk"])
