"""Bytes and operations of the mask-statistics kernels A (soft) and B
(binary), a frozen copy of ``kernel_bound_ms`` in ``chip_smoke.py`` at
commit bb8100e, on numpy inputs: protos (B, Hm, Wm, nm) of
``protos_bytes`` each, the (B, D) detections' boxes on the proto grid and
their validity. The protos cells that some valid box covers are read, with
the other inputs, and the per-detection outputs are written; 2 nm
operations per covered cell and detection (bf16 logits: tensor cores;
float32 logits: float32 FMA)."""

from __future__ import annotations

import numpy as np

from benchmark.peaks import HBM_BYTES_PER_S, PEAK_OPS


def bound_ms(soft: bool, protos_shape, protos_bytes: int, boxes_grid: np.ndarray,
             valid: np.ndarray) -> tuple[float, str, dict]:
    b, hm, wm, nm = protos_shape
    d = boxes_grid.shape[1]
    ys = np.arange(hm, dtype=np.float32).reshape(1, hm, 1)
    xs = np.arange(wm, dtype=np.float32).reshape(1, 1, wm)
    covered = cell_dets = 0
    for f in range(b):  # frame by frame: (D, Hm, Wm) at a time
        bx = boxes_grid[f].astype(np.float32)
        inside = ((xs >= bx[:, 0, None, None]) & (xs < bx[:, 2, None, None])
                  & (ys >= bx[:, 1, None, None]) & (ys < bx[:, 3, None, None])
                  & valid[f][:, None, None])
        covered += int(inside.any(0).sum())
        cell_dets += int(inside.sum())
    out_bytes = b * d * 4 * ((6 + 4 * wm) if soft else (3 + 2 * wm))
    in_bytes = covered * nm * protos_bytes + b * d * nm * 4 + b * d * 4 * 4 + b * d
    nbytes = in_bytes + out_bytes
    ops = 2.0 * nm * cell_dets
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["bf16" if soft else "f32"] * 1e3
    info = {"bytes": nbytes, "ops": ops}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def step_inputs(ctx, outs: dict) -> tuple[tuple, np.ndarray, np.ndarray]:
    """The kernel's inputs of one step, from the step's host outputs: the
    top ``max_stats_dets`` detections of each frame, their boxes back on
    the proto grid (frame px -> model input px -> grid; the frame boxes are
    clipped to the frame, so a box past its edge covers a little less than
    the kernel reads) and the ROI gate on their centres."""
    g, run = ctx.geometry, ctx.config["run"]
    top = run["measure"]["max_stats_dets"]
    boxes = outs["boxes_frame"][:, :top].astype(np.float64)
    hm, wm = ctx.proto_hw
    grid = boxes.copy()
    grid[..., 0::2] = (boxes[..., 0::2] * g.scale + g.pad_left) * (wm / g.dst_w)
    grid[..., 1::2] = (boxes[..., 1::2] * g.scale + g.pad_top) * (hm / g.dst_h)
    x1, y1, x2, y2 = ctx.roi
    cx = 0.5 * (boxes[..., 0] + boxes[..., 2])
    cy = 0.5 * (boxes[..., 1] + boxes[..., 3])
    valid = (outs["valid"][:, :top] & (cx >= x1) & (cx <= x2) & (cy >= y1) & (cy <= y2))
    return (boxes.shape[0], hm, wm, ctx.config["model"]["nm"]), grid, valid
