"""The measurement pass on a batch of frames (port of ``tti.measure.pipeline``).

Detections + mask statistics -> per-stitch geometry, the fabric envelope and
the seam-allowance / stitch-width measurements in millimetres. The reference
vmaps a single-frame function; here every function carries the frame axis
as a leading batch dimension. Missing values are NaN.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tti_torch.calib.geometry import pixels_to_plane_mm, rodrigues
from tti_torch.core.config import MeasureConfig
from tti_torch.kernels.maskstats import mask_stats_binary, mask_stats_soft, subcell_col_extent
from tti_torch.measure.ops import kmeans_1d_two_clusters, masked_mean, masked_median
from tti_torch.postprocess.decode import Detections
from tti_torch.postprocess.nms import stable_topk
from tti_torch.preprocess.letterbox import (LetterboxSpec, jit_divide, map_xyxy,
                                            scale_boxes_to_frame)

Tensor = torch.Tensor


@dataclass(frozen=True)
class CameraParams:
    """Device-side calibration bundle (float32)."""

    K: Tensor  # (3,3)
    dist: Tensor  # (5,)
    R: Tensor  # (3,3)
    t: Tensor  # (3,)

    @staticmethod
    def from_calibration(calib, device: str | torch.device = "cuda") -> "CameraParams":
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
        return CameraParams(K=f32(calib.K), dist=f32(calib.dist),
                            R=rodrigues(f32(calib.rvec)), t=f32(np.asarray(calib.tvec).reshape(3)))


@dataclass
class FrameMeasurement:
    """Per-frame metrics, each (B,); NaN = absent."""

    edge_distance_mm: Tensor
    stitch_width_mm: Tensor
    raw_edge_mm: Tensor
    raw_width_mm: Tensor
    n_dist: Tensor  # int32: stitches used for the edge distance
    n_width: Tensor
    n_stitches: Tensor  # stitches after ROI gating
    fabric_detected: Tensor  # bool


@dataclass
class StitchSet:
    """Fixed-size per-stitch arrays (B, S) in frame pixel coordinates."""

    cx: Tensor
    cy: Tensor
    left: Tensor
    right: Tensor
    valid: Tensor  # bool


@dataclass
class MeasureState:
    """Ring buffers of one stream's temporal median."""

    dist_buf: Tensor  # (F,)
    width_buf: Tensor
    dist_n: Tensor  # int filled count
    width_n: Tensor
    dist_pos: Tensor  # int ring cursor
    width_pos: Tensor


def init_measure_state(frame_buffer: int = 8, device: str | torch.device = "cuda") -> MeasureState:
    zeros = torch.zeros(frame_buffer, dtype=torch.float32, device=device)
    zi = torch.zeros((), dtype=torch.int32, device=device)
    return MeasureState(zeros, zeros.clone(), zi, zi.clone(), zi.clone(), zi.clone())


# Mask grid <-> frame px. q is the ACTUAL proto stride (input / proto width):
# NEAREST-upsampling by q maps a cell centroid c to q*c + (q-1)/2 input px.
# The letterbox scale and q divide as tti's compiled step does
# (preprocess.letterbox.jit_divide): a true division would land an ulp away
# on the CPU, enough to flip the row split of stitches whose heights sit on
# the midpoint of the two rows. The constant terms are summed first, as XLA
# folds (a + c1) - c2 into a + (c1 - c2).


def mask_center_to_frame(x_mask: Tensor, pad: float, scale: float, q: float) -> Tensor:
    return jit_divide(x_mask * q + ((q - 1.0) / 2.0 - pad), scale)


def mask_left_to_frame(x_mask: Tensor, pad: float, scale: float, q: float) -> Tensor:
    return jit_divide(x_mask * q - pad, scale)


def mask_right_to_frame(x_mask: Tensor, pad: float, scale: float, q: float) -> Tensor:
    return jit_divide(x_mask * q + ((q - 1.0) - pad), scale)


def mask_bottom_to_frame(y_mask: Tensor, pad: float, scale: float, q: float) -> Tensor:
    """Envelope rows are bottom-most pixels: block bottom row = q*e + q-1."""
    return jit_divide(y_mask * q + ((q - 1.0) - pad), scale)


def frame_x_to_mask_col(x_frame: Tensor, pad: float, scale: float, q: float) -> Tensor:
    return jit_divide(x_frame * scale + pad, q)


def roi_center_gate(boxes_frame: Tensor, roi_bounds: tuple[float, float, float, float] | None
                    ) -> Tensor:
    """Keep detections whose bbox center lies inside the ROI."""
    if roi_bounds is None:
        return torch.ones(boxes_frame.shape[:-1], dtype=torch.bool, device=boxes_frame.device)
    x_min, y_min, x_max, y_max = roi_bounds
    cx = 0.5 * (boxes_frame[..., 0] + boxes_frame[..., 2])
    cy = 0.5 * (boxes_frame[..., 1] + boxes_frame[..., 3])
    return (cx >= x_min) & (cx <= x_max) & (cy >= y_min) & (cy <= y_max)


def prepare_frame_inputs(
    dets: Detections,
    protos: Tensor,
    spec: LetterboxSpec,
    stitch_class_id: int,
    fabric_class_id: int,
    roi_bounds: tuple[float, float, float, float] | None,
    max_stitches: int,
    max_stats_dets: int = 64,
    subcell: bool = False,
    subcell_envelope: bool | None = None,
    logits_dtype: torch.dtype | None = None,
) -> tuple[StitchSet, Tensor, Tensor, dict]:
    """Split classes, gate by ROI, reduce the mask statistics and build the
    stitch set and the fabric envelope, for (B, D) detections and (B, Hm, Wm,
    nm) protos. The top ``max_stats_dets`` rows (NMS emits them score-sorted)
    enter the statistics: kernel A (soft) when either readout is sub-cell,
    else kernel B (binary), with mask logits in ``logits_dtype`` (None: the
    reference's policy, bfloat16 soft and float32 binary). Returns (StitchSet (B, max_stitches),
    envelope (B, Wm) int32 rows, or float crossings when the envelope is
    sub-cell, fabric_any (B,), counts of (B,) int32 for budget telemetry)."""
    input_hw = (spec.dst_h, spec.dst_w)
    hm, wm = protos.shape[1], protos.shape[2]

    in_roi_full = roi_center_gate(scale_boxes_to_frame(dets.boxes, spec), roi_bounds) & dets.valid
    counts = {
        "n_roi_valid": in_roi_full.sum(-1).to(torch.int32),
        "n_stitches_raw": (in_roi_full & (dets.classes == stitch_class_id)).sum(-1).to(torch.int32),
    }
    if max_stats_dets and dets.boxes.shape[1] > max_stats_dets:
        dets = dets.map(lambda a: a[:, :max_stats_dets])
        in_roi = in_roi_full[:, :max_stats_dets]
    else:
        in_roi = in_roi_full
    is_stitch = in_roi & (dets.classes == stitch_class_id)
    is_fabric = in_roi & (dets.classes == fabric_class_id)

    sx, sy = wm / input_hw[1], hm / input_hw[0]
    boxes_grid = map_xyxy(dets.boxes, lambda x: x * sx, lambda y: y * sy)
    env_subcell = subcell if subcell_envelope is None else subcell_envelope
    soft = subcell or env_subcell
    stats_fn = mask_stats_soft if soft else mask_stats_binary
    if logits_dtype is None:
        logits_dtype = torch.bfloat16 if soft else torch.float32
    stats = stats_fn(protos.contiguous(), dets.coefs.contiguous(), boxes_grid,
                     in_roi.contiguous(), logits_dtype=logits_dtype)
    if env_subcell:
        envelope = torch.where(is_fabric[..., None], stats["bottom_sub"], -1.0).amax(1)
    else:
        envelope = torch.where(is_fabric[..., None], stats["bottom"], -1.0).amax(1)
        envelope = envelope.to(torch.int32)
    fabric_any = (is_fabric & (stats["m00"] > 0)).any(-1)

    # Compact the stitch rows to max_stitches, keeping the score order.
    stitch_rank = torch.where(is_stitch, dets.scores, -1.0)
    _, order = stable_topk(stitch_rank, min(max_stitches, stitch_rank.shape[1]))
    take = lambda a: torch.gather(a, 1, order)
    take_rows = lambda a: torch.gather(a, 1, order[..., None].expand(-1, -1, a.shape[-1]))
    sel_valid = take(is_stitch)
    q = input_hw[1] / wm
    bsel = take_rows(boxes_grid)

    if subcell:
        m00s = take(stats["m00s"])
        has_mask = (m00s > 1e-6) & sel_valid
        cx_m = take(stats["m10s"]) / torch.clamp(m00s, min=1e-6)
        cy_m = take(stats["m01s"]) / torch.clamp(m00s, min=1e-6)
        left_m, right_m, _ = subcell_col_extent(take_rows(stats["col_p"]))
        # Bbox fallback, from grid coords g (input px g*q) into center-mapped
        # crossing units c (input px c*q + (q-1)/2).
        dlt = (q - 1.0) / (2.0 * q)
        cx_m = torch.where(has_mask, cx_m, 0.5 * (bsel[..., 0] + bsel[..., 2]) - dlt)
        cy_m = torch.where(has_mask, cy_m, 0.5 * (bsel[..., 1] + bsel[..., 3]) - dlt)
        left_m = torch.where(has_mask, left_m, bsel[..., 0] - dlt)
        right_m = torch.where(has_mask, right_m, bsel[..., 2] - dlt)
        stitches = StitchSet(
            cx=mask_center_to_frame(cx_m, spec.pad_left, spec.scale, q),
            cy=mask_center_to_frame(cy_m, spec.pad_top, spec.scale, q),
            left=mask_center_to_frame(left_m, spec.pad_left, spec.scale, q),
            right=mask_center_to_frame(right_m, spec.pad_left, spec.scale, q),
            valid=sel_valid,
        )
        return stitches, envelope, fabric_any, counts

    m00 = take(stats["m00"])
    has_mask = (m00 > 1e-6) & sel_valid
    cx_m = take(stats["m10"]) / torch.clamp(m00, min=1e-6)
    cy_m = take(stats["m01"]) / torch.clamp(m00, min=1e-6)
    col_any = (take_rows(stats["col_any"]) > 0).to(torch.uint8)
    left_m = col_any.argmax(-1).float()
    right_m = (wm - 1 - col_any.flip(-1).argmax(-1)).float()
    # Bbox fallback for empty masks.
    cx_m = torch.where(has_mask, cx_m, 0.5 * (bsel[..., 0] + bsel[..., 2]))
    cy_m = torch.where(has_mask, cy_m, 0.5 * (bsel[..., 1] + bsel[..., 3]))
    left_m = torch.where(has_mask, left_m, bsel[..., 0])
    right_m = torch.where(has_mask, right_m, bsel[..., 2])
    stitches = StitchSet(
        cx=mask_center_to_frame(cx_m, spec.pad_left, spec.scale, q),
        cy=mask_center_to_frame(cy_m, spec.pad_top, spec.scale, q),
        left=mask_left_to_frame(left_m, spec.pad_left, spec.scale, q),
        right=mask_right_to_frame(right_m, spec.pad_left, spec.scale, q),
        valid=sel_valid,
    )
    return stitches, envelope, fabric_any, counts


def _sample_envelope_frame(envelope: Tensor, cx_frame: Tensor, spec: LetterboxSpec,
                           neighborhood: int, subcell: bool = False) -> tuple[Tensor, Tensor]:
    """Median envelope height (frame px) over the +-neighborhood frame
    columns around each centroid; envelope (B, W), cx_frame (B, S)."""
    b, w = envelope.shape
    q = spec.dst_w / w
    offs = torch.arange(-neighborhood, neighborhood + 1, dtype=torch.float32,
                        device=envelope.device)
    cols_f = frame_x_to_mask_col(cx_frame[..., None] + offs, spec.pad_left, spec.scale, q)
    cols = torch.clamp(cols_f.to(torch.int32), 0, w - 1).to(torch.int64)
    vals = torch.gather(envelope.float(), 1, cols.reshape(b, -1)).reshape(cols.shape)
    med, has = masked_median(vals, vals >= 0)
    to_frame = mask_center_to_frame if subcell else mask_bottom_to_frame
    return torch.where(has, to_frame(med, spec.pad_top, spec.scale, q), 0.0), has


def measure_frame(stitches: StitchSet, envelope: Tensor, fabric_any: Tensor,
                  cam: CameraParams, spec: LetterboxSpec, cfg: MeasureConfig
                  ) -> FrameMeasurement:
    """The reference measurement steps on a batch of stitch sets: widths
    from all stitches, row selection, edge distances for the near row, and
    means gated on ``min_stitches``."""
    valid = stitches.valid
    n_stitches = valid.sum(-1)
    any_stitch = n_stitches > 0
    to_mm = lambda pts: pixels_to_plane_mm(pts, cam.K, cam.dist, cam.R, cam.t,
                                           iters=cfg.undistort_iters)

    # STEP 1: widths from all stitches, both endpoints in one call.
    width_pts = torch.stack([torch.stack([stitches.left, stitches.cy], -1),
                             torch.stack([stitches.right, stitches.cy], -1)], dim=2)
    w_mm, w_ok = to_mm(width_pts)
    widths = torch.linalg.norm(w_mm[:, :, 1] - w_mm[:, :, 0], dim=-1)
    width_valid = valid & w_ok[..., 0] & w_ok[..., 1]

    # STEP 2: row selection.
    env_y, has_env = _sample_envelope_frame(envelope, stitches.cx, spec,
                                            cfg.envelope_neighborhood,
                                            subcell=cfg.envelope_subcell)
    multi = (n_stitches >= 2)[:, None]
    if cfg.skip_cluster:
        med_y, _ = masked_median(stitches.cy, valid)
        big = 1e9
        y_range = (torch.where(valid, stitches.cy, -big).amax(-1)
                   - torch.where(valid, stitches.cy, big).amin(-1))
        split = multi & (y_range > cfg.two_row_threshold_px)[:, None]
        selected = valid & torch.where(split, stitches.cy >= med_y[:, None], True)
    else:
        labels, _ = kmeans_1d_two_clusters(stitches.cy, valid)
        env_mean, env_has = masked_mean(envelope.float(), envelope >= 0)
        q_env = spec.dst_w / envelope.shape[-1]
        env_to_frame = mask_center_to_frame if cfg.envelope_subcell else mask_bottom_to_frame
        fabric_mean_y = env_to_frame(env_mean, spec.pad_top, spec.scale, q_env)
        c0_mean, c0_has = masked_mean(stitches.cy, valid & (labels == 0))
        c1_mean, c1_has = masked_mean(stitches.cy, valid & (labels == 1))
        c0_dist = torch.where(c0_has, torch.abs(c0_mean - fabric_mean_y), 1e9)
        c1_dist = torch.where(c1_has, torch.abs(c1_mean - fabric_mean_y), 1e9)
        chosen = torch.where(env_has & ~(c0_dist < c1_dist), 1, 0)[:, None]
        selected = valid & torch.where(multi, labels == chosen, True)

    # Envelope-proximity gate, falling back to the selected row.
    near = selected & has_env & (torch.abs(stitches.cy - env_y) < cfg.max_px_distance)
    final = torch.where(near.any(-1, keepdim=True), near, selected)

    # STEP 3: edge distances for the near row.
    edge_pts = torch.stack([torch.stack([stitches.cx, stitches.cy], -1),
                            torch.stack([stitches.cx, env_y], -1)], dim=2)
    e_mm, e_ok = to_mm(edge_pts)
    dists = torch.linalg.norm(e_mm[:, :, 1] - e_mm[:, :, 0], dim=-1)
    dist_valid = final & has_env & e_ok[..., 0] & e_ok[..., 1]

    # STEP 4: means gated on min_stitches, plus the readout calibration.
    n_dist = dist_valid.sum(-1)
    n_width = width_valid.sum(-1)
    avg_dist = masked_mean(dists, dist_valid)[0] + cfg.cal_edge_mm
    avg_width = masked_mean(widths, width_valid)[0] + cfg.cal_width_mm
    usable = fabric_any & any_stitch
    raw_edge = torch.where(usable & (n_dist >= cfg.min_stitches), avg_dist, float("nan"))
    raw_width = torch.where(usable & (n_width >= cfg.min_stitches), avg_width, float("nan"))
    return FrameMeasurement(
        edge_distance_mm=raw_edge,
        stitch_width_mm=raw_width,
        raw_edge_mm=raw_edge,
        raw_width_mm=raw_width,
        n_dist=torch.where(usable, n_dist, 0).to(torch.int32),
        n_width=torch.where(usable, n_width, 0).to(torch.int32),
        n_stitches=n_stitches.to(torch.int32),
        fabric_detected=fabric_any,
    )


def _push_and_median(buf: Tensor, n: Tensor, pos: Tensor, value: Tensor):
    has = ~torch.isnan(value)
    f = buf.shape[0]
    pushed = buf.clone()
    pushed[pos.long()] = torch.nan_to_num(value)
    new_buf = torch.where(has, pushed, buf)
    new_n = torch.where(has, torch.clamp(n + 1, max=f), n)
    new_pos = torch.where(has, (pos + 1) % f, pos)
    med, any_valid = masked_median(new_buf, torch.arange(f, device=buf.device) < new_n)
    return new_buf, new_n, new_pos, torch.where(has & any_valid, med, float("nan"))


def smooth_measurement(state: MeasureState, meas: FrameMeasurement
                       ) -> tuple[MeasureState, FrameMeasurement]:
    """Median-of-window smoothing for one stream's frame (scalar fields): a
    frame with a value pushes it and reads the window median; a frame
    without one reports NaN and leaves the window untouched."""
    d_buf, d_n, d_pos, d_med = _push_and_median(state.dist_buf, state.dist_n,
                                                state.dist_pos, meas.raw_edge_mm)
    w_buf, w_n, w_pos, w_med = _push_and_median(state.width_buf, state.width_n,
                                                state.width_pos, meas.raw_width_mm)
    return (MeasureState(d_buf, w_buf, d_n, w_n, d_pos, w_pos),
            dataclasses.replace(meas, edge_distance_mm=d_med, stitch_width_mm=w_med))
