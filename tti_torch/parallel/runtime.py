"""The inspection step for one model on one card (port of
``tti.parallel.runtime.InspectionPipeline``).

    uint8 BGR frames -> letterbox content -> two-pass undistort warp (emits
    space-to-depth blocks) -> YOLOv8-seg (s2d stem, folded BN) -> DFL decode
    -> batched NMS -> mask statistics (CUDA kernels) -> envelope -> px->mm

The reference's TPU defaults are fixed here, with no environment switches:
two-pass warp with s2d_out, s2d stem, folded BN, no fused head, no int8, no
lazy decode, exact top-k, dense warp weights. When the frames are rectified,
measurement runs with zero distortion and ``undistort_iters=0``: every pixel
coordinate after the warp is already ideal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tti_torch.calib.io import CalibrationData
from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
from tti_torch.measure.pipeline import (
    CameraParams, FrameMeasurement, StitchSet, measure_frame, prepare_frame_inputs,
)
from tti_torch.model.checkpoint import fold_batchnorm, from_flax_variables, stem_to_s2d
from tti_torch.model.yolo import RawPredictions, create_model, space_to_depth2
from tti_torch.postprocess.decode import Detections, decode_predictions
from tti_torch.postprocess.nms import batched_nms
from tti_torch.preprocess.letterbox import (
    LetterboxSpec, letterbox_content, letterbox_u8, make_letterbox_spec, scale_boxes_to_frame,
)
from tti_torch.preprocess.remap import build_small_undistort_map
from tti_torch.preprocess.warp2pass import TwoPassWarp


@dataclass
class PipelineOutputs:
    """Host-side results for one batch (numpy)."""

    boxes_frame: np.ndarray  # (B, D, 4) xyxy in (rectified) frame px
    scores: np.ndarray
    classes: np.ndarray
    valid: np.ndarray
    measurements: FrameMeasurement | None  # fields are (B,) numpy arrays
    stitches: StitchSet | None = None  # fields are (B, S) numpy arrays
    envelope: np.ndarray | None = None  # (B, Wm) mask-grid envelope
    telemetry: dict | None = None  # (B,) int32 counts vs the static budgets


def _to_host(obj: Any) -> Any:
    if obj is None:
        return None
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu().numpy()
                                       for f in dataclasses.fields(obj)})


class InspectionPipeline:
    """Owns the model, the warp and the calibration for one frame geometry.

    ``variables`` is the checkpoint's flax tree with numpy leaves (params +
    batch_stats), e.g. from :func:`tti_torch.model.checkpoint.load_flax_msgpack`.
    """

    def __init__(self, model_cfg: ModelConfig, variables: dict, frame_hw: tuple[int, int],
                 calibration: CalibrationData | None = None,
                 measure_cfg: MeasureConfig | None = None, roi: RoiConfig | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.measure_cfg = measure_cfg or MeasureConfig()
        self.frame_hw = frame_hw
        self.spec: LetterboxSpec = make_letterbox_spec(
            frame_hw[0], frame_hw[1], model_cfg.image_size, model_cfg.letterbox)
        self.dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32

        state = from_flax_variables(fold_batchnorm(stem_to_s2d(variables)))
        model = create_model(model_cfg.variant, nc=model_cfg.num_classes,
                             mask_stride=model_cfg.mask_stride,
                             proto_head=model_cfg.proto_head, s2d_input=True)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        self.model = model.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        self.model.to(memory_format=torch.channels_last)

        self.roi_bounds: tuple[float, float, float, float] | None = None
        if roi is not None and roi.enabled:
            h, w = frame_hw
            x1, x2 = max(0, min(roi.x_min, w - 1)), max(0, min(roi.x_max, w - 1))
            y1, y2 = max(0, min(roi.y_min, h - 1)), max(0, min(roi.y_max, h - 1))
            if x1 < x2 and y1 < y2:
                self.roi_bounds = (float(x1), float(y1), float(x2), float(y2))

        self.cam: CameraParams | None = None
        self.warp: TwoPassWarp | None = None
        self.calibration = calibration
        if calibration is not None:
            self.cam = CameraParams.from_calibration(calibration, self.device)
            small_map = build_small_undistort_map(calibration.K, calibration.dist, self.spec,
                                                  unpadded_src=True)
            # Raises for a vertically non-monotonic map: the gather fallback
            # (PackedRemap) is not ported.
            self.warp = TwoPassWarp(small_map, (self.spec.new_h, self.spec.new_w),
                                    s2d_out=True, device=self.device)
            # Rectified frames: measure with zero distortion, no iterations.
            self.cam = dataclasses.replace(self.cam, dist=torch.zeros_like(self.cam.dist))
            self.measure_cfg = dataclasses.replace(self.measure_cfg, undistort_iters=0)

    def preprocess(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 BGR (B, H, W, 3) on the device -> (B, H/2, W/2, 12) blocked
        model input in the compute dtype."""
        if self.warp is not None:
            content = letterbox_content(frames_u8, self.spec, self.dtype, decimate=True)
            return self.warp(content)
        return space_to_depth2(letterbox_u8(frames_u8, self.spec, self.dtype))

    def detect(self, raw: RawPredictions) -> tuple[Detections, dict]:
        """Raw head outputs -> DFL decode -> NMS, with budget telemetry."""
        mcfg = self.model_cfg
        boxes, probs, coefs = decode_predictions(raw)
        dets = batched_nms(boxes, probs, coefs, conf_thresh=mcfg.conf_thresh,
                           iou_thresh=mcfg.iou_thresh, max_det=mcfg.max_detections,
                           pre_topk=mcfg.nms_pre_topk)
        telemetry = {
            "n_candidates": (probs.amax(-1) > mcfg.conf_thresh).sum(-1).to(torch.int32),
            "n_valid": dets.valid.sum(-1).to(torch.int32),
        }
        return dets, telemetry

    def measure(self, dets: Detections, protos: torch.Tensor) -> dict:
        """Detections + protos -> mask statistics, stitch set, envelope and
        the mm measurements (requires a calibration)."""
        mcfg, cfg = self.model_cfg, self.measure_cfg
        stitches, envelope, fabric_any, counts = prepare_frame_inputs(
            dets, protos, self.spec, mcfg.stitch_class_id, mcfg.fabric_class_id,
            self.roi_bounds, cfg.max_stitches, cfg.max_stats_dets,
            subcell=bool(cfg.subcell_edge), subcell_envelope=cfg.envelope_subcell)
        return {"measurements": measure_frame(stitches, envelope, fabric_any, self.cam,
                                              self.spec, cfg),
                "stitches": stitches, "envelope": envelope, "counts": counts}

    def postprocess_chain(self, x: torch.Tensor) -> dict:
        """Model input -> forward, detect, measure and frame boxes (device
        tensors)."""
        raw = self.model(x)
        dets, telemetry = self.detect(raw)
        outs: dict[str, Any] = {"dets": dets, "telemetry": telemetry}
        if self.cam is not None:
            outs.update(self.measure(dets, raw.protos))
            telemetry.update(outs.pop("counts"))
        outs["boxes_frame"] = scale_boxes_to_frame(dets.boxes, self.spec)
        return outs

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor) -> dict:
        """One device step on frames already on the device."""
        return self.postprocess_chain(self.preprocess(frames_u8))

    def process_batch(self, frames_bgr_u8: np.ndarray) -> PipelineOutputs:
        """frames (B, H, W, 3) uint8 BGR -> host results (blocking)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr_u8)).to(self.device)
        return self.outputs_to_host(self.step(frames))

    @staticmethod
    def outputs_to_host(outs: dict) -> PipelineOutputs:
        dets = outs["dets"]
        env = outs.get("envelope")
        return PipelineOutputs(
            boxes_frame=outs["boxes_frame"].cpu().numpy(),
            scores=dets.scores.cpu().numpy(),
            classes=dets.classes.cpu().numpy(),
            valid=dets.valid.cpu().numpy(),
            measurements=_to_host(outs.get("measurements")),
            stitches=_to_host(outs.get("stitches")),
            envelope=None if env is None else env.cpu().numpy(),
            telemetry={k: v.cpu().numpy() for k, v in outs["telemetry"].items()},
        )
