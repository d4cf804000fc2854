"""The inspection step on one card, for one model or two (port of
``tti.parallel.runtime``: ``InspectionPipeline`` and ``DualPipeline``).

    uint8 BGR frames -> letterbox content -> two-pass undistort warp (emits
    space-to-depth blocks) -> YOLOv8-seg (s2d stem, folded BN) -> DFL decode
    -> batched NMS -> mask statistics (CUDA kernels) -> envelope -> px->mm

The reference's environment switches are constructor arguments here, at the
reference's defaults: ``remap`` ("twopass"; "packed" is the gather, also the
fallback for a vertically non-monotonic map), ``warp_s2d`` (the warp emits
the blocked input and the model takes it) and ``warp_pass1`` ("einsum";
"kernel" runs the fused CUDA pass-1 kernel at the point where the reference
notes its parked TPU kernel). Fixed: s2d stem, folded BN, no fused head, no
int8, no lazy decode, exact top-k, dense warp weights. When the frames are
rectified, measurement runs with zero distortion and ``undistort_iters=0``:
every pixel coordinate after the warp is already ideal.

Host-fed callers use ``process_batch_async`` + ``outputs_to_host``: the
upload goes from a pinned buffer on a side stream, the step waits on the
copy's event only, and nothing synchronises before ``outputs_to_host``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tti_torch.calib.io import CalibrationData
from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
from tti_torch.core.errors import ConfigError
from tti_torch.kernels.warp_p1 import warp_pass1_decimated
from tti_torch.measure.pipeline import (
    CameraParams, FrameMeasurement, StitchSet, measure_frame, prepare_frame_inputs,
)
from tti_torch.model.checkpoint import fold_batchnorm, from_flax_variables, stem_to_s2d
from tti_torch.model.yolo import (
    RawPredictions, create_model, depth_to_space2, space_to_depth2,
)
from tti_torch.postprocess.decode import Detections, decode_predictions
from tti_torch.postprocess.masks import assemble_masks
from tti_torch.postprocess.nms import batched_nms
from tti_torch.preprocess.letterbox import (
    LetterboxSpec, decimation_stride, letterbox_content, letterbox_u8, make_letterbox_spec,
    scale_boxes_to_frame,
)
from tti_torch.preprocess.remap import (
    PackedRemap, build_small_undistort_map, letterbox_then_undistort,
)
from tti_torch.preprocess.warp2pass import TwoPassWarp


@dataclass
class PipelineOutputs:
    """Host-side results for one batch (numpy)."""

    boxes_frame: np.ndarray  # (B, D, 4) xyxy in (rectified) frame px
    scores: np.ndarray
    classes: np.ndarray
    valid: np.ndarray
    masks: np.ndarray | None  # (B, D, Hm, Wm) proto-res binary, for rendering
    measurements: FrameMeasurement | None  # fields are (B,) numpy arrays
    stitches: StitchSet | None = None  # fields are (B, S) numpy arrays
    envelope: np.ndarray | None = None  # (B, Wm) mask-grid envelope
    telemetry: dict | None = None  # (B,) int32 counts vs the static budgets

    def budget_overflows(self, model_cfg: ModelConfig,
                         measure_cfg: MeasureConfig | None = None) -> dict[str, np.ndarray]:
        """Per-frame booleans: which static budgets this batch exceeded. An
        exceeded budget means the lowest-score rows were dropped at that
        stage; results remain valid but may under-count crowded scenes."""
        if not self.telemetry:
            return {}
        t = self.telemetry
        out = {"nms_pre_topk": t["n_candidates"] > model_cfg.nms_pre_topk}
        if "n_valid" in t:
            # A saturated output: the NMS max_det cap truncated survivors
            # (n_candidates counts before NMS; suppressed rows are no drops).
            out["max_detections"] = t["n_valid"] >= model_cfg.max_detections
        if measure_cfg is not None and "n_roi_valid" in t:
            out["max_stats_dets"] = t["n_roi_valid"] > measure_cfg.max_stats_dets
            out["max_stitches"] = t["n_stitches_raw"] > measure_cfg.max_stitches
        return out


def inference_model(model_cfg: ModelConfig, variables: dict, device: torch.device,
                    s2d_input: bool = True) -> torch.nn.Module:
    """The checkpoint's flax tree (numpy leaves) -> the inference form the
    port always runs: the space-to-depth stem and folded BatchNorm, in the
    config's compute dtype, channels_last, on ``device``. ``s2d_input``: the
    model takes the (B, H/2, W/2, 12) blocked input (else it blocks itself)."""
    state = from_flax_variables(fold_batchnorm(stem_to_s2d(variables)))
    model = create_model(model_cfg.variant, nc=model_cfg.num_classes,
                         mask_stride=model_cfg.mask_stride, proto_head=model_cfg.proto_head,
                         s2d_input=s2d_input)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
    model = model.to(device=device, dtype=dtype).eval().requires_grad_(False)
    return model.to(memory_format=torch.channels_last)


def _to_host(obj: Any) -> Any:
    if obj is None:
        return None
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu().numpy()
                                       for f in dataclasses.fields(obj)})


class _Uploader:
    """Host frames -> device, without a host synchronise: two pinned buffers
    per batch shape, used in turn, each copied on a side stream; the caller's
    stream waits on the copy's event. A buffer is handed out again only after
    its last copy has finished (its event), so it is never rewritten under a
    copy in flight. On a CPU device the buffers are plain arrays."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._slots: dict[tuple, list] = {}  # shape -> two [tensor, numpy view, copy event]
        self._turn: dict[tuple, int] = {}

    def _next_slot(self, shape: tuple[int, ...]) -> list:
        shape = tuple(shape)
        if shape not in self._slots:
            tensors = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.stream is not None)
                       for _ in range(2)]
            self._slots[shape] = [[t, t.numpy(), None] for t in tensors]
            self._turn[shape] = 0
        slot = self._slots[shape][self._turn[shape]]
        self._turn[shape] ^= 1
        if slot[2] is not None:
            slot[2].synchronize()  # that buffer's copy of two uploads ago
        return slot

    def staging(self, shape: tuple[int, ...]) -> np.ndarray:
        """The next host buffer of ``shape`` (uint8) for the caller to fill
        and hand to :meth:`upload`."""
        return self._next_slot(shape)[1]

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        slot = next((s for s in self._slots.get(frames.shape, ()) if s[1] is frames), None)
        if slot is None:  # not one of the staging buffers: copy it into the next
            slot = self._next_slot(frames.shape)
            np.copyto(slot[1], frames)
        if self.stream is None:
            return slot[0].clone()
        with torch.cuda.stream(self.stream):
            dev = slot[0].to(self.device, non_blocking=True)
            slot[2] = torch.cuda.Event()
            slot[2].record(self.stream)
        current = torch.cuda.current_stream(self.device)
        current.wait_event(slot[2])
        dev.record_stream(current)
        return dev


class InspectionPipeline:
    """Owns the model, the warp and the calibration for one frame geometry.

    ``variables`` is the checkpoint's flax tree with numpy leaves (params +
    batch_stats), e.g. from :func:`tti_torch.model.checkpoint.load_flax_msgpack`.

    ``undistort``: rectify the frames when there is a calibration.
    ``undistort_interp``: "bilinear" | "nearest" (nearest runs the gather).
    ``remap``: "twopass" (two dense products) | "packed" (``PackedRemap``);
    a map the two-pass warp cannot take falls back to the gather.
    ``warp_s2d``: the two-pass warp emits the space-to-depth blocked input and
    the model skips its own blocking.
    ``warp_pass1``: "einsum" | "kernel" (the fused CUDA pass-1 kernel; needs
    an exact decimation geometry and the two-pass warp).
    ``return_masks``: also return proto-resolution binary masks.
    """

    def __init__(self, model_cfg: ModelConfig, variables: dict, frame_hw: tuple[int, int],
                 calibration: CalibrationData | None = None,
                 measure_cfg: MeasureConfig | None = None, roi: RoiConfig | None = None,
                 device: str | torch.device = "cuda", return_masks: bool = False,
                 undistort: bool = True, undistort_interp: str = "bilinear",
                 remap: str = "twopass", warp_s2d: bool = True,
                 warp_pass1: str = "einsum") -> None:
        if remap not in ("twopass", "packed"):
            raise ConfigError(f"remap must be 'twopass' or 'packed', got {remap!r}")
        if warp_pass1 not in ("einsum", "kernel"):
            raise ConfigError(f"warp_pass1 must be 'einsum' or 'kernel', got {warp_pass1!r}")
        if undistort_interp not in ("bilinear", "nearest"):
            raise ConfigError(f"undistort_interp must be bilinear|nearest, got {undistort_interp!r}")
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.measure_cfg = measure_cfg or MeasureConfig()
        self.frame_hw = frame_hw
        self.return_masks = return_masks
        self.warp_pass1 = warp_pass1
        self.spec: LetterboxSpec = make_letterbox_spec(
            frame_hw[0], frame_hw[1], model_cfg.image_size, model_cfg.letterbox)
        self.dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32

        self.model = inference_model(model_cfg, variables, self.device, s2d_input=warp_s2d)

        self.roi_bounds: tuple[float, float, float, float] | None = None
        if roi is not None and roi.enabled:
            h, w = frame_hw
            x1, x2 = max(0, min(roi.x_min, w - 1)), max(0, min(roi.x_max, w - 1))
            y1, y2 = max(0, min(roi.y_min, h - 1)), max(0, min(roi.y_max, h - 1))
            if x1 < x2 and y1 < y2:
                self.roi_bounds = (float(x1), float(y1), float(x2), float(y2))

        self.cam: CameraParams | None = None
        self.warp: TwoPassWarp | PackedRemap | None = None
        self.calibration = calibration
        if calibration is not None:
            self.cam = CameraParams.from_calibration(calibration, self.device)
            if undistort:
                self.warp = self._build_warp(calibration, remap, undistort_interp, warp_s2d)
                # Rectified frames: measure with zero distortion, no iterations.
                self.cam = dataclasses.replace(self.cam, dist=torch.zeros_like(self.cam.dist))
                self.measure_cfg = dataclasses.replace(self.measure_cfg, undistort_iters=0)
        if warp_pass1 == "kernel":
            if decimation_stride(self.spec) is None:
                raise ConfigError(
                    "warp_pass1='kernel' needs an exact odd-integer decimation; "
                    f"{frame_hw} at imgsz {model_cfg.image_size} resizes by {self.spec.scale:g}")
            if not isinstance(self.warp, TwoPassWarp):
                raise ConfigError("warp_pass1='kernel' needs a calibration and the two-pass warp")
        self._uploader: _Uploader | None = None

    def _build_warp(self, calibration: CalibrationData, remap: str, interp: str,
                    warp_s2d: bool) -> TwoPassWarp | PackedRemap:
        small_map = build_small_undistort_map(calibration.K, calibration.dist, self.spec,
                                              unpadded_src=True)
        src_hw = (self.spec.new_h, self.spec.new_w)
        if remap == "twopass" and interp == "bilinear":
            try:
                return TwoPassWarp(small_map, src_hw, s2d_out=warp_s2d, device=self.device)
            except ValueError:  # non-monotonic vertical map: the gather takes it
                pass
        return PackedRemap(small_map, src_hw, interp=interp, device=self.device)

    def preprocess(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 BGR (B, H, W, 3) on the device -> the model input in the
        compute dtype: (B, H/2, W/2, 12) blocked when the model takes it so
        (the s2d-emitting warp gives that for free, every other path blocks
        here), else (B, H, W, 3)."""
        want_s2d = self.model.s2d_input
        if isinstance(self.warp, TwoPassWarp):
            if self.warp_pass1 == "kernel":
                k = decimation_stride(self.spec)
                i1 = warp_pass1_decimated(frames_u8, self.warp.w1, k=k, off=(k - 1) // 2,
                                          hs=self.spec.new_h, ws=self.spec.new_w,
                                          pad_value=self.warp.pad_value)
                out = self.warp.apply_pass2_ycbo(i1, self.dtype)
            else:
                out = self.warp(letterbox_content(frames_u8, self.spec, self.dtype, decimate=True))
            return out  # blocked iff the model takes it so: both follow ``warp_s2d``
        if self.warp is not None:
            out = letterbox_then_undistort(frames_u8, self.spec, self.warp, self.dtype)
        else:
            out = letterbox_u8(frames_u8, self.spec, self.dtype)
        return space_to_depth2(out) if want_s2d else out

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
        """Model input -> forward, detect, measure, optional masks and frame
        boxes (device tensors). ``DualPipeline`` runs it once per model on
        one preprocessed batch."""
        raw = self.model(x)
        dets, telemetry = self.detect(raw)
        outs: dict[str, Any] = {"dets": dets, "telemetry": telemetry}
        if self.cam is not None:
            outs.update(self.measure(dets, raw.protos))
            telemetry.update(outs.pop("counts"))
        if self.return_masks:
            outs["masks"] = assemble_masks(raw.protos, dets.coefs, dets.boxes, dets.valid,
                                           (self.spec.dst_h, self.spec.dst_w))
        outs["boxes_frame"] = scale_boxes_to_frame(dets.boxes, self.spec)
        return outs

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor) -> dict:
        """One device step on frames already on the device."""
        return self.postprocess_chain(self.preprocess(frames_u8))

    # -- host API ----------------------------------------------------------

    @property
    def uploader(self) -> _Uploader:
        if self._uploader is None:
            self._uploader = _Uploader(self.device)
        return self._uploader

    def staging_batch(self, shape: tuple[int, ...]) -> np.ndarray:
        """A host buffer (pinned on a CUDA device) for the next batch of
        ``shape``: fill it and pass it to :meth:`process_batch_async`, which
        then uploads it without another host copy."""
        return self.uploader.staging(shape)

    def process_batch(self, frames_bgr_u8: np.ndarray) -> PipelineOutputs:
        """frames (B, H, W, 3) uint8 BGR -> host results (blocking)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr_u8)).to(self.device)
        return self.outputs_to_host(self.step(frames))

    def process_batch_async(self, frames_bgr_u8: np.ndarray) -> dict:
        """Dispatch without blocking: device tensors come back, to be read
        later with :meth:`outputs_to_host`, so the host can prepare the next
        batch under the device's work on this one."""
        return self.step(self.uploader.upload(frames_bgr_u8))

    @staticmethod
    def outputs_to_host(outs: dict) -> PipelineOutputs:
        """Bring a device step result to the host (waits for it)."""
        dets = outs["dets"]
        env = outs.get("envelope")
        masks = outs.get("masks")
        return PipelineOutputs(
            boxes_frame=outs["boxes_frame"].cpu().numpy(),
            scores=dets.scores.cpu().numpy(),
            classes=dets.classes.cpu().numpy(),
            valid=dets.valid.cpu().numpy(),
            masks=None if masks is None else masks.cpu().numpy(),
            measurements=_to_host(outs.get("measurements")),
            stitches=_to_host(outs.get("stitches")),
            envelope=None if env is None else env.cpu().numpy(),
            telemetry={k: v.cpu().numpy() for k, v in outs["telemetry"].items()},
        )


class DualPipeline:
    """Two models on one preprocessed batch: the primary's preprocess runs
    once, then both models run their full chain (forward, NMS, telemetry and,
    where calibrated, measurement) on the same device buffer."""

    def __init__(self, primary: InspectionPipeline, secondary: InspectionPipeline) -> None:
        if primary.spec != secondary.spec:
            raise ValueError("dual pipelines must share letterbox geometry")
        if primary.device != secondary.device:
            raise ValueError("dual pipelines must share one device")
        if (primary.warp is None) != (secondary.warp is None):
            # The shared buffer is the primary's preprocess; a secondary built
            # for the other rectification state would measure in the wrong
            # coordinate space.
            raise ValueError("dual pipelines must agree on undistortion (both rectified or "
                             "both raw): the preprocessed batch is shared")
        if primary.warp is not None and not (
                np.array_equal(primary.calibration.K, secondary.calibration.K)
                and np.array_equal(primary.calibration.dist, secondary.calibration.dist)):
            # The batch is warped with the primary's lens model; the
            # secondary's own geometry would then give wrong millimetres.
            raise ValueError("dual rectified pipelines must share one calibration (K/dist): "
                             "the undistorted batch is produced with the primary's warp")
        if (isinstance(primary.warp, TwoPassWarp) and isinstance(secondary.warp, TwoPassWarp)
                and primary.warp.s2d_out == secondary.warp.s2d_out):
            # Same lens, geometry and blocking: identical weights. Only the
            # primary's preprocess runs here, so the secondary's copy is
            # dropped (and freed) and its standalone step shares this one.
            secondary.warp = primary.warp
        self.primary = primary
        self.secondary = secondary

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor) -> tuple[dict, dict]:
        """One device step on frames already on the device."""
        x = self.primary.preprocess(frames_u8)
        s2d_a, s2d_b = self.primary.model.s2d_input, self.secondary.model.s2d_input
        xb = x
        if s2d_a != s2d_b:  # the exact permutation either way
            xb = depth_to_space2(x) if s2d_a else space_to_depth2(x)
        return self.primary.postprocess_chain(x), self.secondary.postprocess_chain(xb)

    def process_batch(self, frames_bgr_u8: np.ndarray) -> tuple[PipelineOutputs, PipelineOutputs]:
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr_u8)).to(self.primary.device)
        outs_a, outs_b = self.step(frames)
        return (InspectionPipeline.outputs_to_host(outs_a),
                InspectionPipeline.outputs_to_host(outs_b))

    def process_batch_async(self, frames_bgr_u8: np.ndarray) -> tuple[dict, dict]:
        """Dispatch without blocking; read each element later with
        ``InspectionPipeline.outputs_to_host``."""
        return self.step(self.primary.uploader.upload(frames_bgr_u8))
