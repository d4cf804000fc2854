"""The inspection step on one card, for one model or two (port of
``tti.parallel.runtime``: ``InspectionPipeline`` and ``DualPipeline``).

    uint8 BGR frames -> letterbox content -> two-pass undistort warp (emits
    space-to-depth blocks) -> YOLOv8-seg (s2d stem, folded BN) -> DFL decode
    -> batched NMS -> mask statistics (CUDA kernels) -> envelope -> px->mm

The reference's environment switches are constructor arguments here, at the
reference's defaults (:class:`tti_torch.core.config.RuntimeSwitches` parses
them from the environment): ``remap`` ("twopass"; "packed" is the gather,
also the fallback for a vertically non-monotonic map), ``warp_s2d`` (the
warp emits the blocked input and the model takes it), ``warp_pass1``
("einsum"; "kernel" runs the fused CUDA pass-1 kernel at the point where the
reference notes its parked TPU kernel), ``warp_block`` and
``warp_col_expand`` (the banded and the column-expanded two-pass warp),
``lazy_decode``
(DFL decode for the NMS candidates only), ``fused_head`` (one entry conv
per head level), ``fold_bn``, ``maskstats_logits`` (the mask-logit dtype
of both readouts) and ``quant`` / ``quant_scales`` (``TTI_QUANT``: int8
W8A8 ``Conv`` blocks through kernels E and F, dynamic per-sample or
calibrated static activation scales). Fixed: the s2d stem, exact top-k.
When the frames are rectified, measurement runs with zero distortion and
``undistort_iters=0``: every pixel coordinate after the warp is already
ideal.

Host-fed callers use ``process_batch_async`` + ``outputs_to_host``: the
upload goes from a pinned buffer on a side stream, the step waits on the
copy's event only, and nothing synchronises before ``outputs_to_host``.

Spans and counts (:mod:`tti_torch.core.logging`, recorded only while the
process's tracer is on): ``batch`` around each entry point, its id the
pipeline's step number, over ``upload`` (``upload.wait`` where a staging
buffer's last copy still runs), ``preprocess``, ``forward`` and its blocks,
``detect`` and ``measure``; ``to_host`` around ``outputs_to_host``, over
``to_host.wait`` until the first copy returns, and the count
``d2h_copies``. While tracing, the step's outputs carry the batch id
(:data:`TRACE_BATCH`) to ``outputs_to_host``.

With a ``mesh`` (:func:`tti_torch.parallel.mesh.create_mesh`, one process
per card) the entry points take the global batch, as the reference's
sharded step does: each rank runs the unchanged step on its rows
(:func:`tti_torch.parallel.mesh.batch_slice`) on its own card, with the
weights, warp and calibration replicated, and one all-gather gives every
rank the global batch's outputs. Callers never branch.

On a ``("data", "space")`` mesh (``tti``'s ``frame_sharding``: the frame's
height over the ``space`` axis, the one mesh shape that cuts the latency of
one frame) every rank of a space group takes the same frames and computes
one slab of the model input's rows (:mod:`tti_torch.parallel.spatial`):
the preprocess emits only those rows (the warp's :meth:`TwoPassWarp.rows`,
the gather's :meth:`PackedRemap.rows`, the letterbox's ``rows``), the
forward exchanges each convolution's and pool's halo rows with the
neighbouring slabs, and each head level's output and the protos are
gathered along H before detect and measure, which then run whole on every
rank of the group. The banded warp (``warp_block``) is cut there too: its
pass-2 bands at the slab's rows, its pass-1 bands to the slab's source rows.
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
from tti_torch.core.logging import count, get_logger, span
from tti_torch.kernels.warp_p1 import card_geometry_error, warp_pass1_decimated
from tti_torch.measure.pipeline import (
    CameraParams, FrameMeasurement, StitchSet, measure_frame, prepare_frame_inputs,
)
from tti_torch.model.checkpoint import (
    fold_batchnorm, from_flax_variables, fuse_head_entries, stem_to_s2d,
)
from tti_torch.model.layers import BatchNorm, Conv
from tti_torch.model.quantize import check_quant, load_act_scales, quantize_weights
from tti_torch.model.yolo import (
    RawPredictions, create_model, depth_to_space2, space_to_depth2,
)
from tti_torch.parallel.mesh import batch_slice, gather_batch
from tti_torch.parallel.spatial import set_space, space_of
from tti_torch.postprocess.decode import Detections, decode_predictions
from tti_torch.postprocess.masks import assemble_masks
from tti_torch.postprocess.nms import batched_nms, nms_from_raw, raw_candidate_counts
from tti_torch.preprocess.letterbox import (
    LetterboxSpec, decimation_stride, letterbox_u8, make_letterbox_spec, scale_boxes_to_frame,
)
from tti_torch.preprocess.remap import (
    PackedRemap, build_small_undistort_map, letterbox_then_undistort,
)
from tti_torch.preprocess.warp2pass import TwoPassWarp

log = get_logger("runtime")

MASKSTATS_LOGITS = {"auto": None, "f32": torch.float32, "bf16": torch.bfloat16}
TRACE_BATCH = "trace_batch"  # the step outputs' batch id, while tracing


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
                    s2d_input: bool = True, fused_head: bool = False,
                    fold_bn: bool = True, quant: str = "", quant_scales: str | None = None,
                    s2d_stem: bool = True) -> torch.nn.Module:
    """The checkpoint's flax tree (numpy leaves) -> the inference form the
    step serves: the space-to-depth stem, then (``fused_head``) the fused
    head entries, then (``fold_bn``) folded BatchNorm, then (``quant``
    "int8" | "int8s") the int8 weights, in the reference's order; in the
    config's compute dtype, channels_last, on ``device``. Unfolded, the
    BatchNorm layers keep float32 parameters and running statistics and
    normalise with those (eval mode); quantized, the blocks' scales and
    bias stay float32. ``s2d_input``: the model takes the (B, H/2, W/2, 12)
    blocked input (else it blocks itself). ``quant_scales``: the
    calibration file of the block scales ``int8s`` needs
    (:func:`load_act_scales`); a file made on the plain-stem model names the
    stem ``m0``, which the s2d stem serves as ``m0s2d`` (the same weights,
    relabelled). A ``quant`` that cannot apply raises ``ConfigError`` with
    the reference's message (:func:`check_quant`, :func:`load_act_scales`).
    ``s2d_stem=False`` keeps the plain k3/s2 stem (``eval``'s int8 model,
    as the reference serves it)."""
    check_quant(quant, fold_bn, fused_head)
    scales = load_act_scales(quant_scales) if quant == "int8s" else None
    tree = stem_to_s2d(variables) if s2d_stem else variables
    if fused_head:
        tree = fuse_head_entries(tree)
    if fold_bn:
        tree = fold_batchnorm(tree)
    if quant:
        if scales is not None and s2d_stem and "m0" in scales and "m0s2d" not in scales:
            scales["m0s2d"] = scales.pop("m0")
        tree = quantize_weights(tree, act_scales=scales)
    state = from_flax_variables(tree)
    model = create_model(model_cfg.variant, nc=model_cfg.num_classes,
                         mask_stride=model_cfg.mask_stride, proto_head=model_cfg.proto_head,
                         s2d_input=s2d_input, s2d_stem=s2d_stem, folded_bn=fold_bn,
                         fused_head=fused_head, qmode=quant)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
    model = model.to(device=device).eval().requires_grad_(False)
    # The quantized blocks' float32 buffers, put back after the cast.
    keep = [(m, name, getattr(m, name)) for m in model.modules()
            if isinstance(m, Conv) and m.qmode
            for name in ("qscale", "bias", "ascale") if hasattr(m, name)]
    model = model.to(dtype=dtype)
    for m, name, buf in keep:
        setattr(m, name, buf)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.float()
    return model.to(memory_format=torch.channels_last)


def _to_host(obj: Any, host) -> Any:
    if obj is None:
        return None
    return dataclasses.replace(obj, **{f.name: host(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


def _tagged(outs, batch_span):
    """The step's outputs (a dict, or one per model), carrying the batch
    id while tracing."""
    if batch_span is not None:
        for o in (outs if isinstance(outs, tuple) else (outs,)):
            o[TRACE_BATCH] = batch_span.batch
    return outs


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
            with span("upload.wait"):
                slot[2].synchronize()  # that buffer's copy of two uploads ago
        return slot

    def staging(self, shape: tuple[int, ...]) -> np.ndarray:
        """The next host buffer of ``shape`` (uint8) for the caller to fill
        and hand to :meth:`upload`."""
        return self._next_slot(shape)[1]

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        with span("upload", self.device, stream=self.stream):
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
    an exact decimation geometry and the dense two-pass warp: kernel C reads
    dense ``W1`` and decimates itself, so neither ``warp_block`` nor
    ``warp_col_expand`` goes with it; a geometry the kernel never takes,
    ``warp_p1.card_geometry_error``, is refused on every device).
    ``warp_block``: the two-pass warp's band width (None: dense weights).
    ``warp_col_expand``: the two-pass warp resamples the columns of an exact
    decimation in pass 1 and takes row-sliced frames; without an exact
    decimation it has no effect (logged).
    ``lazy_decode``: rank anchors by raw logit and decode DFL for the NMS
    candidates only (:func:`nms_from_raw`).
    ``fused_head``: one entry conv per head level. ``fold_bn``: serve folded
    BatchNorm (False: BatchNorm with running statistics).
    ``quant``: "" | "int8" (W8A8, each sample's activation scale from
    kernel F) | "int8s" (W8A8, the static scales of the JSON file
    ``quant_scales`` from ``tools/calibrate_int8_torch.py`` or
    ``tools/calibrate_int8.py``); needs folded BatchNorm and no fused head.
    ``maskstats_logits``: "auto" (bf16 soft, f32 binary) | "f32" | "bf16",
    the mask-logit dtype of both readouts.
    ``return_masks``: also return proto-resolution binary masks.
    ``mesh``: a ``DeviceMesh`` of this process's card type, ``("data",)``
    or ``("data", "space")`` (the module's docstring).
    """

    def __init__(self, model_cfg: ModelConfig, variables: dict, frame_hw: tuple[int, int],
                 calibration: CalibrationData | None = None,
                 measure_cfg: MeasureConfig | None = None, roi: RoiConfig | None = None,
                 device: str | torch.device = "cuda", return_masks: bool = False,
                 undistort: bool = True, undistort_interp: str = "bilinear",
                 remap: str = "twopass", warp_s2d: bool = True,
                 warp_pass1: str = "einsum", warp_block: int | None = None,
                 warp_col_expand: bool = False, lazy_decode: bool = False,
                 fused_head: bool = False, fold_bn: bool = True,
                 maskstats_logits: str = "auto", quant: str = "",
                 quant_scales: str | None = None, mesh=None) -> None:
        if remap not in ("twopass", "packed"):
            raise ConfigError(f"remap must be 'twopass' or 'packed', got {remap!r}")
        if warp_pass1 not in ("einsum", "kernel"):
            raise ConfigError(f"warp_pass1 must be 'einsum' or 'kernel', got {warp_pass1!r}")
        if maskstats_logits not in MASKSTATS_LOGITS:
            raise ConfigError(f"maskstats_logits must be one of {sorted(MASKSTATS_LOGITS)}, "
                              f"got {maskstats_logits!r}")
        if warp_block is not None and warp_block < 1:
            raise ConfigError(f"warp_block must be a positive width or None, got {warp_block}")
        if warp_block is not None and warp_s2d and warp_block % 2:
            # The reference's TwoPassWarp raises here and its runtime then
            # serves the gather in its place; the port names the fault.
            raise ConfigError(f"warp_block={warp_block}: the s2d-emitting warp needs an even "
                              "block")
        if warp_pass1 == "kernel" and (warp_block is not None or warp_col_expand):
            raise ConfigError("warp_pass1='kernel' reads the dense pass-1 weights and decimates "
                              "itself: it takes neither warp_block nor warp_col_expand")
        if undistort_interp not in ("bilinear", "nearest"):
            raise ConfigError(f"undistort_interp must be bilinear|nearest, got {undistort_interp!r}")
        self.device = torch.device(device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ConfigError(f"a {mesh.device_type} mesh cannot serve a pipeline on "
                                  f"{self.device}")
        self.mesh = mesh
        self.model_cfg = model_cfg
        self.measure_cfg = measure_cfg or MeasureConfig()
        self.frame_hw = frame_hw
        self.return_masks = return_masks
        self.warp_pass1 = warp_pass1
        self.lazy_decode = lazy_decode
        self.logits_dtype = MASKSTATS_LOGITS[maskstats_logits]
        self.spec: LetterboxSpec = make_letterbox_spec(
            frame_hw[0], frame_hw[1], model_cfg.image_size, model_cfg.letterbox)
        self.dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
        # This rank's slab of the model input's rows on a space mesh, else None.
        self.space = space_of(mesh, self.spec.dst_h) if mesh is not None else None

        self.quant = quant
        self.model = inference_model(model_cfg, variables, self.device, s2d_input=warp_s2d,
                                     fused_head=fused_head, fold_bn=fold_bn, quant=quant,
                                     quant_scales=quant_scales)
        set_space(self.model, self.space)

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
                self.warp = self._build_warp(calibration, remap, undistort_interp, warp_s2d,
                                             warp_block, warp_col_expand)
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
            # Refused on every device, so that the CPU route takes what the card takes.
            why = card_geometry_error(decimation_stride(self.spec), self.warp.w1.shape[2])
            if why is not None:
                raise ConfigError(f"warp_pass1='kernel' at {frame_hw}, imgsz "
                                  f"{model_cfg.image_size}: {why}")
            self.warp.pass1_window()  # the kernel's table, before any step or trace
        # What this rank's preprocess emits: the model input's rows
        # [r0, r1) of its slab (with the warp's weights of those rows only),
        # or all of them.
        self.input_rows = None if self.space is None else self.space.input_rows()
        if self.input_rows is not None and self.warp is not None:
            self.warp = self.warp.rows(*self.input_rows)
        two_pass = isinstance(self.warp, TwoPassWarp)
        for name, asked, applies in (
                ("warp_block", warp_block is not None, two_pass),
                ("warp_col_expand", warp_col_expand,
                 two_pass and decimation_stride(self.spec) is not None)):
            if asked and not applies:
                log.info("%s has no effect here: %s at imgsz %d runs %s", name, frame_hw,
                         model_cfg.image_size, type(self.warp).__name__ if self.warp is not None
                         else "no undistort warp")
        self._uploader: _Uploader | None = None
        self.steps = 0  # batches handed to an entry point: the spans' batch ids

    def _build_warp(self, calibration: CalibrationData, remap: str, interp: str,
                    warp_s2d: bool, block: int | None,
                    col_expand: bool) -> TwoPassWarp | PackedRemap:
        small_map = build_small_undistort_map(calibration.K, calibration.dist, self.spec,
                                              unpadded_src=True)
        src_hw = (self.spec.new_h, self.spec.new_w)
        if remap == "twopass" and interp == "bilinear":
            k = decimation_stride(self.spec)
            col = (k, (k - 1) // 2, self.frame_hw[1]) if col_expand and k is not None else None
            try:
                return TwoPassWarp(small_map, src_hw, s2d_out=warp_s2d, device=self.device,
                                   col_expand=col, block=block)
            except ValueError:  # non-monotonic vertical map: the gather takes it
                pass
        return PackedRemap(small_map, src_hw, interp=interp, device=self.device)

    def preprocess(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 BGR (B, H, W, 3) on the device -> the model input in the
        compute dtype: (B, H/2, W/2, 12) blocked when the model takes it so
        (the s2d-emitting warp gives that for free, every other path blocks
        here), else (B, H, W, 3). On a space mesh: this rank's slab of
        those rows."""
        with span("preprocess", self.device):
            want_s2d = self.model.s2d_input
            warp = self.warp
            if isinstance(warp, TwoPassWarp):
                if self.warp_pass1 == "kernel":
                    k = decimation_stride(self.spec)
                    y0, y1 = warp.src_rows
                    if (y0, y1) != (0, self.spec.new_h):  # the frames' rows of the slab's band
                        frames_u8 = frames_u8[:, k * y0:k * y1].contiguous()
                    i1 = warp_pass1_decimated(frames_u8, warp.w1, warp.pass1_window(),
                                              k=k, off=(k - 1) // 2,
                                              hs=y1 - y0, ws=self.spec.new_w,
                                              pad_value=warp.pad_value)
                    out = warp.apply_pass2_ycbo(i1, self.dtype)
                else:
                    out = letterbox_then_undistort(frames_u8, self.spec, warp, self.dtype)
                return out  # blocked iff the model takes it so: both follow ``warp_s2d``
            if warp is not None:
                out = letterbox_then_undistort(frames_u8, self.spec, warp, self.dtype)
            else:
                out = letterbox_u8(frames_u8, self.spec, self.dtype, rows=self.input_rows)
            return space_to_depth2(out) if want_s2d else out

    def detect(self, raw: RawPredictions) -> tuple[Detections, dict]:
        """Raw head outputs -> DFL decode -> NMS (or, ``lazy_decode``, NMS on
        raw logits with the candidates' decode), with budget telemetry."""
        with span("detect", self.device):
            mcfg = self.model_cfg
            nms_kw = dict(conf_thresh=mcfg.conf_thresh, iou_thresh=mcfg.iou_thresh,
                          max_det=mcfg.max_detections, pre_topk=mcfg.nms_pre_topk)
            if self.lazy_decode:
                dets = nms_from_raw(raw, **nms_kw)
                n_candidates = raw_candidate_counts(raw, mcfg.conf_thresh)
            else:
                boxes, probs, coefs = decode_predictions(raw)
                dets = batched_nms(boxes, probs, coefs, **nms_kw)
                n_candidates = (probs.amax(-1) > mcfg.conf_thresh).sum(-1).to(torch.int32)
            telemetry = {"n_candidates": n_candidates,
                         "n_valid": dets.valid.sum(-1).to(torch.int32)}
            return dets, telemetry

    def measure(self, dets: Detections, protos: torch.Tensor) -> dict:
        """Detections + protos -> mask statistics, stitch set, envelope and
        the mm measurements (requires a calibration)."""
        with span("measure", self.device):
            mcfg, cfg = self.model_cfg, self.measure_cfg
            stitches, envelope, fabric_any, counts = prepare_frame_inputs(
                dets, protos, self.spec, mcfg.stitch_class_id, mcfg.fabric_class_id,
                self.roi_bounds, cfg.max_stitches, cfg.max_stats_dets,
                subcell=bool(cfg.subcell_edge), subcell_envelope=cfg.envelope_subcell,
                logits_dtype=self.logits_dtype)
            return {"measurements": measure_frame(stitches, envelope, fabric_any, self.cam,
                                                  self.spec, cfg),
                    "stitches": stitches, "envelope": envelope, "counts": counts}

    def postprocess_chain(self, x: torch.Tensor) -> dict:
        """Model input -> forward, detect, measure, optional masks and frame
        boxes (device tensors). ``DualPipeline`` runs it once per model on
        one preprocessed batch. On a space mesh ``x`` is this rank's slab,
        and the forward's outputs are gathered along H, level by level,
        before detect."""
        raw = self.model(x)
        if self.space is not None:
            raw = self.space.gather_rows(raw)
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
        """One device step on frames already on the device (with a mesh: the
        global batch, of which this rank runs its rows)."""
        with self.batch_span() as batch:
            outs = self._local_step(self.local_frames(frames_u8))
        return _tagged(outs, batch)

    @torch.inference_mode()
    def _local_step(self, frames_u8: torch.Tensor) -> dict:
        """The step on this rank's rows, then (with a mesh) the all-gather."""
        outs = self.postprocess_chain(self.preprocess(frames_u8))
        return outs if self.mesh is None else gather_batch(self.mesh, outs)

    def local_frames(self, frames):
        """This rank's rows of a batch (array or tensor): the whole batch
        without a mesh, or when the mesh's data axis is one rank."""
        n = len(frames)
        rows = slice(0, n) if self.mesh is None else batch_slice(self.mesh, n)
        return frames if rows == slice(0, n) else frames[rows]

    def batch_span(self):
        """The root span of one batch handed to an entry point; its id is
        this pipeline's step number."""
        self.steps += 1
        return span("batch", self.device, batch=self.steps)

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
        with self.batch_span() as batch:
            frames = torch.from_numpy(np.ascontiguousarray(self.local_frames(frames_bgr_u8)))
            outs = self._local_step(frames.to(self.device))
        return self.outputs_to_host(_tagged(outs, batch))

    def process_batch_async(self, frames_bgr_u8: np.ndarray) -> dict:
        """Dispatch without blocking: device tensors come back, to be read
        later with :meth:`outputs_to_host`, so the host can prepare the next
        batch under the device's work on this one."""
        with self.batch_span() as batch:
            outs = self._local_step(self.uploader.upload(self.local_frames(frames_bgr_u8)))
        return _tagged(outs, batch)

    @staticmethod
    def outputs_to_host(outs: dict) -> PipelineOutputs:
        """Bring a device step result to the host, one copy per array; the
        first waits for the step."""
        copies = 0

        def host(t: torch.Tensor) -> np.ndarray:
            nonlocal copies
            copies += 1
            return t.cpu().numpy()

        dets = outs["dets"]
        env = outs.get("envelope")
        masks = outs.get("masks")
        with span("to_host", dets.valid, outs.get(TRACE_BATCH)):
            with span("to_host.wait"):
                boxes_frame = host(outs["boxes_frame"])
            result = PipelineOutputs(
                boxes_frame=boxes_frame,
                scores=host(dets.scores),
                classes=host(dets.classes),
                valid=host(dets.valid),
                masks=None if masks is None else host(masks),
                measurements=_to_host(outs.get("measurements"), host),
                stitches=_to_host(outs.get("stitches"), host),
                envelope=None if env is None else host(env),
                telemetry={k: host(v) for k, v in outs["telemetry"].items()},
            )
            count("d2h_copies", copies)
        return result


class DualPipeline:
    """Two models on one preprocessed batch: the primary's preprocess runs
    once, then both models run their full chain (forward, NMS, telemetry and,
    where calibrated, measurement) on the same device buffer. Each model's
    step is built by its caller; under ``tti``'s switches both take the same
    arguments (``RuntimeSwitches.pipeline_kwargs``), ``quant`` and
    ``quant_scales`` included, as ``tti``'s environment gives both. With a
    mesh, both pipelines hold the same one: each rank runs both chains on
    its rows of one preprocessed slab, and one all-gather returns both
    models' global outputs; on a space mesh that slab is also this rank's
    rows of the frame, and each chain gathers its own head outputs."""

    def __init__(self, primary: InspectionPipeline, secondary: InspectionPipeline) -> None:
        if secondary.mesh is not primary.mesh:
            raise ValueError("dual pipelines must share one mesh (the preprocessed batch is "
                             "a single sharded buffer)")
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
        mode = lambda w: (w.s2d_out, w.block, w.col_expand)
        if (isinstance(primary.warp, TwoPassWarp) and isinstance(secondary.warp, TwoPassWarp)
                and mode(primary.warp) == mode(secondary.warp)):
            # Same lens, geometry, blocking, bands and column expansion:
            # identical weights. Only the
            # primary's preprocess runs here, so the secondary's copy is
            # dropped (and freed) and its standalone step shares this one
            # (on one mesh, the same slab of it).
            secondary.warp = primary.warp
        self.primary = primary
        self.secondary = secondary

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor) -> tuple[dict, dict]:
        """One device step on frames already on the device (with a mesh: the
        global batch)."""
        with self.primary.batch_span() as batch:
            outs = self._local_step(self.primary.local_frames(frames_u8))
        return _tagged(outs, batch)

    @torch.inference_mode()
    def _local_step(self, frames_u8: torch.Tensor) -> tuple[dict, dict]:
        x = self.primary.preprocess(frames_u8)
        s2d_a, s2d_b = self.primary.model.s2d_input, self.secondary.model.s2d_input
        xb = x
        if s2d_a != s2d_b:  # the exact permutation either way
            xb = depth_to_space2(x) if s2d_a else space_to_depth2(x)
        outs = (self.primary.postprocess_chain(x), self.secondary.postprocess_chain(xb))
        return outs if self.primary.mesh is None else gather_batch(self.primary.mesh, outs)

    def process_batch(self, frames_bgr_u8: np.ndarray) -> tuple[PipelineOutputs, PipelineOutputs]:
        with self.primary.batch_span() as batch:
            frames = torch.from_numpy(np.ascontiguousarray(
                self.primary.local_frames(frames_bgr_u8)))
            outs_a, outs_b = _tagged(self._local_step(frames.to(self.primary.device)), batch)
        return (InspectionPipeline.outputs_to_host(outs_a),
                InspectionPipeline.outputs_to_host(outs_b))

    def process_batch_async(self, frames_bgr_u8: np.ndarray) -> tuple[dict, dict]:
        """Dispatch without blocking; read each element later with
        ``InspectionPipeline.outputs_to_host``."""
        with self.primary.batch_span() as batch:
            outs = self._local_step(
                self.primary.uploader.upload(self.primary.local_frames(frames_bgr_u8)))
        return _tagged(outs, batch)
