"""Reference-compatible predict surface: frames -> boxes / scores / classes /
instance masks (port of ``tti.app.predict``).

What the reference consumes from Ultralytics (``model.predict(rgb, conf,
iou, max_det, imgsz)``, then ``r.boxes`` and ``r.masks.data`` resized to the
frame with cv2's INTER_NEAREST): the device runs the auto minimal-rect
letterbox, YOLOv8-seg (the inference form the inspection step runs: the
space-to-depth stem and folded BatchNorm), DFL decode, batched NMS and the
``process_mask(upsample=True)`` mask chain, and packs the binary
input-resolution masks 8 to a byte before they leave the card; the host
unpacks them. The final resize to the frame is a host-side integer gather
(:meth:`Predictor.masks_to_frame`).

The inspection step never materialises masks; this surface is for
``eval``, rendering and parity checks. Its mask assembly is a plain einsum,
upsample and threshold on the card, as the reference keeps it plain XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tti_torch.core.config import ModelConfig
from tti_torch.parallel.runtime import inference_model
from tti_torch.postprocess.decode import decode_predictions
from tti_torch.postprocess.masks import assemble_masks, masks_at_input, resize_nearest_cv2
from tti_torch.postprocess.nms import batched_nms
from tti_torch.preprocess.letterbox import (
    LetterboxSpec, letterbox_u8, make_letterbox_spec, scale_boxes_to_frame,
)


def _packbits_lastdim(bits: torch.Tensor) -> torch.Tensor:
    """(..., W) {0,1} uint8 -> (..., ceil(W/8)) uint8 in np.packbits' bit
    order (most significant first), on the tensor's device."""
    w = bits.shape[-1]
    pad = (-w) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    # 128, 64, ..., 1 made on the device (a list-built tensor would be a
    # blocking host-to-device copy).
    weights = (1 << torch.arange(7, -1, -1, device=bits.device)).to(torch.uint8)
    grouped = bits.reshape(*bits.shape[:-1], (w + pad) // 8, 8)
    return (grouped * weights).sum(-1, dtype=torch.uint8)


def _unpackbits_lastdim(packed: np.ndarray, w: int) -> np.ndarray:
    """Inverse of :func:`_packbits_lastdim`, on the host."""
    return np.unpackbits(packed, axis=-1)[..., :w]


@dataclass
class PredictResult:
    """Host-side predict outputs for one batch (numpy).

    Rows are score-sorted; ``valid`` masks the fixed-shape padding.
    ``masks_input`` is (B, M, H, W) binary at model-input resolution, where
    M = min(max_det, mask_topk)."""

    boxes: np.ndarray  # (B, D, 4) xyxy in frame px, clipped
    scores: np.ndarray  # (B, D)
    classes: np.ndarray  # (B, D) int32, -1 on padding
    valid: np.ndarray  # (B, D) bool
    masks_input: np.ndarray  # (B, M, Hi, Wi) uint8 binary
    spec: LetterboxSpec
    masks_proto: np.ndarray | None = None  # (B, M, Hi/q, Wi/q) uint8, proto grid


class Predictor:
    """The full predict chain for one model on one device. ``variables``
    is the checkpoint's flax tree with numpy leaves
    (:func:`tti_torch.model.checkpoint.load_flax_msgpack`); the compute
    dtype is ``model_cfg.dtype``."""

    def __init__(self, model_cfg: ModelConfig, variables: dict, frame_hw: tuple[int, int],
                 mask_topk: int = 64, proto_masks: bool = False,
                 device: str | torch.device = "cuda") -> None:
        self.model_cfg = model_cfg
        self.frame_hw = frame_hw
        self.device = torch.device(device)
        self.spec = make_letterbox_spec(frame_hw[0], frame_hw[1], model_cfg.image_size,
                                        model_cfg.letterbox)
        self.dtype = torch.bfloat16 if model_cfg.dtype == "bfloat16" else torch.float32
        self.model = inference_model(model_cfg, variables, self.device, s2d_input=False)
        self.mask_topk = min(mask_topk, model_cfg.max_detections)
        self.proto_masks = proto_masks

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor) -> dict:
        """uint8 BGR frames on the device -> device results, the masks packed."""
        spec, mcfg, topk = self.spec, self.model_cfg, self.mask_topk
        raw = self.model(letterbox_u8(frames_u8, spec, self.dtype))
        boxes, probs, coefs = decode_predictions(raw)
        dets = batched_nms(boxes, probs, coefs, conf_thresh=mcfg.conf_thresh,
                           iou_thresh=mcfg.iou_thresh, max_det=mcfg.max_detections,
                           pre_topk=mcfg.nms_pre_topk)
        top = (dets.coefs[:, :topk], dets.boxes[:, :topk], dets.valid[:, :topk])
        input_hw = (spec.dst_h, spec.dst_w)
        masks = masks_at_input(raw.protos, *top, input_hw)
        out = {"boxes_frame": scale_boxes_to_frame(dets.boxes, spec), "scores": dets.scores,
               "classes": dets.classes, "valid": dets.valid,
               "masks_input": _packbits_lastdim(masks.to(torch.uint8))}
        if self.proto_masks:
            out["masks_proto"] = assemble_masks(raw.protos, *top, input_hw).to(torch.uint8)
        return out

    def __call__(self, frames_bgr_u8: np.ndarray) -> PredictResult:
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr_u8)).to(self.device)
        outs = {k: v.cpu().numpy() for k, v in self.step(frames).items()}
        return PredictResult(
            boxes=outs["boxes_frame"].astype(np.float32),
            scores=outs["scores"].astype(np.float32),
            classes=outs["classes"],
            valid=outs["valid"],
            masks_input=_unpackbits_lastdim(outs["masks_input"], self.spec.dst_w),
            spec=self.spec,
            masks_proto=outs.get("masks_proto"),
        )

    def masks_to_frame(self, masks_input: np.ndarray) -> np.ndarray:
        """Input-resolution masks -> frame-resolution uint8 masks with cv2's
        INTER_NEAREST convention (:func:`resize_nearest_cv2`), on the host."""
        out = resize_nearest_cv2(torch.from_numpy(np.asarray(masks_input)), self.frame_hw)
        return (out > 0).numpy().astype(np.uint8)
