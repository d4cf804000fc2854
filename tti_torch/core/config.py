"""Configuration for the inspection step (copies of ``tti.core.config``'s
ModelConfig, RoiConfig and MeasureConfig).

Differences from the reference, both deliberate:
- no environment switches: every knob is a constructor argument;
- the readout calibration offsets must be finite. The reference treats 0.0
  as "unset" and would carry a NaN offset from a sidecar into every
  measurement; here a non-finite value raises ConfigError when it is set or
  loaded.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping

from tti_torch.core.errors import ConfigError


@dataclass(frozen=True)
class ModelConfig:
    """Detector/segmenter settings."""

    weights: str = "single_needle_model.ckpt"
    variant: str = "n"  # yolov8 scale: n / s / m
    num_classes: int = 2
    stitch_class_id: int = 0
    fabric_class_id: int = 1
    conf_thresh: float = 0.20
    iou_thresh: float = 0.25
    max_detections: int = 200
    nms_pre_topk: int = 256  # candidates entering the KxK NMS IoU matrix
    image_size: int = 960
    letterbox: str = "rect"  # 'rect' (Ultralytics auto minimal-rect) | 'square'
    dtype: str = "bfloat16"  # compute dtype; parameters are loaded in f32
    mask_stride: int = 4  # proto grid = input / mask_stride (4 or 2)
    proto_head: str = "deconv"  # mask_stride=2 second stage: deconv | subpixel

    def __post_init__(self) -> None:
        if self.mask_stride not in (2, 4):
            raise ValueError(f"mask_stride must be 2 or 4, got {self.mask_stride}")
        if self.proto_head not in ("deconv", "subpixel"):
            raise ValueError(
                f"proto_head must be 'deconv' or 'subpixel', got {self.proto_head!r}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")


@dataclass(frozen=True)
class RoiConfig:
    """Pixel ROI gating: detections with bbox centers outside are dropped."""

    enabled: bool = True
    x_min: int = 10
    x_max: int = 1270
    y_min: int = 300
    y_max: int = 760

    def validate(self, width: int, height: int) -> None:
        if not self.enabled:
            return
        if not (0 <= self.x_min < self.x_max <= width):
            raise ConfigError(f"Invalid ROI X bounds: {self.x_min}..{self.x_max} for width {width}")
        if not (0 <= self.y_min < self.y_max <= height):
            raise ConfigError(f"Invalid ROI Y bounds: {self.y_min}..{self.y_max} for height {height}")


def _finite_offset(name: str, value: Any) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise ConfigError(f"{name} must be finite, got {value!r}")
    return value


@dataclass(frozen=True)
class MeasureConfig:
    """Measurement-core knobs (same fields and defaults as the reference)."""

    frame_buffer: int = 8  # temporal median window
    min_stitches: int = 3
    max_px_distance: float = 250.0  # envelope proximity gate
    envelope_neighborhood: int = 3  # +-columns around centroid
    skip_cluster: bool = False
    two_row_threshold_px: float = 30.0
    max_stitches: int = 64  # fixed-shape budget for per-stitch arrays
    max_stats_dets: int = 64  # top-score detections entering mask statistics
    undistort_iters: int = 5  # fixed-point iterations (5 == cv2 parity)
    # Sub-cell readout for soft-mask-trained nets; None = follow the sidecar.
    subcell_edge: bool | None = None
    # Envelope readout override; None = follow subcell_edge.
    subcell_envelope: bool | None = None
    # Per-checkpoint readout calibration, added to the raw mm outputs.
    cal_edge_mm: float = 0.0
    cal_width_mm: float = 0.0

    def __post_init__(self) -> None:
        _finite_offset("cal_edge_mm", self.cal_edge_mm)
        _finite_offset("cal_width_mm", self.cal_width_mm)

    @property
    def envelope_subcell(self) -> bool:
        """Effective envelope readout after auto-resolution."""
        if self.subcell_envelope is not None:
            return self.subcell_envelope
        return bool(self.subcell_edge)

    def with_subcell_from(self, ckpt_meta: Mapping[str, Any]) -> "MeasureConfig":
        """Resolve auto (None) readouts and the calibration offsets against a
        checkpoint sidecar, as the reference does: per-class keys
        (soft_stitch / soft_fabric) split the two readouts, the legacy
        ``soft_masks`` flag drives both, an explicit ``subcell_envelope`` pin
        wins, and explicit (non-zero) config wins over the sidecar. A
        non-finite sidecar offset raises ConfigError."""
        sub = self.subcell_edge
        env = self.subcell_envelope
        legacy = bool(ckpt_meta.get("soft_masks", False))
        if sub is None:
            sub = bool(ckpt_meta.get("soft_stitch", legacy))
        if env is None and "subcell_envelope" in ckpt_meta:
            env = bool(ckpt_meta["subcell_envelope"])
        if env is None and ("soft_fabric" in ckpt_meta or "soft_stitch" in ckpt_meta):
            env = bool(ckpt_meta.get("soft_fabric", legacy))
        cal_e, cal_w = self.cal_edge_mm, self.cal_width_mm
        if cal_e == 0.0:
            cal_e = _finite_offset("cal_edge_mm", ckpt_meta.get("cal_edge_mm", 0.0))
        if cal_w == 0.0:
            cal_w = _finite_offset("cal_width_mm", ckpt_meta.get("cal_width_mm", 0.0))
        return dataclasses.replace(self, subcell_edge=sub, subcell_envelope=env,
                                   cal_edge_mm=cal_e, cal_width_mm=cal_w)
