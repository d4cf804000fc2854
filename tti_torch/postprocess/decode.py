"""Anchor-free DFL box decode (port of ``tti.postprocess.decode``).

Anchors are per-level grid-cell centers (x+0.5, y+0.5)*stride; DFL turns each
side's 16-bin distribution into its softmax expectation; distances (l, t, r,
b) scale by stride into xyxy input pixels. Plain PyTorch: a (B, A, .)
elementwise pass with no kernel of its own in the reference either.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from tti_torch.model.yolo import REG_MAX, STRIDES, RawPredictions

Tensor = torch.Tensor


@dataclass
class Detections:
    """Fixed-size detection set (padded; ``valid`` masks real rows). Boxes
    are xyxy in model-input pixels."""

    boxes: Tensor  # (B, D, 4)
    scores: Tensor  # (B, D)
    classes: Tensor  # (B, D) int32
    coefs: Tensor  # (B, D, nm)
    valid: Tensor  # (B, D) bool

    def map(self, fn) -> "Detections":
        return Detections(*(fn(getattr(self, f.name)) for f in fields(self)))


def make_anchors(level_hw: tuple[tuple[int, int], ...], strides: tuple[int, ...] = STRIDES,
                 dtype=torch.float32, device=None) -> tuple[Tensor, Tensor]:
    """Anchor centers in input pixels (A, 2) and per-anchor stride (A,)."""
    points, strs = [], []
    for (h, w), s in zip(level_hw, strides):
        ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strs.append(torch.full((h * w,), float(s), dtype=dtype, device=device))
    return torch.cat(points), torch.cat(strs)


def dfl_expectation(box_logits: Tensor) -> Tensor:
    """(..., 4*REG_MAX) logits -> (..., 4) expected distances in grid units."""
    shape = box_logits.shape[:-1] + (4, REG_MAX)
    probs = torch.softmax(box_logits.reshape(shape).float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_logits.device)
    return (probs * bins).sum(-1)


def flatten_predictions(raw: RawPredictions):
    """Per-level NHWC maps -> (B, A, C) tensors + level shapes."""
    level_hw = tuple((t.shape[1], t.shape[2]) for t in raw.box)
    b = raw.box[0].shape[0]
    flat = lambda ts: torch.cat([t.reshape(b, -1, t.shape[-1]) for t in ts], dim=1)
    return flat(raw.box), flat(raw.cls), flat(raw.mcoef), level_hw


def decode_predictions(raw: RawPredictions, strides: tuple[int, ...] = STRIDES
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """RawPredictions -> (boxes_xyxy (B,A,4) input px, class_probs (B,A,nc),
    coefs (B,A,nm)), all float32."""
    box_l, cls_l, coef_l, level_hw = flatten_predictions(raw)
    anchors, stride_pa = make_anchors(level_hw, strides, device=box_l.device)
    ltrb = dfl_expectation(box_l) * stride_pa[None, :, None]
    cx, cy = anchors[None, :, 0], anchors[None, :, 1]
    boxes = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                         cx + ltrb[..., 2], cy + ltrb[..., 3]], dim=-1)
    return boxes, torch.sigmoid(cls_l.float()), coef_l.float()
