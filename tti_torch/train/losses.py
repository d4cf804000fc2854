"""YOLOv8-seg training losses (port of ``tti.train.losses``).

CIoU + DFL box regression, and the per-instance mask BCE cropped to the GT
box and normalised by its area. Batched over images; every function is a
masked fixed-shape op.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from tti_torch.model.yolo import REG_MAX

Tensor = torch.Tensor

# Per-sample logits bytes above which seg_loss evaluates its anchors in
# chunks, recomputing each chunk's logits in the backward pass: the
# reference's threshold. At imgsz 960 with mask stride 2 (Hm = 480) and
# max_gt 16 (P = 160) one sample's logits are 147 MB, above it.
_SEG_CHUNK_BYTES = 128 * 1024 * 1024
_SEG_CHUNK = 32


def bbox_ciou(pred: Tensor, target: Tensor, eps: float = 1e-7) -> Tensor:
    """Complete IoU between xyxy boxes (broadcasting elementwise); the
    aspect term's weight alpha carries no gradient."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    pw, ph = px2 - px1, py2 - py1
    tw, th = tx2 - tx1, ty2 - ty1
    inter_w = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0.0)
    inter_h = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0.0)
    inter = inter_w * inter_h
    union = pw * ph + tw * th - inter + eps
    iou = inter / union
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw * cw + ch * ch + eps
    rho2 = ((tx1 + tx2 - px1 - px2) ** 2 + (ty1 + ty2 - py1 - py2) ** 2) / 4.0
    v = (4 / math.pi ** 2) * (torch.atan(tw / (th + eps)) - torch.atan(pw / (ph + eps))) ** 2
    alpha = (v / (v - iou + 1.0 + eps)).detach()
    return iou - rho2 / c2 - alpha * v


def dfl_loss(box_logits: Tensor, target_ltrb: Tensor) -> Tensor:
    """Distribution focal loss per anchor: box_logits (..., 4, REG_MAX),
    target_ltrb (..., 4) in grid units. Cross-entropy against the two bins
    around the target, linearly weighted (the hat form: weight
    max(0, 1 - |bin - t|) over all bins). Returns (...,), the mean of the
    4 sides."""
    t = target_ltrb.clamp(0.0, REG_MAX - 1 - 0.01)
    logp = torch.log_softmax(box_logits, dim=-1)
    bins = torch.arange(REG_MAX, dtype=t.dtype, device=t.device)
    w = (1.0 - (bins - t[..., None]).abs()).clamp(min=0.0)
    return -(logp * w).sum(-1).mean(-1)


def _seg_per_anchor(coefs: Tensor, assigned_gt: Tensor, protos: Tensor, gt_masks: Tensor,
                    gt_boxes_mask_grid: Tensor, seg_dtype: torch.dtype) -> Tensor:
    """Area-normalised box-cropped mask BCE for a slice of anchors.

    coefs (B, P, nm); assigned_gt (B, P); protos (B, Hm, Wm, nm); gt_masks
    (B, G, Hm, Wm); gt_boxes_mask_grid (B, G, 4). Returns (B, P). Anchors are
    independent: any chunking of P gives the same values."""
    b, hm, wm, _ = protos.shape
    logits = torch.einsum("bpc,bhwc->bphw", coefs.to(seg_dtype), protos.to(seg_dtype))
    bi = torch.arange(b, device=coefs.device)[:, None]
    tgt = gt_masks.to(seg_dtype)[bi, assigned_gt]  # (B, P, Hm, Wm)
    boxes = gt_boxes_mask_grid[bi, assigned_gt]  # (B, P, 4)
    rows = torch.arange(hm, dtype=torch.float32, device=coefs.device)
    cols = torch.arange(wm, dtype=torch.float32, device=coefs.device)
    in_rows = (rows >= boxes[..., 1, None]) & (rows < boxes[..., 3, None])  # (B, P, Hm)
    in_cols = (cols >= boxes[..., 0, None]) & (cols < boxes[..., 2, None])  # (B, P, Wm)
    inside = in_rows[..., :, None] & in_cols[..., None, :]
    x = logits.float()
    t = tgt.float()
    bce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    per_anchor = (bce * inside).sum((2, 3))
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=1.0)
    return per_anchor / area


def seg_loss(coefs: Tensor, protos: Tensor, gt_masks: Tensor, gt_boxes_mask_grid: Tensor,
             assigned_gt: Tensor, pos_mask: Tensor, chunk: int | None = None,
             anchor_weights: Tensor | None = None,
             seg_dtype: torch.dtype = torch.float32) -> Tensor:
    """Per-positive-anchor instance mask BCE, cropped to the GT box and
    normalised by its area; (B,) per image.

    coefs (B, A, nm); protos (B, Hm, Wm, nm); gt_masks (B, G, Hm, Wm);
    gt_boxes_mask_grid (B, G, 4) xyxy on the proto grid; assigned_gt (B, A);
    pos_mask (B, A) bool; anchor_weights (B, A) or None.

    Only the first P = min(A, max(64, 10 G)) anchors ranked by pos_mask are
    evaluated (positives first, each group in index order: a stable sort,
    as the reference's ``lax.top_k``); TAL picks at most 10 per GT, so the
    slice holds every positive. The mask logits are recomputed in the
    backward pass (``torch.utils.checkpoint``) and, when one sample's
    (P, Hm, Wm) float32 logits exceed 128 MB, evaluated in chunks of 32
    anchors; ``chunk`` forces a chunk size (0 or None with small logits:
    unchunked). ``seg_dtype`` is the storage dtype of the logits and the
    gathered GT masks; the BCE runs in float32.
    """
    b, a, _ = coefs.shape
    hm, wm = protos.shape[1], protos.shape[2]
    g = gt_masks.shape[1]
    p = min(a, max(64, 10 * g))
    order = torch.sort(pos_mask.to(torch.uint8), dim=1, descending=True, stable=True)[1][:, :p]
    coefs = torch.gather(coefs, 1, order[..., None].expand(b, p, coefs.shape[2]))
    assigned_gt = torch.gather(assigned_gt, 1, order)
    pos_mask = torch.gather(pos_mask, 1, order)
    if anchor_weights is not None:
        anchor_weights = torch.gather(anchor_weights, 1, order)

    if chunk is None and p * hm * wm * 4 > _SEG_CHUNK_BYTES:
        chunk = _SEG_CHUNK
    chunk = chunk or p
    parts = [checkpoint(_seg_per_anchor, coefs[:, i:i + chunk], assigned_gt[:, i:i + chunk],
                        protos, gt_masks, gt_boxes_mask_grid, seg_dtype, use_reentrant=False)
             for i in range(0, p, chunk)]
    per_anchor = torch.cat(parts, dim=1)
    # Per-class gains scale an anchor's term; the normaliser stays n_pos.
    if anchor_weights is not None:
        per_anchor = per_anchor * anchor_weights
    n_pos = pos_mask.sum(1).clamp(min=1).float()
    return torch.where(pos_mask, per_anchor, torch.zeros_like(per_anchor)).sum(1) / n_pos
