"""Fixed-shape batched NMS (port of ``tti.postprocess.nms``).

1. per-anchor best class; strict ``> conf_thresh`` candidate filter,
2. top ``pre_topk`` candidates by score,
3. one K x K class-masked IoU matrix,
4. exact greedy suppression as a fixed-point sweep (the greedy keep-set is
   the unique fixed point; chains are short, so few sweeps run),
5. the top ``max_det`` survivors, padded with valid=False rows.

Every ranking is a stable descending sort, so ties keep the lower index
first, as ``jax.lax.top_k`` does (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

import torch

from tti_torch.postprocess.decode import Detections

Tensor = torch.Tensor


def box_iou_matrix(boxes: Tensor) -> Tensor:
    """Pairwise IoU of (..., K, 4) xyxy boxes -> (..., K, K)."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def stable_topk(values: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-k along the last axis, ties in index order."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(a: Tensor, idx: Tensor) -> Tensor:
    """a (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def greedy_suppress(cand_boxes: Tensor, top_scores: Tensor, cand_classes: Tensor,
                    cand_coefs: Tensor, cand_ok: Tensor, iou_thresh: float,
                    max_det: int, class_aware: bool = True) -> Detections:
    """Greedy NMS over score-sorted (B, K) candidates -> (B, max_det) rows."""
    k = cand_boxes.shape[1]
    iou = box_iou_matrix(cand_boxes)
    if class_aware:
        iou = torch.where(cand_classes[:, :, None] == cand_classes[:, None, :], iou, 0.0)
    tri = torch.ones(k, k, dtype=torch.bool, device=iou.device).tril(-1)  # j < i
    blocked_by = (iou > iou_thresh) & tri  # [b, i, j]: j outranks i and overlaps
    # keep_i <- ok_i & no kept higher-ranked box overlaps i, to the fixed point
    # (position i is final after at most i sweeps).
    keep = cand_ok
    for _ in range(k):
        new = cand_ok & ~(blocked_by & keep[:, None, :]).any(-1)
        if torch.equal(new, keep):
            break
        keep = new

    k_out = min(max_det, k)
    out_scores, order = stable_topk(torch.where(keep, top_scores, -1.0), k_out)
    if k_out < max_det:
        out_scores = torch.nn.functional.pad(out_scores, (0, max_det - k_out), value=-1.0)
        order = torch.nn.functional.pad(order, (0, max_det - k_out))
    valid = out_scores > 0.0
    sel = lambda a: torch.where(valid.reshape(valid.shape + (1,) * (a.ndim - 2)),
                                _gather_rows(a, order), 0)
    return Detections(
        boxes=sel(cand_boxes),
        scores=torch.where(valid, out_scores, 0.0),
        classes=torch.where(valid, _gather_rows(cand_classes, order), -1),
        coefs=sel(cand_coefs),
        valid=valid,
    )


def batched_nms(boxes: Tensor, probs: Tensor, coefs: Tensor, conf_thresh: float = 0.20,
                iou_thresh: float = 0.25, max_det: int = 200, pre_topk: int = 512,
                class_aware: bool = True) -> Detections:
    """(B, A, 4) boxes + (B, A, nc) probs + (B, A, nm) coefs -> Detections
    with fixed (B, max_det) shapes."""
    scores_all, classes_all = probs.max(dim=-1)
    ranked = torch.where(scores_all > conf_thresh, scores_all, -1.0)
    k = min(pre_topk, ranked.shape[1])
    top_scores, top_idx = stable_topk(ranked, k)
    return greedy_suppress(
        _gather_rows(boxes, top_idx), top_scores,
        _gather_rows(classes_all.to(torch.int32), top_idx),
        _gather_rows(coefs, top_idx), top_scores > 0.0, iou_thresh, max_det, class_aware)
