"""Fixed-shape batched NMS (port of ``tti.postprocess.nms``).

1. per-anchor best class; strict ``> conf_thresh`` candidate filter,
2. top ``pre_topk`` candidates by score,
3. one K x K class-masked IoU matrix,
4. exact greedy suppression as a fixed-point sweep (the greedy keep-set is
   the unique fixed point; chains are short, so few sweeps run), in blocks
   of ``SWEEPS_PER_CHECK`` sweeps with one host read per block,
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


# Sweeps run in blocks of this many, with one host read after each block
# (``torch.equal`` waits for the device): one read per step where a read per
# sweep stalled the host at every sweep. A sweep applied to the fixed point
# returns it unchanged, so a sweep past it costs only its few small kernels.
# The seeded frames of the deploy and headline configurations reach the fixed
# point in 2 sweeps (the confirming one included) at batch 1 and 128
# (``chip_smoke.py`` prints the counts); 4 leaves room for chains twice as
# long, so a step reads the host once.
SWEEPS_PER_CHECK = 4


def suppression_matrix(cand_boxes: Tensor, cand_classes: Tensor, iou_thresh: float,
                       class_aware: bool = True) -> Tensor:
    """(B, K, K) bool: [b, i, j] when candidate j outranks i and overlaps it."""
    k = cand_boxes.shape[1]
    iou = box_iou_matrix(cand_boxes)
    if class_aware:
        iou = torch.where(cand_classes[:, :, None] == cand_classes[:, None, :], iou, 0.0)
    tri = torch.ones(k, k, dtype=torch.bool, device=iou.device).tril(-1)  # j < i
    return (iou > iou_thresh) & tri


def sweep(blocked_by: Tensor, cand_ok: Tensor, keep: Tensor) -> Tensor:
    """keep_i <- ok_i & no kept higher-ranked box overlaps i."""
    return cand_ok & ~(blocked_by & keep[:, None, :]).any(-1)


def greedy_suppress(cand_boxes: Tensor, top_scores: Tensor, cand_classes: Tensor,
                    cand_coefs: Tensor, cand_ok: Tensor, iou_thresh: float,
                    max_det: int, class_aware: bool = True) -> Detections:
    """Greedy NMS over score-sorted (B, K) candidates -> (B, max_det) rows."""
    k = cand_boxes.shape[1]
    blocked_by = suppression_matrix(cand_boxes, cand_classes, iou_thresh, class_aware)
    # Sweep to the fixed point, at most k sweeps as tti's while_loop (position
    # i is final after at most i sweeps); the block ends at a fixed point when
    # its last sweep changed nothing.
    keep, done = cand_ok, 0
    while done < k:
        for _ in range(min(SWEEPS_PER_CHECK, k - done)):
            prev, keep = keep, sweep(blocked_by, cand_ok, keep)
            done += 1
        if torch.equal(prev, keep):
            break

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
