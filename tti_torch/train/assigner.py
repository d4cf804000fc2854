"""Task-aligned label assignment (TAL), batched over images (port of
``tti.train.assigner``).

For each ground-truth box, the top-k anchors by the alignment metric
``score^alpha * iou^beta`` among the anchors whose centre lies inside the
box become positives; an anchor claimed by several GTs keeps the one with
the highest IoU; classification targets are the metric normalised per GT to
its best IoU. Everything is dense (B, A, G): no data-dependent shapes.

Ties decide membership, so the top-k is k rounds of masked argmax, which
takes the lowest index among equal values as the reference's does
(``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def pairwise_iou(boxes_a: Tensor, boxes_b: Tensor, eps: float = 1e-9) -> Tensor:
    """(..., A, 4) x (..., G, 4) xyxy -> (..., A, G)."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area(boxes_a)[..., :, None] + area(boxes_b)[..., None, :] - inter + eps)


@torch.no_grad()
def task_aligned_assign(pred_boxes: Tensor, pred_probs: Tensor, anchors: Tensor,
                        gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0
                        ) -> dict[str, Tensor]:
    """Batched TAL. The result is labels: no gradient flows through it.

    pred_boxes (B, A, 4) decoded xyxy px; pred_probs (B, A, nc) sigmoid
    scores; anchors (A, 2) centres px; gt_boxes (B, G, 4); gt_classes (B, G)
    int; gt_valid (B, G) bool.

    Returns pos_mask (B, A) bool, assigned_gt (B, A) int64, target_boxes
    (B, A, 4), target_classes (B, A) int64, target_scores (B, A, nc).
    """
    b, a = pred_boxes.shape[:2]
    g = gt_boxes.shape[1]
    nc = pred_probs.shape[-1]
    iou = pairwise_iou(pred_boxes.float(), gt_boxes)  # (B, A, G)
    cls = gt_classes.clamp(min=0).long()
    score = torch.gather(pred_probs.float(), 2, cls[:, None, :].expand(b, a, g))  # (B, A, G)
    metric = score.pow(alpha) * iou.pow(beta)

    ax, ay = anchors[None, :, None, 0], anchors[None, :, None, 1]
    inside = ((ax >= gt_boxes[:, None, :, 0]) & (ax < gt_boxes[:, None, :, 2])
              & (ay >= gt_boxes[:, None, :, 1]) & (ay < gt_boxes[:, None, :, 3]))
    candidate = inside & gt_valid[:, None, :]
    # Candidates rank at metric >= 0, the others at -1; acceptance is
    # candidacy, not metric > 0 (a score that underflows to 0 must not drop
    # every positive).
    metric = torch.where(candidate, metric, torch.full_like(metric, -1.0))

    # Top-k per GT as k rounds of masked argmax (lowest index among ties).
    work = metric.transpose(1, 2).clone()  # (B, G, A)
    selected = torch.zeros_like(work, dtype=torch.bool)
    for _ in range(min(topk, a)):
        best, idx = work.max(dim=-1, keepdim=True)  # the first maximal index
        selected |= torch.zeros_like(selected).scatter_(-1, idx, best >= 0.0)
        work.scatter_(-1, idx, float("-inf"))
    assigned = selected.transpose(1, 2)  # (B, A, G)
    metric = metric.clamp(min=0.0)

    # An anchor claimed by several GTs keeps the highest-IoU one.
    multi = assigned.sum(-1) > 1
    best_gt = torch.where(assigned, iou, torch.full_like(iou, -1.0)).argmax(-1)
    assigned = torch.where(multi[..., None], assigned & F.one_hot(best_gt, g).bool(), assigned)

    pos_mask = assigned.any(-1)
    assigned_gt = assigned.to(torch.uint8).argmax(-1)  # 0 where none, as the reference

    pos_metric = torch.where(assigned, metric, torch.zeros_like(metric))
    pos_iou = torch.where(assigned, iou, torch.zeros_like(iou))
    norm = pos_iou.amax(1) / pos_metric.amax(1).clamp(min=1e-9)  # (B, G)
    anchor_score = (pos_metric * norm[:, None, :]).amax(-1)  # (B, A)

    gathered = torch.gather(cls, 1, assigned_gt)
    target_classes = torch.where(pos_mask, gathered, torch.zeros_like(gathered))
    target_scores = (F.one_hot(target_classes, nc).float()
                     * torch.where(pos_mask, anchor_score, torch.zeros_like(anchor_score))[..., None])
    target_boxes = torch.gather(gt_boxes, 1, assigned_gt[..., None].expand(b, a, 4))
    return {"pos_mask": pos_mask, "assigned_gt": assigned_gt, "target_boxes": target_boxes,
            "target_classes": target_classes, "target_scores": target_scores}
