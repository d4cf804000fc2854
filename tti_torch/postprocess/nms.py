"""Fixed-shape batched NMS (port of ``tti.postprocess.nms``).

1. per-anchor best class; strict ``> conf_thresh`` candidate filter,
2. top ``pre_topk`` candidates by score,
3. the exact greedy keep-set of the K score-sorted candidates
   (:func:`tti_torch.kernels.nms.greedy_keep`, kernel D on the card: the
   reference's device ``while_loop``, with no read back to the host),
4. the top ``max_det`` survivors, padded with valid=False rows.

:func:`nms_from_raw` is the reference's lazy decode: it ranks anchors by
their raw class logit and decodes DFL boxes for the K candidates only.

Every ranking is a stable descending sort, so ties keep the lower index
first, as ``jax.lax.top_k`` does (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

import math

import torch

from tti_torch.kernels.nms import greedy_keep
from tti_torch.postprocess.decode import (
    Detections, dfl_expectation, flatten_predictions, make_anchors,
)

Tensor = torch.Tensor


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
    keep = greedy_keep(cand_boxes, cand_classes, cand_ok, iou_thresh, class_aware)
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


def _logit_threshold(conf_thresh: float) -> float:
    """``logit(conf_thresh)``, +-inf outside (0, 1): sigmoid is strictly
    monotonic, so ``logit > this`` selects what ``sigmoid(logit) >
    conf_thresh`` selects."""
    if 0.0 < conf_thresh < 1.0:
        return math.log(conf_thresh / (1.0 - conf_thresh))
    return -math.inf if conf_thresh <= 0.0 else math.inf


def raw_candidate_counts(raw, conf_thresh: float) -> Tensor:
    """(B,) int32: the anchors whose best class logit clears
    ``logit(conf_thresh)``, the budget telemetry of the fixed ``pre_topk``."""
    _, cls_l, _, _ = flatten_predictions(raw)
    best = cls_l.float().amax(-1)
    return (best > _logit_threshold(conf_thresh)).sum(-1).to(torch.int32)


def nms_from_raw(raw, conf_thresh: float = 0.20, iou_thresh: float = 0.25, max_det: int = 200,
                 pre_topk: int = 512, class_aware: bool = True) -> Detections:
    """Lazy decode + NMS: rank anchors by their best raw class logit (in
    float32, against ``logit(conf_thresh)``), take the stable top
    ``pre_topk``, and decode DFL boxes only for those rows. Equal to
    ``decode_predictions`` + :func:`batched_nms`: sigmoid is monotonic, and
    the DFL expectation is per anchor."""
    box_l, cls_l, coef_l, level_hw = flatten_predictions(raw)
    anchors, stride_pa = make_anchors(level_hw, device=box_l.device)
    best_logit = cls_l.amax(-1).float()
    classes_all = cls_l.argmax(-1).to(torch.int32)
    ranked = torch.where(best_logit > _logit_threshold(conf_thresh), best_logit, -math.inf)
    k = min(pre_topk, ranked.shape[1])
    top_logits, top_idx = stable_topk(ranked, k)
    cand_ok = torch.isfinite(top_logits)
    top_scores = torch.where(cand_ok, torch.sigmoid(top_logits), -1.0)
    ltrb = dfl_expectation(_gather_rows(box_l, top_idx)) * stride_pa[top_idx][..., None]
    cx, cy = anchors[top_idx, 0], anchors[top_idx, 1]
    cand_boxes = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                              cx + ltrb[..., 2], cy + ltrb[..., 3]], dim=-1)
    return greedy_suppress(cand_boxes, top_scores, _gather_rows(classes_all, top_idx),
                           _gather_rows(coef_l, top_idx).float(), cand_ok, iou_thresh,
                           max_det, class_aware)
