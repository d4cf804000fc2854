"""Detection/segmentation evaluation: COCO-style mAP on host (numpy; copy
of ``tti.train.eval``, plus :func:`evaluate_samples`, the chunked predict
loop of ``tti eval``).

The reference has no evaluation tooling at all (models arrive pre-trained,
SURVEY.md §4); the framework needs one to close the train -> validate -> deploy
loop. Standard protocol: greedy score-ordered matching per class at each IoU
threshold, 101-point interpolated average precision, averaged over
IoU 0.50:0.95 (mAP) plus mAP50. Box IoU and instance-mask IoU are both
supported; eval runs on host because it is not a hot path.
"""

from __future__ import annotations

from dataclasses import dataclass

import time
from typing import Callable

import numpy as np

from tti_torch.train.data import Sample, rasterize_polygon, sample_to_targets

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,H,W) x (M,H,W) binary -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(bool)
    bf = b.reshape(len(b), -1).astype(bool)
    inter = af.astype(np.float64) @ bf.T.astype(np.float64)
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


@dataclass
class ImageEval:
    """Per-image eval payload: predictions (score-sortable) + ground truth."""

    pred_boxes: np.ndarray  # (P, 4)
    pred_scores: np.ndarray  # (P,)
    pred_classes: np.ndarray  # (P,)
    gt_boxes: np.ndarray  # (G, 4)
    gt_classes: np.ndarray  # (G,)
    pred_masks: np.ndarray | None = None  # (P, H, W) binary
    gt_masks: np.ndarray | None = None  # (G, H, W)


def _average_precision(matched: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from per-prediction match flags."""
    if n_gt == 0:
        return float("nan")
    if len(matched) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # Precision envelope + 101-point sampling.
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    samples = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, samples, side="left")
    prec = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(prec.mean())


def _class_iou_tables(
    images: list[ImageEval], cls: int, use_masks: bool
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-image (iou_matrix, score_order, scores) for one class — the IoU
    matrix is threshold-independent, so computing it once here and matching
    greedily per threshold on the cached table is ~10x cheaper than
    recomputing it for every IoU threshold (the mask matrices are full-image
    matmuls; the greedy match is trivial)."""
    tables = []
    for img in images:
        psel = img.pred_classes == cls
        gsel = img.gt_classes == cls
        ps = img.pred_scores[psel]
        order = np.argsort(-ps, kind="stable")
        if use_masks:
            iou = mask_iou_matrix(img.pred_masks[psel], img.gt_masks[gsel])
        else:
            iou = box_iou(img.pred_boxes[psel], img.gt_boxes[gsel])
        tables.append((iou, order, ps))
    return tables


def _match_class_cached(
    tables: list[tuple[np.ndarray, np.ndarray, np.ndarray]], iou_thresh: float
) -> tuple[np.ndarray, np.ndarray, int]:
    matched_all, scores_all, n_gt = [], [], 0
    for iou, order, ps in tables:
        n_gt += iou.shape[1]
        taken = np.zeros(iou.shape[1], bool)
        matched = np.zeros(len(ps), bool)
        for i in order:
            if iou.shape[1] == 0:
                break
            j = int(np.argmax(np.where(taken, -1.0, iou[i])))
            if iou[i, j] >= iou_thresh and not taken[j]:
                taken[j] = True
                matched[i] = True
        matched_all.append(matched)
        scores_all.append(ps)
    if matched_all:
        return np.concatenate(matched_all), np.concatenate(scores_all), n_gt
    return np.zeros(0, bool), np.zeros(0), n_gt


def evaluate(
    images: list[ImageEval],
    num_classes: int,
    iou_thresholds: tuple[float, ...] = IOU_THRESHOLDS,
    use_masks: bool = False,
) -> dict[str, float]:
    """Returns {'mAP50': ..., 'mAP50_95': ..., 'AP_class_{c}': ...}."""
    per_class_ap: dict[int, list[float]] = {c: [] for c in range(num_classes)}
    for cls in range(num_classes):
        tables = _class_iou_tables(images, cls, use_masks)
        for thresh in iou_thresholds:
            matched, scores, n_gt = _match_class_cached(tables, thresh)
            ap = _average_precision(matched, scores, n_gt)
            per_class_ap[cls].append(ap)

    out: dict[str, float] = {}
    ap50, ap_all = [], []
    for cls, aps in per_class_ap.items():
        aps_arr = np.asarray(aps, dtype=np.float64)
        if np.all(np.isnan(aps_arr)):
            continue
        out[f"AP_class_{cls}"] = float(np.nanmean(aps_arr))
        ap50.append(aps_arr[0])
        ap_all.append(np.nanmean(aps_arr))
    out["mAP50"] = float(np.nanmean(ap50)) if ap50 else 0.0
    out["mAP50_95"] = float(np.nanmean(ap_all)) if ap_all else 0.0
    return out


def evaluate_samples(samples: list[Sample], predictor, imgsz: int, num_classes: int,
                     mask_stride: int, chunk: int = 8,
                     progress: Callable[[str], None] | None = None) -> dict:
    """``tti eval``'s loop: square-resized images through ``predictor``
    (a :class:`tti_torch.app.predict.Predictor` at frame size (imgsz, imgsz)
    with ``proto_masks``) in chunks, a short last chunk padded with black
    images when there is more than one chunk; then box mAP, mask mAP at the
    proto grid (GT rasterised there) and at full resolution (the
    ``process_mask(upsample=True)`` masks against GT rasterised at imgsz).
    Returns the three metric dicts and the host seconds of the predict calls
    and of the three ``evaluate`` calls."""
    eval_proto: list[ImageEval] = []
    eval_full: list[ImageEval] = []
    t_start = time.perf_counter()
    predict_s = 0.0
    for c0 in range(0, len(samples), chunk):
        if c0 and progress is not None:
            progress(f"eval {c0}/{len(samples)} ({time.perf_counter() - t_start:.0f}s)")
        batch_samples = samples[c0:c0 + chunk]
        prepped = [sample_to_targets(s, imgsz, max_gt=64, mask_stride=mask_stride)
                   for s in batch_samples]
        bgr = np.stack([(img[..., ::-1] * 255).astype(np.uint8) for img, _ in prepped])
        if len(bgr) < chunk and len(samples) > chunk:  # keep one batch shape
            bgr = np.concatenate([bgr, np.zeros((chunk - len(bgr), *bgr.shape[1:]), bgr.dtype)])
        t0 = time.perf_counter()
        res = predictor(bgr)
        predict_s += time.perf_counter() - t0
        for b, (sample, (_, t)) in enumerate(zip(batch_samples, prepped)):
            valid = res.valid[b]
            m = min(int(valid.sum()), res.masks_input.shape[1])
            common = dict(
                pred_boxes=res.boxes[b][valid][:m],
                pred_scores=res.scores[b][valid][:m],
                pred_classes=res.classes[b][valid][:m],
                gt_boxes=t["boxes"][t["valid"]],
                gt_classes=t["classes"][t["valid"]],
            )
            eval_proto.append(ImageEval(**common, pred_masks=res.masks_proto[b][:m],
                                        gt_masks=np.asarray(t["masks"][t["valid"]])))
            # The raw polygon of each kept GT slot (degenerate GT is dropped,
            # so position in the padded targets is not position in the list).
            polys = [sample.polygons[i] for i in t["src_index"][t["valid"]]]
            gt_full = (np.stack([rasterize_polygon(p, (imgsz, imgsz)) for p in polys])
                       if polys else np.zeros((0, imgsz, imgsz), np.float32))
            eval_full.append(ImageEval(**common, pred_masks=res.masks_input[b][:m],
                                       gt_masks=gt_full))
    t0 = time.perf_counter()
    out = {"box": evaluate(eval_full, num_classes),
           "mask_proto": evaluate(eval_proto, num_classes, use_masks=True),
           "mask_full": evaluate(eval_full, num_classes, use_masks=True)}
    out["evaluate_s"] = time.perf_counter() - t0
    out["predict_s"] = predict_s
    out["images"] = len(samples)
    return out
