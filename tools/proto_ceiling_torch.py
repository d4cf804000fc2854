"""The proto-resolution ceiling on full-resolution mask AP, through the port
(``tti_torch``): the counterpart of ``tools/proto_ceiling.py``.

YOLOv8-seg represents every instance mask as a coefficient vector against a
prototype basis at input / mask-stride resolution; the deployed mask is
sigmoid(coef . proto) -> crop -> bilinear upsample -> (> 0.5) (Ultralytics
``process_mask(upsample=True)``). This tool measures the representation's
ceiling: it feeds the evaluator oracle predictions (perfect boxes, classes
and scores, and the best proto-grid rendering of the ground-truth mask
itself pushed through that chain), so any AP lost here is lost to
resolution, not to learning. Two oracles bound the family:

- soft:   area-downsampled GT occupancy on the proto grid (sub-cell boundary
          placement through intermediate sigmoid values);
- binary: hard 0/1 proto cells (saturated logits).

The GT masks are ``tti_torch.train.data.rasterize_polygon``'s; the oracle
chain (area downsample, crop, bilinear upsample with cv2 ``INTER_LINEAR``'s
half-pixel centres and clamped border, threshold) runs as torch ops on
``--device``; the AP is ``tti_torch.train.eval.evaluate``'s. It imports
nothing of ``tti``.

Usage (the card by default; ``--device cpu`` on the host):
  python tools/proto_ceiling_torch.py --images DATASET/images [--imgsz 640 960]
      [--mask-stride 4] [--out build/MASK_CEILING_torch.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tti_torch.train.data import discover_dataset, rasterize_polygon  # noqa: E402
from tti_torch.train.eval import IOU_THRESHOLDS, ImageEval, evaluate  # noqa: E402


def area_downsample(mask, factor: int):
    """Exact box-filter occupancy of (..., H, W) masks: the fraction of each
    factor x factor cell inside the full-resolution binary mask."""
    import torch.nn.functional as F

    return F.avg_pool2d(mask.unsqueeze(-3), factor).squeeze(-3)


def bilinear_upsample(mask, out_hw: tuple[int, int]):
    """Bilinear resize of (..., h, w) masks with half-pixel centres and the
    border clamped (cv2 ``INTER_LINEAR``; ``jax.image.resize`` 'bilinear'
    agrees on an upsample)."""
    import torch.nn.functional as F

    lead = mask.shape[:-2]
    out = F.interpolate(mask.reshape(-1, 1, *mask.shape[-2:]), size=out_hw, mode="bilinear",
                        align_corners=False)
    return out.reshape(*lead, *out_hw)


def crop_proto(mask, box_proto):
    """Zero (..., h, w) masks outside their boxes (..., 4) at proto
    resolution, xyxy, compared in float64 (``crop_masks`` semantics)."""
    import torch

    h, w = mask.shape[-2:]
    rows = torch.arange(h, dtype=torch.float64, device=mask.device)[:, None]
    cols = torch.arange(w, dtype=torch.float64, device=mask.device)[None, :]
    x1, y1, x2, y2 = (box_proto[..., i, None, None] for i in range(4))
    inside = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return mask * inside


def oracle_masks(gt_full: np.ndarray, boxes: np.ndarray, imgsz: int, variant: str,
                 stride: int = 4, device: str = "cuda") -> np.ndarray:
    """GT masks (N, S, S) -> the deployment chain's masks through the best
    proto rendering (float32 0/1, numpy)."""
    import torch

    gt = torch.as_tensor(gt_full, dtype=torch.float32, device=device)
    proto = area_downsample(gt, stride)
    if variant == "binary":
        proto = (proto >= 0.5).float()
    proto = crop_proto(proto, torch.as_tensor(boxes * (1.0 / stride), dtype=torch.float64,
                                              device=device))
    up = bilinear_upsample(proto, (imgsz, imgsz))
    return (up > 0.5).float().cpu().numpy()


def run_geometry(samples, imgsz: int, variant: str, stride: int = 4,
                 device: str = "cuda") -> dict[str, float]:
    """Mask AP of the oracle at ``imgsz`` over ``samples`` (those without
    polygons skipped)."""
    images = []
    for s in samples:
        if not s.polygons:
            continue
        gt_full = np.stack([rasterize_polygon(p, (imgsz, imgsz)) for p in s.polygons])
        boxes = np.stack([np.concatenate([p.min(0), p.max(0)]) * imgsz
                          for p in s.polygons]).astype(np.float64)
        classes = np.asarray(s.classes, np.int64)
        pred = oracle_masks(gt_full, boxes, imgsz, variant, stride, device)
        images.append(ImageEval(pred_boxes=boxes, pred_scores=np.ones(len(boxes)),
                                pred_classes=classes, gt_boxes=boxes, gt_classes=classes,
                                pred_masks=pred, gt_masks=gt_full))
    return evaluate(images, num_classes=2, use_masks=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", required=True, help="a YOLO-format dataset's images directory")
    ap.add_argument("--imgsz", type=int, nargs="*", default=[640, 960])
    ap.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                    help="proto grid = imgsz/stride (2 = the hi-res head)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "MASK_CEILING_torch.md"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("proto_ceiling_torch: no CUDA device (pass --device cpu for the host)",
              file=sys.stderr)
        return 2
    samples = discover_dataset(args.images)
    rows = []
    for imgsz in args.imgsz:
        for variant in ("soft", "binary"):
            t0 = time.time()
            m = run_geometry(samples, imgsz, variant, args.mask_stride, args.device)
            rows.append((imgsz, variant, m))
            print(f"imgsz={imgsz} proto={imgsz // args.mask_stride} {variant}: "
                  f"stitch AP50-95 {m.get('AP_class_0', float('nan')):.3f}  "
                  f"fabric {m.get('AP_class_1', float('nan')):.3f}  "
                  f"mAP50 {m['mAP50']:.3f}  mAP50-95 {m['mAP50_95']:.3f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    st = args.mask_stride
    lines = [
        "# MASK CEILING (tti_torch) — proto-resolution upper bound on full-res mask AP",
        "",
        "- Oracle predictions: perfect boxes/classes/scores; masks are the GT itself",
        f"  rendered on the proto grid (input/{st}) and pushed through the deployment",
        "  chain (crop -> bilinear upsample -> >0.5). AP lost here is lost to",
        f"  resolution, not to the network. {len(samples)} scenes from `{args.images}`,",
        f"  thresholds {IOU_THRESHOLDS[0]}..{IOU_THRESHOLDS[-1]}; device {args.device}.",
        "- soft = area-occupancy proto cells (sub-cell boundary placement);",
        "  binary = hard 0/1 cells (saturated logits).",
        "",
        "| imgsz | proto grid | oracle | stitch AP50-95 | fabric AP50-95 | mAP50 | mAP50-95 |",
        "|---|---|---|---|---|---|---|",
        *[f"| {s} | {s // st}x{s // st} | {v} "
          f"| {m.get('AP_class_0', float('nan')):.3f} "
          f"| {m.get('AP_class_1', float('nan')):.3f} | {m['mAP50']:.3f} "
          f"| {m['mAP50_95']:.3f} |" for s, v, m in rows],
        "",
        f"Generated by tools/proto_ceiling_torch.py, {time.strftime('%Y-%m-%d %H:%M:%S')}.",
    ]
    text = "\n".join(lines) + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
