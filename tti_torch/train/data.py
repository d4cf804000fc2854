"""YOLO-format segmentation datasets (port of the dataset half of
``tti.train.data``).

Label format per line: ``class x1 y1 x2 y2 ...`` (normalised polygon
vertices). Masks rasterise at proto resolution (input / mask_stride); boxes
come from polygon extents; everything is padded to ``max_gt`` with
valid=False.

Rasterising needs no image library: :func:`rasterize_polygon` is the
reference's even-odd scanline fill (the reference prefers ``cv2.fillPoly``
when it can import cv2, which differs on boundary cells). Decoding image
files takes cv2 or PIL, whichever imports; a :class:`Sample` may instead
carry its decoded image. The host augmentation recipe of the reference
(``hsv_jitter``, ``random_scale_shift``, ``mosaic4``, ``batches``) is not
ported: training augments on the device (:mod:`tti_torch.train.augment`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from tti_torch.core.logging import get_logger

log = get_logger("train.data")

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclass
class Sample:
    image_path: str
    polygons: list[np.ndarray]  # each (K, 2) normalised [0, 1]
    classes: list[int]
    image: np.ndarray | None = None  # decoded (S, S, 3) uint8 RGB, in place of the file


def _labels_path(image_path: str) -> str:
    base, _ = os.path.splitext(image_path)
    candidate = base + ".txt"
    if os.path.exists(candidate):
        return candidate
    # Standard YOLO layout: .../images/x.jpg -> .../labels/x.txt
    return candidate.replace(f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}")


def parse_label_file(path: str) -> tuple[list[np.ndarray], list[int]]:
    polygons: list[np.ndarray] = []
    classes: list[int] = []
    if not os.path.exists(path):
        return polygons, classes
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 7 or (len(parts) - 1) % 2 != 0:
                continue  # need >= 3 vertices
            classes.append(int(float(parts[0])))
            coords = np.asarray([float(v) for v in parts[1:]], np.float32).reshape(-1, 2)
            polygons.append(np.clip(coords, 0.0, 1.0))
    return polygons, classes


def discover_dataset(images_dir: str) -> list[Sample]:
    samples = []
    for name in sorted(os.listdir(images_dir)):
        if not name.lower().endswith(IMG_EXTS):
            continue
        path = os.path.join(images_dir, name)
        polygons, classes = parse_label_file(_labels_path(path))
        samples.append(Sample(path, polygons, classes))
    if not samples:
        raise FileNotFoundError(f"no images in {images_dir}")
    log.info("dataset: %d images from %s", len(samples), images_dir)
    return samples


def rasterize_polygon(poly_norm: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Normalised polygon -> binary float32 mask at hw: an even-odd scanline
    fill at row centres, the reference's fill without cv2, with every row
    at once. Crossings are computed in float32 in the reference's order."""
    h, w = hw
    pts = poly_norm * np.array([w, h], np.float32)
    x1, y1 = pts[:, 0], pts[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    yc = (np.arange(h, dtype=np.float32) + np.float32(0.5))[:, None]  # (h, 1)
    crosses = ((y1 <= yc) & (yc < y2)) | ((y2 <= yc) & (yc < y1))  # (h, n)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = x1 + (yc - y1) / (y2 - y1) * (x2 - x1)
    x = np.sort(np.where(crosses, x, np.inf), axis=1)
    fill = np.zeros((h, w + 1), np.int32)
    rows = np.arange(h)
    for k in range(0, x.shape[1] - 1, 2):
        a, b = x[:, k], x[:, k + 1]
        ok = np.isfinite(b)
        lo = np.maximum(0, np.ceil(a[ok] - np.float32(0.5)).astype(np.int64))
        hi = np.minimum(w, np.floor(b[ok] + np.float32(0.5)).astype(np.int64))
        ok_rows = rows[ok][lo < hi]
        np.add.at(fill, (ok_rows, lo[lo < hi]), 1)
        np.add.at(fill, (ok_rows, hi[lo < hi]), -1)
    return (np.cumsum(fill[:, :w], axis=1) > 0).astype(np.float32)


def rasterize_polygon_soft(poly_norm: np.ndarray, hw: tuple[int, int],
                           factor: int) -> np.ndarray:
    """Area-occupancy raster: the binary raster at (h*factor, w*factor),
    box-filtered down to hw, so each cell holds the fraction of it inside
    the polygon."""
    full = rasterize_polygon(poly_norm, (hw[0] * factor, hw[1] * factor))
    return full.reshape(hw[0], factor, hw[1], factor).mean(axis=(1, 3))


def _load_resized_u8(path: str, imgsz: int) -> np.ndarray:
    """Decoded, square-resized RGB uint8, with cv2 (bilinear) or PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"unreadable image {path}")
        img = cv2.resize(img, (imgsz, imgsz), interpolation=cv2.INTER_LINEAR)
        return np.ascontiguousarray(img[..., ::-1])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding {path} needs cv2 or PIL; neither imports "
                          "(give the Sample its decoded image instead)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((imgsz, imgsz)))


def load_sample_u8(sample: Sample, imgsz: int) -> np.ndarray:
    """The sample's (imgsz, imgsz, 3) uint8 RGB image: its own decoded image
    (which must have that size) or the file's."""
    if sample.image is None:
        return _load_resized_u8(sample.image_path, imgsz)
    if sample.image.shape != (imgsz, imgsz, 3) or sample.image.dtype != np.uint8:
        raise ValueError(f"{sample.image_path}: decoded image {sample.image.shape} "
                         f"{sample.image.dtype}, expected ({imgsz}, {imgsz}, 3) uint8")
    return sample.image


def load_image(sample: Sample, imgsz: int) -> np.ndarray:
    """The sample's image as normalised float32 RGB."""
    return load_sample_u8(sample, imgsz).astype(np.float32) / 255.0


def soft_class_ids(soft_masks, num_classes: int = 2, stitch_class_id: int = 0,
                   fabric_class_id: int = 1) -> tuple[int, ...]:
    """Every accepted ``soft_masks`` spelling -> the class ids trained with
    soft (area-occupancy) targets: False/None/"" -> (); True/"all" -> every
    class; "stitch" / "fabric" -> that class; "0,1" or an iterable of ints
    -> as given."""
    if soft_masks is None or soft_masks is False or soft_masks == "":
        return ()
    if soft_masks is True or soft_masks == "all":
        return tuple(range(num_classes))
    if soft_masks == "stitch":
        return (stitch_class_id,)
    if soft_masks == "fabric":
        return (fabric_class_id,)
    if isinstance(soft_masks, str):
        return tuple(int(t) for t in soft_masks.split(",") if t.strip())
    return tuple(int(c) for c in soft_masks)


def scene_to_targets(image: np.ndarray, polygons: list[np.ndarray], classes: list[int],
                     imgsz: int, max_gt: int, mask_stride: int = 4, soft_masks=False
                     ) -> tuple[np.ndarray, dict]:
    """(image, normalised polygons) -> padded targets (numpy): boxes,
    classes, masks at the proto grid (soft classes as occupancy fractions),
    valid, and ``src_index``, the input polygon of each kept slot.
    Degenerate GT (under 2 px) is dropped."""
    hm = wm = imgsz // mask_stride
    boxes = np.zeros((max_gt, 4), np.float32)
    out_classes = np.zeros((max_gt,), np.int32)
    masks = np.zeros((max_gt, hm, wm), np.float32)
    valid = np.zeros((max_gt,), bool)
    src_index = np.full((max_gt,), -1, np.int32)
    soft_ids = soft_class_ids(soft_masks)
    n_kept = 0
    for src_i, (poly, cls) in enumerate(zip(polygons, classes)):
        if n_kept >= max_gt:
            break
        p = np.clip(poly, 0.0, 1.0)
        w = p[:, 0].max() - p[:, 0].min()
        h = p[:, 1].max() - p[:, 1].min()
        if w * imgsz < 2.0 or h * imgsz < 2.0:
            continue
        boxes[n_kept] = [p[:, 0].min() * imgsz, p[:, 1].min() * imgsz,
                         p[:, 0].max() * imgsz, p[:, 1].max() * imgsz]
        out_classes[n_kept] = cls
        masks[n_kept] = (rasterize_polygon_soft(p, (hm, wm), mask_stride)
                         if cls in soft_ids else rasterize_polygon(p, (hm, wm)))
        valid[n_kept] = True
        src_index[n_kept] = src_i
        n_kept += 1
    return image, {"boxes": boxes, "classes": out_classes, "masks": masks,
                   "valid": valid, "src_index": src_index}


def sample_to_targets(sample: Sample, imgsz: int, max_gt: int, hflip: bool = False,
                      mask_stride: int = 4, soft_masks=False) -> tuple[np.ndarray, dict]:
    image = load_image(sample, imgsz)
    polys = [p.copy() for p in sample.polygons]
    if hflip:
        image = image[:, ::-1].copy()
        for p in polys:
            p[:, 0] = 1.0 - p[:, 0]
    return scene_to_targets(image, polys, sample.classes, imgsz, max_gt,
                            mask_stride=mask_stride, soft_masks=soft_masks)
