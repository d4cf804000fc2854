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
carry its decoded image.

The host augmentation recipe (``train --host-aug``): :func:`hsv_jitter`,
:func:`random_scale_shift`, :func:`mosaic4`, :func:`augmented_scene` and
:func:`batches`, the reference's cv2 recipe with its numpy draws in its
order, so one seed gives the reference's batches. Each takes its no-cv2
branch as the reference does. Training augments on the device by default
(:mod:`tti_torch.train.augment`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tti_torch.core.logging import get_logger
from tti_torch.train.step import Targets

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


# The host recipe re-reads every image about 4 times per epoch (mosaic), so
# it keeps decoded files, up to the reference's 2 GB. The device path decodes
# each image once and keeps nothing here.
_HOST_CACHE: dict[tuple[str, int], np.ndarray] = {}
_HOST_CACHE_MAX_BYTES = 2 << 30


def _host_image(sample: Sample, imgsz: int) -> np.ndarray:
    """:func:`load_image` for the host recipe, with decoded files kept."""
    if sample.image is not None:
        return load_image(sample, imgsz)
    key = (sample.image_path, imgsz)
    img = _HOST_CACHE.get(key)
    if img is None:
        img = _load_resized_u8(sample.image_path, imgsz)
        if sum(a.nbytes for a in _HOST_CACHE.values()) + img.nbytes <= _HOST_CACHE_MAX_BYTES:
            _HOST_CACHE[key] = img
    return img.astype(np.float32) / 255.0


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


# ---------------------------------------------------------------------------
# The host augmentation recipe (``train --host-aug``): the Ultralytics
# train-time defaults (mosaic, hflip 0.5, HSV h=0.015 / s=0.7 / v=0.4, random
# scale +-0.5), drawing from one numpy Generator in the reference's order.
# ---------------------------------------------------------------------------


def hsv_jitter(image: np.ndarray, rng: np.random.Generator,
               hgain: float = 0.015, sgain: float = 0.7, vgain: float = 0.4) -> np.ndarray:
    """Random HSV colour jitter on a [0, 1] RGB float image: the three gains
    in one draw, the image truncated to uint8, the hue taken modulo 180.
    Without cv2, a value-only jitter (one draw)."""
    try:
        import cv2
    except ImportError:
        return np.clip(image * rng.uniform(1 - vgain, 1 + vgain), 0.0, 1.0)
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
    h, s, v = cv2.split(hsv)
    h = ((h.astype(np.float32) * r[0]) % 180).astype(np.uint8)
    s = np.clip(s.astype(np.float32) * r[1], 0, 255).astype(np.uint8)
    v = np.clip(v.astype(np.float32) * r[2], 0, 255).astype(np.uint8)
    out = cv2.cvtColor(cv2.merge([h, s, v]), cv2.COLOR_HSV2RGB)
    return out.astype(np.float32) / 255.0


def random_scale_shift(image: np.ndarray, polygons: list[np.ndarray], rng: np.random.Generator,
                       scale: float = 0.5, translate: float = 0.1
                       ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Random zoom about the centre and translation (the affine core of
    Ultralytics' RandomPerspective with rotation and shear off): cv2's
    bilinear warp with a 114/255 gray border, or without cv2 a nearest
    gather."""
    s = rng.uniform(1 - scale, 1 + scale)
    tx = rng.uniform(-translate, translate)
    ty = rng.uniform(-translate, translate)
    h, w = image.shape[:2]
    # Normalised-coordinate affine: p' = (p - 0.5) * s + 0.5 + t
    out_polys = [((p - 0.5) * s + 0.5 + np.array([tx, ty], np.float32)).astype(np.float32)
                 for p in polygons]
    try:
        import cv2
    except ImportError:
        ys, xs = np.mgrid[0:h, 0:w]
        sx = ((xs + 0.5) / w - 0.5 - tx) / s + 0.5
        sy = ((ys + 0.5) / h - 0.5 - ty) / s + 0.5
        xi = np.clip((sx * w - 0.5).round().astype(int), 0, w - 1)
        yi = np.clip((sy * h - 0.5).round().astype(int), 0, h - 1)
        out = image[yi, xi]
        oob = (sx < 0) | (sx >= 1) | (sy < 0) | (sy >= 1)
        out[oob] = 0.447
        return out.astype(np.float32), out_polys
    m = np.array([[s, 0, (0.5 + tx - 0.5 * s) * w],
                  [0, s, (0.5 + ty - 0.5 * s) * h]], np.float32)
    out = cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR,
                         borderValue=(0.447, 0.447, 0.447))  # 114/255 gray
    return out.astype(np.float32), out_polys


def mosaic4(samples: list[Sample], imgsz: int, rng: np.random.Generator
            ) -> tuple[np.ndarray, list[np.ndarray], list[int]]:
    """4-image mosaic: one image per quadrant of a 2S x 2S gray canvas,
    cropped back to S x S around a jittered centre (two draws)."""
    s = imgsz
    canvas = np.full((2 * s, 2 * s, 3), 114 / 255.0, np.float32)
    polys: list[np.ndarray] = []
    classes: list[int] = []
    for quadrant, sample in enumerate(samples[:4]):
        oy, ox = (quadrant // 2) * s, (quadrant % 2) * s
        canvas[oy:oy + s, ox:ox + s] = _host_image(sample, s)
        for poly, cls in zip(sample.polygons, sample.classes):
            p = poly * 0.5 + np.array([ox, oy], np.float32) / (2 * s)
            polys.append(p.astype(np.float32))
            classes.append(cls)
    cx = int(rng.uniform(0.25, 0.75) * 2 * s)
    cy = int(rng.uniform(0.25, 0.75) * 2 * s)
    x0 = int(np.clip(cx - s // 2, 0, s))
    y0 = int(np.clip(cy - s // 2, 0, s))
    image = canvas[y0:y0 + s, x0:x0 + s].copy()
    out_polys = [(p * 2 * s - np.array([x0, y0], np.float32)) / s for p in polys]
    return image, out_polys, classes


def augmented_scene(samples: list[Sample], idxs: np.ndarray, imgsz: int,
                    rng: np.random.Generator, mosaic_p: float = 1.0, scale: float = 0.5,
                    flip_p: float = 0.5) -> tuple[np.ndarray, list[np.ndarray], list[int]]:
    """One augmented scene from dataset indices: a mosaic of ``idxs[:4]``
    (probability ``mosaic_p``) or ``idxs[0]`` alone, then random scale and
    shift, HSV jitter and a horizontal flip (probability ``flip_p``)."""
    if len(idxs) >= 4 and rng.uniform() < mosaic_p:
        image, polys, classes = mosaic4([samples[i] for i in idxs[:4]], imgsz, rng)
    else:
        sample = samples[idxs[0]]
        image = _host_image(sample, imgsz)
        polys = [p.copy() for p in sample.polygons]
        classes = list(sample.classes)
    image, polys = random_scale_shift(image, polys, rng, scale=scale)
    image = hsv_jitter(image, rng)
    if rng.uniform() < flip_p:
        image = image[:, ::-1].copy()
        for p in polys:
            p[:, 0] = 1.0 - p[:, 0]
    return image, polys, classes


def batches(samples: list[Sample], batch_size: int, imgsz: int, max_gt: int = 32,
            seed: int = 0, augment: bool = True, epochs: int | None = None,
            mask_stride: int = 4, soft_masks=False) -> Iterator[tuple[np.ndarray, Targets]]:
    """Shuffled, padded host batches: (images (B, S, S, 3) float32 numpy,
    :class:`Targets` of CPU tensors), forever unless ``epochs`` bounds it.
    Per epoch one permutation; per image, with ``augment``, three random
    mosaic partners and :func:`augmented_scene`. The trailing
    ``len(samples) % batch_size`` images of each epoch are dropped."""
    if len(samples) < batch_size:
        raise ValueError(f"dataset has {len(samples)} images but batch_size={batch_size}; "
                         "training would silently run zero steps")
    remainder = len(samples) % batch_size
    if remainder:
        log.info("dropping %d trailing images per epoch (dataset %% batch_size)", remainder)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(samples))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            imgs, tgts = [], []
            for idx in order[start:start + batch_size]:
                if augment:
                    others = rng.integers(0, len(samples), 3)
                    img, polys, cls = augmented_scene(samples, np.concatenate([[idx], others]),
                                                      imgsz, rng)
                    img, t = scene_to_targets(img, polys, cls, imgsz, max_gt,
                                              mask_stride=mask_stride, soft_masks=soft_masks)
                else:
                    img, t = sample_to_targets(samples[idx], imgsz, max_gt,
                                               mask_stride=mask_stride, soft_masks=soft_masks)
                imgs.append(img)
                tgts.append(t)
            stack = {k: torch.from_numpy(np.stack([t[k] for t in tgts]))
                     for k in ("boxes", "classes", "masks", "valid")}
            yield np.stack(imgs), Targets(**stack)
        epoch += 1
