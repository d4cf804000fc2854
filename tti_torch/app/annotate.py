"""Host-side frame annotation, cv2 when present, numpy fallback (copy of
``tti.app.annotate``).

Reproduces the reference's overlay vocabulary (SURVEY.md §2
"Annotation/rendering"): ROI border (light green, reference:
measurement.py:230-236), stitch boxes cyan 1 px / fabric boxes magenta 2 px
(measurement.py:268,272), envelope polyline orange (measurement.py:292-296),
HUD text lines (measurement.py:487-504) and the orchestrator's status line
(main.py:296-309). Rendering is strictly a host concern — the device returns
geometry only (boxes, envelope, metrics), which is what keeps the hot path at
frame rate.

One deliberate difference: ``overlay_masks`` takes the proto stride from the
mask grid (input size / grid size), as ``envelope_to_polyline`` does. The
reference repeats every cell 4x, which on a stride-2 grid draws the top-left
quarter of each mask stretched over the frame.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None  # type: ignore[assignment]
    _HAS_CV2 = False

COLOR_STITCH = (255, 255, 0)  # cyan-ish BGR (reference: measurement.py:268)
COLOR_FABRIC = (255, 0, 255)  # magenta (reference: measurement.py:272)
COLOR_ENVELOPE = (255, 128, 0)  # orange (reference: measurement.py:296)
COLOR_ROI = (144, 238, 144)  # light green (reference: config.py:96)
COLOR_TEXT = (0, 0, 255)


def _rect_np(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color, thickness: int) -> None:
    h, w = img.shape[:2]
    x1, x2 = np.clip([x1, x2], 0, w - 1)
    y1, y2 = np.clip([y1, y2], 0, h - 1)
    for t in range(thickness):
        img[y1 + t : y2 + 1 : max(y2 - y1 - 2 * t, 1), x1:x2] = color
        img[y1:y2, x1 + t : x2 + 1 : max(x2 - x1 - 2 * t, 1)] = color


def annotate_frame(
    frame_bgr: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    stitch_class_id: int = 0,
    fabric_class_id: int = 1,
    envelope_frame_xy: np.ndarray | None = None,
    roi_bounds: tuple[int, int, int, int] | None = None,
    hud_lines: list[str] | None = None,
) -> np.ndarray:
    """Draw detections + envelope + HUD onto a copy of the frame."""
    out = frame_bgr.copy()

    if roi_bounds is not None:
        x1, y1, x2, y2 = (int(v) for v in roi_bounds)
        if _HAS_CV2:
            cv2.rectangle(out, (x1, y1), (x2, y2), COLOR_ROI, 2)
        else:
            _rect_np(out, x1, y1, x2, y2, COLOR_ROI, 2)

    for box, cls, ok in zip(boxes, classes, valid):
        if not ok:
            continue
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        color, thickness = (
            (COLOR_STITCH, 1) if int(cls) == stitch_class_id else (COLOR_FABRIC, 2)
        )
        if _HAS_CV2:
            cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        else:
            _rect_np(out, x1, y1, x2, y2, color, thickness)

    if envelope_frame_xy is not None and len(envelope_frame_xy) >= 2 and _HAS_CV2:
        step = max(1, len(envelope_frame_xy) // 1000)  # decimation like measurement.py:294
        poly = np.asarray(envelope_frame_xy[::step], np.int32)
        cv2.polylines(out, [poly], False, COLOR_ENVELOPE, 2)

    if hud_lines and _HAS_CV2:
        for i, line in enumerate(hud_lines):
            cv2.putText(out, line, (10, 30 + 25 * i), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        COLOR_TEXT, 2)
    return out


def overlay_masks(
    frame_bgr: np.ndarray,
    masks_proto: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    spec,
    alpha: float = 0.30,
    palette: tuple = ((0, 200, 255), (255, 0, 255), (0, 255, 0), (255, 128, 0)),
) -> np.ndarray:
    """Blend instance masks over the frame (the diagnostic viewer's 0.30/0.70
    addWeighted overlay with a per-class palette — SURVEY.md §2 annotation row,
    reference: Utils/check_model.py:155-165,255). masks_proto: (D, Hm, Wm)."""
    if not _HAS_CV2:
        return frame_bgr
    out = frame_bgr.copy()
    h, w = out.shape[:2]
    # The proto stride of this grid: 4 for the Ultralytics head, 2 for the
    # hi-res head.
    qy = spec.dst_h // masks_proto.shape[-2]
    qx = spec.dst_w // masks_proto.shape[-1]
    color_layer = np.zeros_like(out)
    any_mask = np.zeros((h, w), bool)
    # Content region of the letterboxed input in frame coords: whole frame.
    for mask, cls, ok in zip(masks_proto, classes, valid):
        if not ok:
            continue
        # proto grid -> input px (x q NEAREST) -> frame crop of content region.
        m_input = np.repeat(np.repeat(mask > 0, qy, axis=0), qx, axis=1)
        content = m_input[
            spec.pad_top : spec.pad_top + spec.new_h,
            spec.pad_left : spec.pad_left + spec.new_w,
        ]
        m_frame = cv2.resize(
            content.astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST
        ).astype(bool)
        color_layer[m_frame] = palette[int(cls) % len(palette)]
        any_mask |= m_frame
    out[any_mask] = (
        alpha * color_layer[any_mask] + (1 - alpha) * out[any_mask]
    ).astype(np.uint8)
    return out


def draw_measurement_geometry(
    frame_bgr: np.ndarray,
    stitches,
    envelope_frame_y,
    index: int | None = None,
) -> np.ndarray:
    """Width markers + centroids + edge-distance lines per stitch
    (reference: measurement.py:358-368,460-462). ``stitches`` is a StitchSet
    of numpy arrays; ``envelope_frame_y`` maps cx -> envelope y (or
    None to skip edge lines)."""
    if not _HAS_CV2:
        return frame_bgr
    out = frame_bgr
    sel = (lambda a: np.asarray(a)[index]) if index is not None else np.asarray
    cx, cy = sel(stitches.cx), sel(stitches.cy)
    left, right, valid = sel(stitches.left), sel(stitches.right), sel(stitches.valid)
    for i in range(len(cx)):
        if not valid[i]:
            continue
        lx, rx, y = int(round(left[i])), int(round(right[i])), int(round(cy[i]))
        cxi = int(round(cx[i]))
        cv2.circle(out, (lx, y), 3, (200, 200, 0), -1)
        cv2.circle(out, (rx, y), 3, (200, 200, 0), -1)
        cv2.line(out, (lx, y), (rx, y), (200, 200, 0), 1)
        cv2.circle(out, (cxi, y), 3, (200, 0, 0), -1)
        if envelope_frame_y is not None:
            ey = envelope_frame_y(cx[i])
            if ey is not None:
                cv2.line(out, (cxi, int(round(ey))), (cxi, y), (0, 255, 0), 1)
                cv2.circle(out, (cxi, int(round(ey))), 2, (255, 0, 255), -1)
    return out


def draw_fabric_contours(frame_bgr: np.ndarray, fabric_mask_frame: np.ndarray) -> np.ndarray:
    """External contours of the fabric union (reference: measurement.py:496-499)."""
    if not _HAS_CV2:
        return frame_bgr
    contours, _ = cv2.findContours(
        (fabric_mask_frame > 0).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    if contours:
        cv2.drawContours(frame_bgr, contours, -1, (0, 0, 255), 2)
    return frame_bgr


def envelope_to_polyline(envelope_mask_grid: np.ndarray, spec) -> np.ndarray:
    """(Wm,) envelope with -1 sentinels -> (K, 2) frame-space polyline points.

    The stride comes from the ACTUAL proto grid (spec.dst_w / Wm): 4 for the
    Ultralytics head, 2 for the hi-res head — same relations as
    tti_torch/measure/pipeline.py's grid mappings."""
    cols = np.where(envelope_mask_grid >= 0)[0]
    if cols.size == 0:
        return np.zeros((0, 2), np.int32)
    q = spec.dst_w / envelope_mask_grid.shape[0]
    xs = (cols * q + (q - 1.0) / 2.0 - spec.pad_left) / spec.scale
    ys = (envelope_mask_grid[cols] * q + (q - 1.0) - spec.pad_top) / spec.scale
    return np.stack([xs, ys], axis=-1).astype(np.int32)
