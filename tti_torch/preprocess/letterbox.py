"""Letterbox geometry and the u8 BGR -> normalized RGB resize (port of
``tti.preprocess.letterbox``).

Ultralytics semantics: uniform scale r = min(T/h, T/w), bilinear resize to
(round(h*r), round(w*r)) with no antialias prefilter (cv2.INTER_LINEAR), and
centered padding with 114/255. 'rect' mode pads only to the next stride-32
multiple. Tensors are NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

PAD_VALUE = 114.0  # Ultralytics letterbox border color


@dataclass(frozen=True)
class LetterboxSpec:
    """Static geometry of a letterbox transform (source -> target)."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int
    scale: float
    new_h: int  # resized content height
    new_w: int
    pad_top: int
    pad_left: int


def letterbox_spec(src_h: int, src_w: int, target: int | tuple[int, int]) -> LetterboxSpec:
    dst_h, dst_w = (target, target) if isinstance(target, int) else target
    r = min(dst_h / src_h, dst_w / src_w)
    new_h, new_w = round(src_h * r), round(src_w * r)
    return LetterboxSpec(src_h, src_w, dst_h, dst_w, r, new_h, new_w,
                         (dst_h - new_h) // 2, (dst_w - new_w) // 2)


def letterbox_spec_rect(src_h: int, src_w: int, target: int | tuple[int, int],
                        stride: int = 32) -> LetterboxSpec:
    """Ultralytics auto minimal-rect letterbox (LetterBox(auto=True)): the
    target rounds up to a stride multiple, then each axis pads only up to
    the next stride multiple, split with round(x/2 -+ 0.1)."""
    th, tw = (target, target) if isinstance(target, int) else target
    th = -(-th // stride) * stride
    tw = -(-tw // stride) * stride
    r = min(th / src_h, tw / src_w)
    new_h, new_w = round(src_h * r), round(src_w * r)
    dh = (th - new_h) % stride
    dw = (tw - new_w) % stride
    return LetterboxSpec(src_h, src_w, new_h + dh, new_w + dw, r, new_h, new_w,
                         int(round(dh / 2 - 0.1)), int(round(dw / 2 - 0.1)))


def make_letterbox_spec(src_h: int, src_w: int, target: int | tuple[int, int],
                        mode: str = "square", stride: int = 32) -> LetterboxSpec:
    if mode == "rect":
        return letterbox_spec_rect(src_h, src_w, target, stride)
    if mode == "square":
        return letterbox_spec(src_h, src_w, target)
    raise ValueError(f"letterbox mode must be 'square' or 'rect', got {mode!r}")


def bgr_to_rgb(frames: Tensor) -> Tensor:
    """(..., 3) channel flip."""
    return frames.flip(-1)


def normalize(frames: Tensor, dtype=torch.float32) -> Tensor:
    """uint8 [0,255] -> float [0,1] (divides in ``dtype``, as the reference)."""
    return frames.to(dtype) / torch.tensor(255.0, dtype=dtype)


def letterbox(frames: Tensor, spec: LetterboxSpec, dtype=torch.float32) -> Tensor:
    """(B, H, W, 3) float frames -> (B, dst_h, dst_w, 3): the bilinear resize
    (no antialias prefilter, cv2.INTER_LINEAR) computed in ``dtype``, then the
    centred pad with 114/255. ``F.interpolate`` clamps a sample position that
    falls before the first pixel centre where ``jax.image.resize`` drops the
    tap past the border and renormalises the other: for the triangle kernel
    both read the edge pixel."""
    x = F.interpolate(frames.to(dtype).permute(0, 3, 1, 2), size=(spec.new_h, spec.new_w),
                      mode="bilinear", align_corners=False, antialias=False)
    pad_bottom = spec.dst_h - spec.new_h - spec.pad_top
    pad_right = spec.dst_w - spec.new_w - spec.pad_left
    return F.pad(x.permute(0, 2, 3, 1),
                 (0, 0, spec.pad_left, pad_right, spec.pad_top, pad_bottom),
                 value=PAD_VALUE / 255.0)


def decimation_stride(spec: LetterboxSpec) -> int | None:
    """The stride k if the resize is an exact odd-integer decimation whose
    bilinear sample positions land on source pixel centers, else None."""
    if spec.new_h == 0 or spec.new_w == 0:
        return None
    if spec.src_h % spec.new_h or spec.src_w % spec.new_w:
        return None
    k = spec.src_h // spec.new_h
    if k != spec.src_w // spec.new_w or k < 2 or k % 2 == 0:
        return None
    return k


def letterbox_content(frames_bgr_u8: Tensor, spec: LetterboxSpec, dtype=torch.float32,
                      decimate: bool = False, rows: tuple[int, int] | None = None) -> Tensor:
    """uint8 BGR (B, H, W, 3) -> normalized RGB content (B, new_h, new_w, 3),
    the letterbox without its padding. ``decimate=True`` takes the exact
    strided slice when the geometry is an odd-integer decimation (bit-exact
    against the bilinear resize). ``rows=(y0, y1)``: content rows [y0, y1)
    only; the decimation reads those source rows alone, the bilinear resize
    runs on the whole frame first."""
    y0, y1 = rows if rows is not None else (0, spec.new_h)
    k = decimation_stride(spec) if decimate else None
    if k is not None:
        off = (k - 1) // 2
        small = frames_bgr_u8[:, off + k * y0::k, off::k, :][:, :y1 - y0, :spec.new_w, :]
        return normalize(bgr_to_rgb(small), dtype)
    x = normalize(bgr_to_rgb(frames_bgr_u8), dtype).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(spec.new_h, spec.new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    x = x.permute(0, 2, 3, 1)
    return x if rows is None else x[:, y0:y1]


def letterbox_u8(frames_bgr_u8: Tensor, spec: LetterboxSpec, dtype=torch.float32,
                 rows: tuple[int, int] | None = None) -> Tensor:
    """uint8 BGR -> padded, normalized RGB letterbox (B, dst_h, dst_w, 3);
    ``rows=(r0, r1)``: its rows [r0, r1) only (B, r1 - r0, dst_w, 3)."""
    r0, r1 = rows if rows is not None else (0, spec.dst_h)
    y0 = min(max(r0 - spec.pad_top, 0), spec.new_h)
    y1 = max(min(r1 - spec.pad_top, spec.new_h), y0)
    content = letterbox_content(frames_bgr_u8, spec, dtype, decimate=True,
                                rows=None if rows is None else (y0, y1))
    pad_top = y0 + spec.pad_top - r0
    pad_bottom = r1 - (y1 + spec.pad_top)
    pad_right = spec.dst_w - spec.new_w - spec.pad_left
    return F.pad(content, (0, 0, spec.pad_left, pad_right, pad_top, pad_bottom),
                 value=PAD_VALUE / 255.0)


def map_xyxy(boxes_xyxy: Tensor, fx, fy) -> Tensor:
    """(..., 4) xyxy boxes with ``fx`` applied to the x columns and ``fy`` to
    the y columns. The per-axis constants stay Python scalars: a tensor built
    from a list on a CUDA device is a blocking host-to-device copy."""
    return torch.stack([fx(boxes_xyxy[..., 0::2]), fy(boxes_xyxy[..., 1::2])], -1).flatten(-2)


def scale_boxes_to_frame(boxes_xyxy: Tensor, spec: LetterboxSpec) -> Tensor:
    """xyxy boxes in letterboxed model-input px -> source-frame px, clipped."""
    return map_xyxy(
        boxes_xyxy,
        lambda x: torch.clamp((x - spec.pad_left) / spec.scale, 0.0, spec.src_w),
        lambda y: torch.clamp((y - spec.pad_top) / spec.scale, 0.0, spec.src_h))


def preprocess_frames(frames_bgr_u8: Tensor, target: int | tuple[int, int],
                      dtype=torch.float32) -> tuple[Tensor, LetterboxSpec]:
    """uint8 BGR (B, H, W, 3) -> normalized RGB letterboxed (B, T, T, 3) on the
    square canvas (:func:`letterbox_spec`) through :func:`letterbox_u8`, and
    the spec that maps detections back to the frame."""
    spec = letterbox_spec(frames_bgr_u8.shape[1], frames_bgr_u8.shape[2], target)
    return letterbox_u8(frames_bgr_u8, spec, dtype), spec


def frame_points_to_input(points_xy: Tensor, spec: LetterboxSpec) -> Tensor:
    """(..., 2) source-frame pixel coords -> letterboxed model-input coords,
    ``p * scale + pad`` per axis with Python scalars (as :func:`map_xyxy`)."""
    return torch.stack([points_xy[..., 0] * spec.scale + spec.pad_left,
                        points_xy[..., 1] * spec.scale + spec.pad_top], -1)
