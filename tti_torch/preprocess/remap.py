"""Undistortion sampling maps and the gather remap (port of
``tti.preprocess.remap``).

The map is a function of the calibration only and is computed once at the
letterboxed model-input resolution: the grid in numpy float64, the
distortion model in float32, as the reference evaluates it, so that both
packages sample at the same positions bit for bit. The runtime's
default is the two-pass warp (``warp2pass.TwoPassWarp``); ``PackedRemap`` is
the gather it falls back to when the vertical map is not monotonic, or on
request. The reference's ``TTI_REMAP_SKIP_PAD_ROWS`` and ``TTI_REMAP_SWAR``
are fixed at their defaults (pad rows are skipped, the bilinear blend is
the SWAR integer one), and so is ``TTI_REMAP_U8_DECIMATE``, on here: at an
exact decimation the gather packs the decimated bytes straight from the
frames (:meth:`PackedRemap.pack_decimated_u8`), bit-identical to the float
resize it skips.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tti_torch.calib.geometry import distort_points
from tti_torch.preprocess.letterbox import (
    PAD_VALUE, LetterboxSpec, bgr_to_rgb, decimation_stride, letterbox_content, letterbox_u8,
    normalize,
)

Tensor = torch.Tensor


def build_undistort_letterbox_map(K: np.ndarray, dist: np.ndarray,
                                  spec: LetterboxSpec) -> np.ndarray:
    """Sampling map (dst_h, dst_w, 2) of float32 (x, y) source coordinates
    for an undistorted view framed like cv2.undistort's default (same K);
    destination pixels outside the letterbox content get -1e6."""
    ys, xs = np.meshgrid(np.arange(spec.dst_h, dtype=np.float64),
                         np.arange(spec.dst_w, dtype=np.float64), indexing="ij")
    u = (xs - spec.pad_left + 0.5) / spec.scale - 0.5
    v = (ys - spec.pad_top + 0.5) / spec.scale - 0.5
    xy = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]], axis=-1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(torch.float32)
    src = distort_points(f32(xy), f32(K), f32(dist)).numpy()
    content = ((xs >= spec.pad_left) & (xs < spec.pad_left + spec.new_w)
               & (ys >= spec.pad_top) & (ys < spec.pad_top + spec.new_h))
    return np.where(content[..., None], src, -1e6).astype(np.float32)


def scaled_intrinsics(K: np.ndarray, spec: LetterboxSpec) -> np.ndarray:
    """Camera matrix in letterboxed-image pixel coordinates."""
    Ks = np.asarray(K, np.float64).copy()
    s = spec.scale
    Ks[0, 0] *= s
    Ks[1, 1] *= s
    Ks[0, 1] *= s
    Ks[0, 2] = (Ks[0, 2] + 0.5) * s - 0.5 + spec.pad_left
    Ks[1, 2] = (Ks[1, 2] + 0.5) * s - 0.5 + spec.pad_top
    return Ks


def build_small_undistort_map(K: np.ndarray, dist: np.ndarray, spec: LetterboxSpec,
                              unpadded_src: bool = False) -> np.ndarray:
    """Sampling map for undistorting the letterboxed image in place.
    ``unpadded_src``: source coordinates relative to the unpadded content
    (what :func:`letterbox_content` returns); sentinel entries stay."""
    ident = LetterboxSpec(src_h=spec.dst_h, src_w=spec.dst_w, dst_h=spec.dst_h,
                          dst_w=spec.dst_w, scale=1.0, new_h=spec.dst_h,
                          new_w=spec.dst_w, pad_top=0, pad_left=0)
    m = build_undistort_letterbox_map(scaled_intrinsics(K, spec), dist, ident)
    if unpadded_src:
        live = m > -1e5
        m = np.where(live, m - np.array([spec.pad_left, spec.pad_top], np.float32), m)
    return m


def remap_bilinear(frames: Tensor, map_xy: Tensor | np.ndarray,
                   pad_value: float = PAD_VALUE / 255.0) -> Tensor:
    """Bilinear remap: (B, H, W, C) frames sampled at map_xy (dh, dw, 2).
    Out-of-bounds taps read ``pad_value``. Four flat gathers and a lerp; the
    semantics ``PackedRemap`` shares."""
    b, h, w, c = frames.shape
    dtype = frames.dtype if frames.is_floating_point() else torch.float32
    frames = frames.to(dtype)
    map_xy = torch.as_tensor(map_xy, device=frames.device)
    dh, dw = map_xy.shape[:2]
    mx, my = map_xy[..., 0], map_xy[..., 1]
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx = (mx - x0).to(dtype)[..., None]
    fy = (my - y0).to(dtype)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = frames.reshape(b, h * w, c)
    pad = torch.tensor(pad_value, dtype=dtype)

    def tap(yi: Tensor, xi: Tensor) -> Tensor:
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)
        vals = torch.index_select(flat, 1, idx).reshape(b, dh, dw, c)
        return torch.where(inb[..., None], vals, pad)

    top = tap(y0i, x0i) * (1.0 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1.0 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1.0 - fy) + bot * fy


def undistort_letterbox_frames(frames_bgr_u8: Tensor, map_xy: Tensor | np.ndarray,
                               dtype: torch.dtype = torch.float32) -> Tensor:
    """uint8 BGR frames -> normalized RGB undistorted letterboxed frames in
    one remap pass over the full-resolution operand (``map_xy`` from
    :func:`build_undistort_letterbox_map`)."""
    return remap_bilinear(frames_bgr_u8.flip(-1).to(dtype) / 255.0, map_xy)


class PackedRemap:
    """Precomputed remap over RGB packed into one 24-bit word per pixel, so
    the bilinear gather fetches 4 words instead of 12 channel elements.
    Out-of-bounds taps go to a dedicated pad word, as ``remap_bilinear``'s
    border; packing quantizes to 8 bits. Words are int32 (PyTorch has no
    general uint32 arithmetic; 24 bits fit); the blend runs in int64, where
    the reference's uint32 field products cannot overflow."""

    def __init__(self, map_xy: np.ndarray, src_hw: tuple[int, int],
                 pad_value: float = PAD_VALUE / 255.0, interp: str = "bilinear",
                 device: str | torch.device = "cuda") -> None:
        if interp not in ("bilinear", "nearest"):
            raise ValueError(f"interp must be bilinear|nearest, got {interp!r}")
        self.interp = interp
        device = torch.device(device)
        h, w = src_hw
        mx = np.asarray(map_xy[..., 0], np.float64)
        my = np.asarray(map_xy[..., 1], np.float64)

        # Letterbox pad rows map entirely out of bounds: they are not
        # gathered, static pad rows are attached instead.
        row_live = ~np.all((mx < -1) | (my < -1) | (mx >= w + 1) | (my >= h + 1), axis=1)
        live = np.nonzero(row_live)[0]
        self.row_start = int(live.min()) if live.size else 0
        self.row_stop = int(live.max()) + 1 if live.size else 0
        mx = mx[self.row_start:self.row_stop]
        my = my[self.row_start:self.row_stop]

        x0, y0 = np.floor(mx), np.floor(my)
        # 8-bit lerp weights of the integer blend: they move the effective
        # sample position by under 1/256 px.
        q8 = lambda f: torch.from_numpy(np.round(f * 256.0).astype(np.int64).reshape(1, -1)).to(device)
        self.wx8, self.wy8 = q8(mx - x0), q8(my - y0)
        pad_idx = h * w  # one past the end: the pad word

        def tap(yi: np.ndarray, xi: np.ndarray) -> Tensor:
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            flat = np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)
            return torch.from_numpy(np.where(inb, flat, pad_idx).astype(np.int64).reshape(-1)).to(device)

        if interp == "nearest":
            self.idx = (tap(np.round(my), np.round(mx)),)
        else:
            self.idx = tuple(tap(y0 + dy, x0 + dx) for dy in (0, 1) for dx in (0, 1))
        self.pad_value = pad_value
        pad_u8 = int(round(pad_value * 255.0))
        self.pad_word = pad_u8 | (pad_u8 << 8) | (pad_u8 << 16)
        self.src_hw = (h, w)
        self.dst_hw = tuple(map_xy.shape[:2])
        self.live_hw = (self.row_stop - self.row_start, map_xy.shape[1])

    def rows(self, r0: int, r1: int) -> "PackedRemap":
        """The same gather for output rows [r0, r1) only (a space mesh's
        slab): the index maps and weights of those rows, the pad rows
        around them; the source stays the whole packed frame."""
        out = copy.copy(self)
        a, b = max(r0, self.row_start), min(r1, self.row_stop)
        b = max(a, b)
        w = self.dst_hw[1]
        live = slice((a - self.row_start) * w, (b - self.row_start) * w)
        out.idx = tuple(i[live] for i in self.idx)
        out.wx8, out.wy8 = self.wx8[:, live], self.wy8[:, live]
        out.row_start, out.row_stop = a - r0, b - r0
        out.dst_hw = (r1 - r0, w)
        out.live_hw = (b - a, w)
        return out

    def __call__(self, x: Tensor) -> Tensor:
        """(B, H, W, 3) float [0,1] -> (B, dst_h, dst_w, 3), same dtype."""
        h, w = self.src_hw
        # Quantize through float32: bfloat16 cannot hold the x.5 rounding
        # offsets above 128.
        u8 = torch.clamp(x.float() * 255.0 + 0.5, 0, 255).to(torch.int32)
        packed = u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)
        return self.apply_packed(packed.reshape(x.shape[0], h * w), x.dtype)

    def pack_decimated_u8(self, frames_bgr_u8: Tensor, row0: int, col0: int, k: int) -> Tensor:
        """Pack straight from uint8 BGR frames with a k-stride decimation:
        word [y, x] = pixel (row0 + k*y, col0 + k*x) in RGB byte order.
        Equal to ``letterbox_content`` + ``__call__``'s quantize when the
        resize is an exact decimation."""
        h, w = self.src_hw
        sub = frames_bgr_u8[:, row0::k, col0::k, :][:, :h, :w, :].to(torch.int32)
        packed = sub[..., 2] | (sub[..., 1] << 8) | (sub[..., 0] << 16)
        return packed.reshape(frames_bgr_u8.shape[0], h * w)

    def apply_packed(self, packed: Tensor, out_dtype: torch.dtype) -> Tensor:
        """(B, src_h*src_w) packed int32 words -> (B, dst_h, dst_w, 3)."""
        b = packed.shape[0]
        flat = torch.cat([packed, packed.new_full((b, 1), self.pad_word)], dim=1)
        # One shared index vector for the whole batch.
        take = lambda i: torch.index_select(flat, 1, self.idx[i]).to(torch.int64)

        if self.interp == "nearest":
            words = take(0)
        else:
            # SWAR bilinear: lerp the packed words in two 16-bit-spaced
            # fields (R|B in bytes 0 and 2, G in byte 1) with 8-bit weights
            # and round-to-nearest; a field product is at most 0xFF * 256 +
            # 0x80 < 0x10000, so no field carries into the next.
            def lerp(v0: Tensor, v1: Tensor, wq: Tensor) -> Tensor:
                rb = ((v0 & 0x00FF00FF) * (256 - wq) + (v1 & 0x00FF00FF) * wq + 0x00800080) >> 8
                g = ((v0 & 0x0000FF00) * (256 - wq) + (v1 & 0x0000FF00) * wq + 0x00008000) >> 8
                return (rb & 0x00FF00FF) | (g & 0x0000FF00)

            words = lerp(lerp(take(0), take(1), self.wx8), lerp(take(2), take(3), self.wx8),
                         self.wy8)
        v = words.reshape(b, *self.live_hw)
        live = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=-1).to(out_dtype) / 255.0
        return torch.nn.functional.pad(
            live, (0, 0, 0, 0, self.row_start, self.dst_hw[0] - self.row_stop),
            value=self.pad_value)


def letterbox_then_undistort(frames_bgr_u8: Tensor, spec: LetterboxSpec, small_remap,
                             dtype: torch.dtype = torch.float32) -> Tensor:
    """Two-stage preprocess: flip + normalize + letterbox (with the exact
    decimation), then the small-operand undistort: a ``TwoPassWarp`` (a
    column-expanded one takes row-sliced full-width frames and resamples the
    columns in pass 1), a ``PackedRemap`` (over the unpadded content when it
    was built with ``unpadded_src=True``), or a raw map array through
    :func:`remap_bilinear`. At an exact integer decimation the
    ``PackedRemap`` packs the decimated bytes straight from the frames, with
    no float resize (bit-identical)."""
    from tti_torch.preprocess.warp2pass import TwoPassWarp

    if isinstance(small_remap, TwoPassWarp):
        y0, y1 = small_remap.src_rows  # the whole content, or a slab's band
        if small_remap.col_expand is not None:
            k, off, _ = small_remap.col_expand
            rows = frames_bgr_u8[:, off + k * y0::k, :, :][:, :y1 - y0]
            return small_remap(normalize(bgr_to_rgb(rows), dtype))
        return small_remap(letterbox_content(frames_bgr_u8, spec, dtype, decimate=True,
                                             rows=(y0, y1)))
    if isinstance(small_remap, PackedRemap):
        if small_remap.src_hw == (spec.new_h, spec.new_w):
            k = decimation_stride(spec)
            if k is not None:
                off = (k - 1) // 2
                return small_remap.apply_packed(
                    small_remap.pack_decimated_u8(frames_bgr_u8, off, off, k), dtype)
            return small_remap(letterbox_content(frames_bgr_u8, spec, dtype))
        return small_remap(letterbox_u8(frames_bgr_u8, spec, dtype))
    return remap_bilinear(letterbox_u8(frames_bgr_u8, spec, dtype), small_remap)
