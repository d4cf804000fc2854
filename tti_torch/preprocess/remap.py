"""Undistortion sampling maps (port of the map construction in ``tti.preprocess.remap``).

The map is a function of the calibration only and is computed once, in
numpy float64, at the letterboxed model-input resolution. The gather-based
``PackedRemap`` is not ported yet; the runtime uses the two-pass warp.
"""

from __future__ import annotations

import numpy as np
import torch

from tti_torch.calib.geometry import distort_points
from tti_torch.preprocess.letterbox import LetterboxSpec


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
    src = distort_points(torch.from_numpy(xy), torch.as_tensor(np.asarray(K, np.float64)),
                         torch.as_tensor(np.asarray(dist, np.float64))).numpy()
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
