"""Seeded camera-domain textile scenes (the deploy traffic): a fabric band
with a wavy sewn edge and a row of stitches on the fabric plane, rendered
through the deployment's lens and pose at the sensor's 960x1280.

A frozen copy, at commit bb8100e, of ``make_camera_scene`` and
``_weave_plane`` in ``tools/synth_textile_torch.py`` (the scenes the deploy
checkpoint was trained on) and of ``PlaneMapper`` with its float64
geometry in ``tools/measure_report_torch.py``. OpenCV's three drawing calls
are replaced by numpy and scipy equivalents (:func:`_disc`, :func:`_line`,
``scipy.ndimage.gaussian_filter`` with mirrored borders), so the scenes
differ from the original's in those pixels and need no OpenCV.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

# Deployment camera (reference camera_calibration.json + extrinsics.json).
REF_K = np.array(
    [[937.1384518987244, 0.0, 636.148901113533],
     [0.0, 884.022038878419, 422.3901781816556],
     [0.0, 0.0, 1.0]], np.float64)
REF_DIST = np.array([0.07994929130530135, 0.04758675999900327,
                     -0.04013555042332606, -0.005228657034776396,
                     -0.1334157094005971], np.float64)
REF_RVEC = np.array([-0.8631369244225452, -0.3919482615538663,
                     -1.3591256137314185], np.float64)
REF_TVEC = np.array([0.005016396186926285, 0.03590342712705542,
                     0.09382141278570659], np.float64)
FRAME_HW = (960, 1280)


def rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    rvec = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(theta) * np.eye(3)
            + (1 - np.cos(theta)) * np.outer(k, k) + np.sin(theta) * Kx)


def undistort_np(uv: np.ndarray, K: np.ndarray, dist: np.ndarray,
                 iters: int = 60) -> np.ndarray:
    """Distorted pixels (...,2) -> ideal normalized coords; converged inverse
    (the truth model — the production path's 5-iteration cv2 parity is part of
    the error budget being measured)."""
    k1, k2, p1, p2, k3 = dist
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u0 = (uv[..., 0] - cx) / fx
    v0 = (uv[..., 1] - cy) / fy
    x, y = u0.copy(), v0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icd = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (u0 - dx) * icd
        y = (v0 - dy) * icd
    return np.stack([x, y], -1)


def pixel_to_plane_mm_np(uv: np.ndarray, K: np.ndarray, dist: np.ndarray,
                         R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Pixels (...,2) -> world plane coords in mm (...,2) (board frame, z=0)."""
    xy = undistort_np(np.asarray(uv, np.float64), K, dist)
    ray = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
    n_c = R[:, 2]
    d_c = -float(n_c @ t)
    s = -d_c / (ray @ n_c)
    Xc = s[..., None] * ray
    Xw = (Xc - t) @ R  # R^T (Xc - t) row-wise
    return Xw[..., :2] * 1000.0


def project_np(world_mm_xy: np.ndarray, K: np.ndarray, dist: np.ndarray,
               R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World plane points (...,2) in mm -> distorted pixel coords (...,2)."""
    w = np.concatenate([world_mm_xy / 1000.0,
                        np.zeros_like(world_mm_xy[..., :1])], -1)
    Xc = w @ R.T + t
    x, y = Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2]
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


class PlaneMapper:
    """Per-calibration pixel<->plane machinery shared by all scenes."""

    def __init__(self, K=REF_K, dist=REF_DIST, rvec=REF_RVEC, tvec=REF_TVEC,
                 frame_hw=FRAME_HW):
        self.K, self.dist = K, dist
        self.R, self.t = rodrigues_np(rvec), np.asarray(tvec, np.float64)
        self.h, self.w = frame_hw
        ys, xs = np.mgrid[0:self.h, 0:self.w].astype(np.float64)
        uv = np.stack([xs, ys], -1).reshape(-1, 2)
        self.plane_mm = pixel_to_plane_mm_np(
            uv, K, dist, self.R, self.t).reshape(self.h, self.w, 2)

    def to_plane(self, uv: np.ndarray) -> np.ndarray:
        return pixel_to_plane_mm_np(np.asarray(uv, np.float64), self.K,
                                    self.dist, self.R, self.t)

    def to_pixel(self, world_mm: np.ndarray) -> np.ndarray:
        return project_np(np.asarray(world_mm, np.float64), self.K, self.dist,
                          self.R, self.t)


def _weave_plane(sr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """This module's weave family over plane-mm coords (thread axes randomly
    rotated relative to the seam — unlike the eval generator's seam-aligned
    weave), plus low-frequency cloth waviness and grain noise."""
    th = rng.uniform(0, np.pi)
    c, s = np.cos(th), np.sin(th)
    a = sr[..., 0] * c - sr[..., 1] * s
    b = sr[..., 0] * s + sr[..., 1] * c
    pitch = rng.uniform(0.3, 0.8)  # thread pitch in mm
    p1, p2 = rng.uniform(0, 6.28, 2)
    warp = np.sin(a * (2 * np.pi / pitch) + p1)
    weft = np.sin(b * (2 * np.pi / pitch) + p2)
    tex = 0.5 + 0.08 * warp + 0.08 * weft + 0.06 * warp * weft
    tex += 0.05 * np.sin(a / rng.uniform(3.5, 9) + np.sin(b / rng.uniform(2.5, 6)))
    tex += rng.normal(0, 0.02, size=tex.shape)
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


def make_camera_scene(mapper, rng: np.random.Generator, return_masks: bool = False):
    """One deployment-geometry scene -> (bgr uint8 (H,W,3), polys, classes).

    Polygons are in DISTORTED PIXEL coordinates of the (H,W) frame (callers
    normalize after any padding). Labels are exact projections of the same
    plane-space predicates the renderer evaluates per pixel (return_masks=True
    also returns those per-pixel masks, for label-consistency tests)."""
    h, w = mapper.h, mapper.w

    # Seam frame (origin mid-row pixel, u ~ image-horizontal on the plane,
    # v = in-plane perpendicular, +v image-down).
    yc = rng.uniform(380.0, 760.0) * (h / 960.0)
    p0 = mapper.to_plane(np.array([w / 2, yc]))
    pa = mapper.to_plane(np.array([w * 0.25, yc]))
    pb = mapper.to_plane(np.array([w * 0.75, yc]))
    u = (pb - pa) / np.linalg.norm(pb - pa)
    ang = np.deg2rad(rng.uniform(-10, 10))
    c, s_ = np.cos(ang), np.sin(ang)
    u = np.array([c * u[0] - s_ * u[1], s_ * u[0] + c * u[1]])
    v = np.array([-u[1], u[0]])
    if (mapper.to_plane(np.array([w / 2, yc + 50.0])) - p0) @ v < 0:
        v = -v

    sr = np.stack([(mapper.plane_mm - p0) @ u,
                   (mapper.plane_mm - p0) @ v], -1).astype(np.float32)
    s_px, r_px = sr[..., 0], sr[..., 1]
    row = s_px[min(max(int(yc), 0), h - 1)]
    s_lo = float(np.percentile(row, 8))
    s_hi = float(np.percentile(row, 92))
    # Fabric label extent: just past the frame edges AT THE SEAM ROW. Points
    # projected far outside the calibrated image hit the distortion
    # polynomial's extrapolation regime and can fold the polygon.
    s_min = float(row.min()) - 3.0
    s_max = float(row.max()) + 3.0

    # Geometry randomization (mm) — superset of the eval scenes' ranges.
    W_mm = rng.uniform(2.4, 4.6)
    H_mm = rng.uniform(0.8, 2.4)
    pitch = rng.uniform(1.25, 2.3) * W_mm
    D_edge = rng.uniform(3.0, 9.0)
    t0 = rng.uniform(0.4, 1.6)
    amp = rng.uniform(0.15, 1.0)
    lam = rng.uniform(12.0, 60.0)
    phase = rng.uniform(0, 2 * np.pi)

    def r_top(sv):
        return -t0 + amp * np.sin(2 * np.pi * sv / lam + phase)

    # Stitch slots along the seam.
    r_bias = rng.uniform(0.1, 0.9)
    n_slots = int((s_hi - s_lo - 2 * W_mm) // pitch)
    n_slots = max(3, min(n_slots, 12))
    start = -0.5 * (n_slots - 1) * pitch + rng.uniform(-0.5, 0.5) * pitch
    stitches = []  # (sk, rk, theta, Wk, Hk)
    for k in range(n_slots):
        if rng.uniform() < 0.12:
            continue
        sk = start + k * pitch + rng.normal(0, 0.3)
        rk = r_bias + 0.6 * (r_top(sk) + t0) + rng.normal(0, 0.3)
        stitches.append((sk, rk, np.deg2rad(rng.uniform(-10, 10)),
                         W_mm * rng.uniform(0.92, 1.08),
                         H_mm * rng.uniform(0.85, 1.15)))
    if len(stitches) < 3:
        stitches = [(start + i * pitch, r_bias, 0.0, W_mm, H_mm)
                    for i in range(3)]

    # ---- render (plane-space predicates evaluated per pixel) -------------
    img = np.zeros((h, w, 3), np.float32)
    base = rng.uniform(0.06, 0.22)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = base * (1 + 0.5 * (rng.uniform(-1, 1) * xx / w
                              + rng.uniform(-1, 1) * yy / h))
    img[:] = grad[..., None] * np.array(rng.uniform(0.8, 1.2, 3), np.float32)
    for _ in range(rng.integers(0, 4)):  # unlabeled plane-space clutter rects
        cs = rng.uniform(s_min, s_max)
        cr = rng.uniform(-40, 40)
        hs, hr = rng.uniform(5, 40, 2)
        m = ((np.abs(s_px - cs) <= hs) & (np.abs(r_px - cr) <= hr)
             ).astype(np.float32)[..., None]
        img += m * rng.uniform(-0.05, 0.12)

    fabric = (r_px >= r_top(s_px)) & (r_px <= D_edge)
    tint = np.array([rng.uniform(0.55, 0.95) for _ in range(3)], np.float32)
    tint = tint / tint.max() * rng.uniform(0.6, 0.95)
    tex = _weave_plane(sr, rng)
    fm = fabric.astype(np.float32)[..., None]
    img = img * (1 - fm) + fm * (tex[..., None] * tint)

    stitch_col = np.array(rng.uniform(0.05, 0.25, 3), np.float32)
    polys, classes, masks = [], [], [fabric]

    # Fabric polygon label: wavy top polyline + straight cut edge, projected.
    s_line = np.linspace(s_min, s_max, 49)
    top_pts = np.stack([s_line, r_top(s_line)], -1)
    # The straight cut edge is straight ON THE PLANE; through the lens it is a
    # curve — densify it like the wavy edge or the polygon undercuts the band.
    bot_pts = np.stack([s_line[::-1], np.full(49, D_edge)], -1)
    plane_poly = np.concatenate([top_pts, bot_pts])
    world = p0[None, :] + plane_poly[:, :1] * u[None, :] + plane_poly[:, 1:] * v[None, :]
    polys.append(np.asarray(mapper.to_pixel(world), np.float32))
    classes.append(1)

    for sk, rk, th, Wk, Hk in stitches:
        ds, dr = s_px - sk, r_px - rk
        ls = ds * np.cos(th) + dr * np.sin(th)
        lr = -ds * np.sin(th) + dr * np.cos(th)
        m = (np.abs(ls) <= Wk / 2) & (np.abs(lr) <= Hk / 2)
        masks.append(m)
        sm = m.astype(np.float32)[..., None]
        img = img * (1 - sm) + sm * (stitch_col * rng.uniform(0.8, 1.2))
        # Quad corners in the stitch's local frame -> plane -> pixels
        # (3 points per side absorbs lens curvature, negligible at this size).
        tq = np.linspace(0, 1, 3)[:-1]
        cor = np.array([[-Wk / 2, -Hk / 2], [Wk / 2, -Hk / 2],
                        [Wk / 2, Hk / 2], [-Wk / 2, Hk / 2]])
        edge_pts = np.concatenate([
            cor[i] + (cor[(i + 1) % 4] - cor[i]) * tq[:, None]
            for i in range(4)])
        ct, st = np.cos(th), np.sin(th)
        loc = np.stack([edge_pts[:, 0] * ct - edge_pts[:, 1] * st + sk,
                        edge_pts[:, 0] * st + edge_pts[:, 1] * ct + rk], -1)
        world = p0[None, :] + loc[:, :1] * u[None, :] + loc[:, 1:] * v[None, :]
        polys.append(np.asarray(mapper.to_pixel(world), np.float32))
        classes.append(0)

    # Unlabeled pixel-space distractors + photometric chain (this module's
    # family: blur may be absent entirely, unlike the eval scenes).
    for _ in range(rng.integers(0, 6)):
        x0, y0 = int(rng.integers(2, w - 2)), int(rng.integers(2, h - 2))
        _disc(img, x0, y0, int(rng.integers(1, 3)), rng.uniform(0.05, 0.5, 3))
    for _ in range(rng.integers(0, 3)):
        pA = rng.integers(0, [w, h])
        pB = np.clip(pA + rng.integers(-w // 4, w // 4, 2), 0, [w - 1, h - 1])
        _line(img, pA, pB, rng.uniform(0.3, 0.7, 3))
    r2 = (((xx / w) - 0.5) ** 2 + ((yy / h) - 0.5) ** 2) * rng.uniform(0.0, 1.2)
    img *= (1.0 - r2)[..., None]
    sigma = rng.uniform(0.0, 1.3)
    if sigma > 0.2:
        img = gaussian_filter(img, (sigma, sigma, 0), mode="mirror").astype(np.float32)
    img += rng.normal(0, rng.uniform(0.004, 0.02), size=img.shape).astype(np.float32)
    bgr = np.clip(img[..., ::-1] * 255, 0, 255).astype(np.uint8)
    if return_masks:
        return bgr, polys, classes, masks
    return bgr, polys, classes


def _disc(img: np.ndarray, x0: int, y0: int, r: int, color) -> None:
    """A filled disc of radius ``r`` (``cv2.circle`` with thickness -1)."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[max(y0 - r, 0):min(y0 + r + 1, h), max(x0 - r, 0):min(x0 + r + 1, w)]
    m = (xs - x0) ** 2 + (ys - y0) ** 2 <= r * r
    img[ys[m], xs[m]] = np.asarray(color, np.float32)


def _line(img: np.ndarray, pa, pb, color) -> None:
    """A one-pixel line from ``pa`` to ``pb`` (x, y)."""
    n = int(max(abs(int(pb[0]) - int(pa[0])), abs(int(pb[1]) - int(pa[1])))) + 1
    xs = np.rint(np.linspace(pa[0], pb[0], n)).astype(np.int64)
    ys = np.rint(np.linspace(pa[1], pb[1], n)).astype(np.int64)
    img[ys, xs] = np.asarray(color, np.float32)


def maker(frame_hw: tuple[int, int]):
    """The deployment camera's scene function: ``seed -> (H, W, 3)`` uint8
    BGR frame, one scene per seed. A frame size that divides the sensor's by
    an integer k takes every k-th pixel of the sensor's scene."""
    k = FRAME_HW[0] // frame_hw[0]
    if k < 1 or (frame_hw[0] * k, frame_hw[1] * k) != FRAME_HW:
        raise ValueError(f"camera scenes are rendered at {FRAME_HW} or an integer part of it, "
                         f"not {tuple(frame_hw)}")
    mapper = PlaneMapper()
    return lambda seed: np.ascontiguousarray(
        make_camera_scene(mapper, np.random.default_rng(seed))[0][::k, ::k])
