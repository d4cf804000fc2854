"""Millimetre-accuracy report of the port (``tti_torch``) against analytic truth.

The product exists to emit {edge_distance_mm, stitch_width_mm} (reference:
measurement.py:506-511), gated on validity windows (seam 3.5-8.0 mm, stitch
width 2.8-4.15 mm; reference config.py:147-150). This tool measures those
quantities through the port's deploy step on scenes whose truth is known
analytically. It keeps its own copy of the scene oracle of
``tools/measure_report.py`` (the float64 geometry, the scene renderer, the
truth and the error statistics, with cv2 inside the renderer), so it imports
nothing of ``tti`` and no jax:

1. Scenes are built on the fabric plane in world millimetres and rendered
   through the deployment's real camera (intrinsics + extrinsics), so every
   stitch's protocol-exact seam allowance and width are known (f64).
2. The port's deploy step (``tti_torch.parallel.runtime.InspectionPipeline``:
   the checkpoint's sidecar architecture and sub-cell readout, kernels A and
   D on a CUDA device) runs over the frames at 1280x960, imgsz 960, the
   deployment ROI, in the reference's four configurations: reference-native
   (point undistortion, ``undistort=False``) and rectified (the two-pass
   undistort warp ahead of the model, ``undistort=True``, and no point
   undistortion after it: frames are undistorted once), each in float32 and
   bfloat16; ``--paths`` and ``--dtype`` select among them. Per-frame
   raw_edge_mm/raw_width_mm are compared with the frame's truth.
3. ``--smoothing N`` also renders N temporal variants of each of
   ``--smoothed-scenes`` scenes (same geometry, fresh appearance) and feeds
   each scene's N raw readings in order through the production ring
   (``tti_torch.measure.pipeline.smooth_measurement``); the smoothed reading
   is what the ring emits at the N-th frame.

Usage (the card by default; ``--device cpu`` on the host):
  python tools/measure_report_torch.py \
      --weights checkpoints/yolov8n_textile_cam.msgpack --scenes 256 --smoothing 8

It writes the MEASURE_REPORT table layout to ``--out`` (default
``build/MEASURE_REPORT_torch.md``) and per-frame readings beside it (.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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


# ---------------------------------------------------------------------------
# float64 oracle geometry (numpy; independent of the port's device path)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Scene construction on the plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SceneTruth:
    """Analytic truth for one rendered scene (all lengths mm)."""

    n_stitches: int
    width_protocol: np.ndarray   # per-stitch protocol-exact width
    width_nominal: np.ndarray    # rect extent along the seam (W_mm)
    edge_protocol: np.ndarray    # per-stitch protocol-exact seam allowance
    edge_perp: np.ndarray        # perpendicular centroid->edge distance
    frame_width: float           # mean over stitches (the pipeline's STEP 4)
    frame_edge: float


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


def _weave(sr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Woven-cloth luminance in [0,1] over (s, r) millimetre coordinates."""
    s, r = sr[..., 0], sr[..., 1]
    pitch = rng.uniform(0.35, 0.7)  # thread pitch in mm
    p1, p2 = rng.uniform(0, 2 * np.pi, 2)
    warp = np.sin(s * (2 * np.pi / pitch) + p1)
    weft = np.sin(r * (2 * np.pi / pitch) + p2)
    tex = 0.5 + 0.08 * warp + 0.08 * weft + 0.06 * warp * weft
    tex += 0.05 * np.sin(s / rng.uniform(4, 9) + np.sin(r / rng.uniform(2.5, 6)))
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


def make_measure_scene(mapper: PlaneMapper, rng: np.random.Generator,
                       jpeg_quality: int = 88,
                       rng_app: np.random.Generator | None = None):
    """One deployment-shaped scene -> (bgr uint8 frame, SceneTruth).

    Layout in plane coordinates (s along the seam, r across it, +r = image
    down): fabric strip from a wavy sewn edge near r=0 down to the straight
    free cut edge at r=D; stitch rectangles centred slightly below the sewn
    edge (as in training scenes: the dark mark is visible against fabric).
    True seam allowance per stitch = centroid -> cut edge.

    ``rng_app`` (optional) supplies every APPEARANCE draw (texture, lighting,
    noise, blur, specks) while ``rng`` keeps supplying geometry: rendering the
    same geometry rng with T different appearance rngs yields T temporal
    variants of one physical scene — the smoothed-accuracy mode's input.
    Default (None) draws appearance from ``rng`` itself, the original stream.
    """
    import cv2

    ra = rng if rng_app is None else rng_app

    h, w = mapper.h, mapper.w
    # Seam frame: origin at a mid-frame pixel, u along the (slightly rotated)
    # image-horizontal direction mapped to the plane, v = in-plane perp with
    # +v pointing image-down. The row sits in the lower half of the
    # deployment ROI (reference config.py:91-95: y in [300, 760]) where the
    # plane is closest to this oblique camera (~0.10-0.16 mm/px — a 3.5 mm
    # stitch is 25-35 px, matching the training distribution).
    yc = rng.uniform(550.0, 700.0) * (h / 960.0)
    p0 = mapper.to_plane(np.array([w / 2, yc]))
    pa = mapper.to_plane(np.array([w * 0.25, yc]))
    pb = mapper.to_plane(np.array([w * 0.75, yc]))
    u = (pb - pa) / np.linalg.norm(pb - pa)
    ang = np.deg2rad(rng.uniform(-4, 4))
    c, s_ = np.cos(ang), np.sin(ang)
    u = np.array([c * u[0] - s_ * u[1], s_ * u[0] + c * u[1]])
    v = np.array([-u[1], u[0]])
    pdown = mapper.to_plane(np.array([w / 2, yc + 50.0])) - p0
    if pdown @ v < 0:
        v = -v

    sr = np.stack([(mapper.plane_mm - p0) @ u, (mapper.plane_mm - p0) @ v], -1)
    s_px, r_px = sr[..., 0], sr[..., 1]
    s_lo = float(np.percentile(s_px[int(yc)], 8))
    s_hi = float(np.percentile(s_px[int(yc)], 92))

    # Geometry randomization (mm).
    W_mm = rng.uniform(2.8, 4.15)        # stitch length window (config.py:149-150)
    H_mm = rng.uniform(1.0, 2.0)
    pitch = rng.uniform(1.3, 2.1) * W_mm
    D_edge = rng.uniform(4.0, 8.0)       # sewn line -> cut edge
    t0 = rng.uniform(0.5, 1.5)           # sewn (wavy) edge sits t0 above r=0
    amp = rng.uniform(0.2, 0.8)
    lam = rng.uniform(15.0, 50.0)
    phase = rng.uniform(0, 2 * np.pi)

    def r_top(s):
        return -t0 + amp * np.sin(2 * np.pi * s / lam + phase)

    # Stitch row along r ~= r_bias (straddles the sewn edge, biased onto fabric).
    # A healthy run of stitches: the reference's row-selection kmeans ALWAYS
    # splits a single tight row in two and keeps only the fabric-side half
    # (measurement.py:392-405 — k=2 with min/max init never merges), so a
    # frame needs ~2*MIN_STITCHES detections for a seam-allowance value to
    # survive. Deployment frames have continuous seams; mirror that.
    r_bias = rng.uniform(0.2, 0.8)
    n_slots = int((s_hi - s_lo - 2 * W_mm) // pitch)
    n_slots = min(n_slots, 12)
    # Centre the stitch run on the frame (the seam sits under the needle in
    # deployment; also keeps every stitch inside the ROI's x-range).
    start = -0.5 * (n_slots - 1) * pitch + rng.uniform(-0.5, 0.5) * pitch
    centers, thetas, sizes = [], [], []
    for k in range(n_slots):
        if rng.uniform() < 0.06:
            continue  # missing stitch
        sk = start + k * pitch + rng.normal(0, 0.25)
        # The row follows the wavy sewn edge (stitches track the seam, not a
        # straight line): realistic cross-seam spread, and it keeps the
        # reference's min/max-init kmeans from carving a singleton
        # "fabric-side" cluster out of an unnaturally tight row.
        rk = r_bias + 0.6 * (r_top(sk) + t0) + rng.normal(0, 0.25)
        centers.append((sk, rk))
        thetas.append(np.deg2rad(rng.uniform(-8, 8)))
        sizes.append((W_mm * rng.uniform(0.95, 1.05), H_mm * rng.uniform(0.9, 1.1)))
    if len(centers) < 3:  # MIN_STITCHES (reference config.py:79)
        centers = [(start + i * pitch, r_bias) for i in range(3)]
        thetas = [0.0] * 3
        sizes = [(W_mm, H_mm)] * 3

    # ---- render ----------------------------------------------------------
    img = np.zeros((h, w, 3), np.float32)
    base = ra.uniform(0.06, 0.22)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = base * (1 + 0.5 * (ra.uniform(-1, 1) * xx / w + ra.uniform(-1, 1) * yy / h))
    img[:] = grad[..., None] * np.array(ra.uniform(0.8, 1.2, 3), np.float32)

    fabric = (r_px >= r_top(s_px)) & (r_px <= D_edge)
    tint = np.array([ra.uniform(0.55, 0.95) for _ in range(3)], np.float32)
    tint = tint / tint.max() * ra.uniform(0.6, 0.95)
    tex = _weave(sr, ra)
    fm = fabric.astype(np.float32)[..., None]
    img = img * (1 - fm) + fm * (tex[..., None] * tint)

    stitch_col = np.array(ra.uniform(0.05, 0.25, 3), np.float32)
    for (sk, rk), th, (Wk, Hk) in zip(centers, thetas, sizes):
        ds, dr = s_px - sk, r_px - rk
        ls = ds * np.cos(th) + dr * np.sin(th)
        lr = -ds * np.sin(th) + dr * np.cos(th)
        m = (np.abs(ls) <= Wk / 2) & (np.abs(lr) <= Hk / 2)
        shade = stitch_col * ra.uniform(0.8, 1.2)
        sm = m.astype(np.float32)[..., None]
        img = img * (1 - sm) + sm * shade[None, None, :]

    for _ in range(ra.integers(0, 6)):  # unlabeled specks / lint
        x0, y0 = int(ra.integers(2, w - 2)), int(ra.integers(2, h - 2))
        cv2.circle(img, (x0, y0), int(ra.integers(1, 4)),
                   tuple(float(c_) for c_ in ra.uniform(0.05, 0.5, 3)), -1)
    for _ in range(ra.integers(0, 3)):
        pA = ra.integers(0, [w, h])
        pB = np.clip(pA + ra.integers(-w // 6, w // 6, 2), 0, [w - 1, h - 1])
        cv2.line(img, tuple(int(c_) for c_ in pA), tuple(int(c_) for c_ in pB),
                 tuple(float(c_) for c_ in ra.uniform(0.3, 0.7, 3)), 2)

    r2 = (((xx / w) - 0.5) ** 2 + ((yy / h) - 0.5) ** 2) * ra.uniform(0.0, 1.0)
    img *= (1.0 - r2)[..., None]
    sigma = ra.uniform(0.3, 1.3)
    img = cv2.GaussianBlur(img, (0, 0), sigma)
    img += ra.normal(0, ra.uniform(0.004, 0.018), size=img.shape).astype(np.float32)
    bgr = np.clip(img[..., ::-1] * 255, 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
    assert ok
    bgr = cv2.imdecode(enc, cv2.IMREAD_COLOR)

    # ---- analytic truth (f64, protocol-exact) ----------------------------
    widths_p, widths_n, edges_p, edges_perp = [], [], [], []
    for (sk, rk), th, (Wk, Hk) in zip(centers, thetas, sizes):
        corners_sr = np.array([[-Wk / 2, -Hk / 2], [Wk / 2, -Hk / 2],
                               [Wk / 2, Hk / 2], [-Wk / 2, Hk / 2]])
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        corners_sr = corners_sr @ rot.T + np.array([sk, rk])
        corners_w = p0 + corners_sr[:, :1] * u + corners_sr[:, 1:] * v
        corners_px = mapper.to_pixel(corners_w)
        centroid_w = p0 + sk * u + rk * v
        cpx = mapper.to_pixel(centroid_w)
        cx, cy = float(cpx[0]), float(cpx[1])

        # Protocol width: plane distance between the mask's image-column
        # extremes taken at centroid height (measurement.py:339-368).
        lx, rx = float(corners_px[:, 0].min()), float(corners_px[:, 0].max())
        pl = mapper.to_plane(np.array([[lx, cy], [rx, cy]]))
        widths_p.append(float(np.linalg.norm(pl[1] - pl[0])))
        widths_n.append(Wk)

        # Protocol seam allowance: centroid -> cut-edge crossing in the same
        # image column (measurement.py:432-462), crossing found by bisection
        # on r(cx, y) = D_edge (r is monotonic in y down the column here).
        ylo, yhi = cy, cy + 300.0
        for _ in range(60):
            ym = 0.5 * (ylo + yhi)
            rm = float((mapper.to_plane(np.array([cx, ym])) - p0) @ v)
            if rm < D_edge:
                ylo = ym
            else:
                yhi = ym
        y_edge = 0.5 * (ylo + yhi)
        pe = mapper.to_plane(np.array([[cx, cy], [cx, y_edge]]))
        edges_p.append(float(np.linalg.norm(pe[1] - pe[0])))
        edges_perp.append(float(D_edge - rk))

    truth = SceneTruth(
        n_stitches=len(centers),
        width_protocol=np.array(widths_p),
        width_nominal=np.array(widths_n),
        edge_protocol=np.array(edges_p),
        edge_perp=np.array(edges_perp),
        frame_width=float(np.mean(widths_p)),
        frame_edge=float(np.mean(edges_p)),
    )
    return bgr, truth


# ---------------------------------------------------------------------------
# The port's deploy step
# ---------------------------------------------------------------------------


def build_pipeline(weights: str, *, undistort: bool, dtype: str, imgsz: int = 960,
                   device: str = "cuda", rvec: np.ndarray = REF_RVEC,
                   tvec: np.ndarray = REF_TVEC, **pipe_kw):
    """The port's inspection step as deployed: the architecture and the
    boundary readout from the checkpoint's sidecar, the deployment camera
    (extrinsics ``rvec``/``tvec``, the deployment's by default) and ROI
    (reference config.py:91-95), 1280x960 frames. ``pipe_kw``: more
    ``InspectionPipeline`` arguments (e.g. ``quant``, ``quant_scales``)."""
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    meta = checkpoint_metadata(weights)
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      image_size=imgsz, dtype=dtype, mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return InspectionPipeline(
        cfg, load_flax_msgpack(weights), FRAME_HW,
        calibration=CalibrationData(K=REF_K, dist=REF_DIST, rvec=rvec, tvec=tvec),
        measure_cfg=MeasureConfig.from_env(os.environ).with_subcell_from(meta),
        roi=RoiConfig(enabled=True, x_min=10, x_max=FRAME_HW[1] - 10,
                      y_min=300, y_max=FRAME_HW[0] - 200),
        device=device, undistort=undistort, **pipe_kw)


def run_pipeline(frames: np.ndarray, weights: str, *, undistort: bool, dtype: str,
                 imgsz: int = 960, batch: int = 16, device: str = "cuda", pipe=None):
    """The port's step over ``frames`` in batches; per-frame (raw_edge_mm,
    raw_width_mm, n_stitches) as numpy arrays. A short last batch is padded
    with black frames to keep one batch shape."""
    pipe = pipe or build_pipeline(weights, undistort=undistort, dtype=dtype, imgsz=imgsz,
                                  device=device)
    edges, widths, n_stitch = [], [], []
    for i in range(0, len(frames), batch):
        chunk = frames[i:i + batch]
        keep = len(chunk)
        if keep < batch and len(frames) > batch:
            chunk = np.concatenate([chunk, np.zeros((batch - keep, *chunk.shape[1:]),
                                                    chunk.dtype)])
        meas = pipe.process_batch(chunk).measurements
        edges.append(meas.raw_edge_mm[:keep])
        widths.append(meas.raw_width_mm[:keep])
        n_stitch.append(meas.n_stitches[:keep])
    return np.concatenate(edges), np.concatenate(widths), np.concatenate(n_stitch)


def ring_smoothed(edge: np.ndarray, width: np.ndarray, frame_buffer: int, device: str):
    """(S, T) raw readings -> (S,) edge and width: per scene, a fresh
    production ring fed the T readings in order, and what it emits at the
    T-th frame (NaN when that frame has no reading)."""
    import torch

    from tti_torch.measure.pipeline import (
        FrameMeasurement, init_measure_state, smooth_measurement,
    )

    vals = torch.as_tensor(np.stack([edge, width], -1), dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    out = np.full((edge.shape[0], 2), np.nan)
    for s in range(edge.shape[0]):
        state = init_measure_state(frame_buffer, device=device)
        for t in range(edge.shape[1]):
            e, w = vals[s, t]
            state, sm = smooth_measurement(
                state, FrameMeasurement(e, w, e, w, count, count, count, count > 0))
        out[s] = torch.stack([sm.edge_distance_mm, sm.stitch_width_mm]).cpu().numpy()
    return out[:, 0], out[:, 1]


def error_stats(measured: np.ndarray, truth: np.ndarray) -> dict:
    ok = np.isfinite(measured)
    err = np.abs(measured[ok] - truth[ok])
    signed = measured[ok] - truth[ok]
    return {
        "n": int(ok.sum()),
        "coverage": float(ok.mean()),
        "p50": float(np.percentile(err, 50)) if ok.any() else float("nan"),
        "p95": float(np.percentile(err, 95)) if ok.any() else float("nan"),
        "max": float(err.max()) if ok.any() else float("nan"),
        "bias": float(signed.mean()) if ok.any() else float("nan"),
    }


def rectified_vs_native(rows: list, per_frame: dict) -> list[str]:
    """Per dtype with both paths in ``rows``: rectified minus
    reference-native in edge and width p50, p95 and bias, and the largest
    per-frame difference where both have a value."""
    stats = {(name, dtype): (es, ws) for name, dtype, es, ws, _ in rows}
    lines = []
    for dtype in dict.fromkeys(d for _, d, *_ in rows):
        if not {("rectified", dtype), ("reference-native", dtype)} <= stats.keys():
            continue
        parts = []
        for i, what in enumerate(("edge", "width")):
            r, n = stats["rectified", dtype][i], stats["reference-native", dtype][i]
            a = np.asarray(per_frame[f"rectified/{dtype}"][f"{what}_measured"], float)
            b = np.asarray(per_frame[f"reference-native/{dtype}"][f"{what}_measured"], float)
            both = np.isfinite(a) & np.isfinite(b)
            worst = float(np.abs(a - b)[both].max()) if both.any() else float("nan")
            parts.append(f"{what} p50 {r['p50'] - n['p50']:+.4f} p95 {r['p95'] - n['p95']:+.4f} "
                         f"bias {r['bias'] - n['bias']:+.4f} (frames with a value {r['n']} "
                         f"vs {n['n']}; per frame max |rectified - native| {worst:.4f})")
        lines.append(f"rectified - reference-native, {dtype}, mm: " + "; ".join(parts))
    return lines


def card_line(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or the host's device."""
    if not device.startswith("cuda"):
        return f"device {device}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--scenes", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--imgsz", type=int, default=960)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--paths", default="",
                    help="comma list to restrict configs (reference-native,rectified) — "
                         "outlier-hunting reruns")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], action="append",
                    help="compute dtype of the step (repeatable; default both)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "MEASURE_REPORT_torch.md"))
    ap.add_argument("--smoothing", type=int, default=0,
                    help="also measure smoothed accuracy: N temporal variants per scene "
                         "through the production ring (reference FRAME_BUFFER=8)")
    ap.add_argument("--smoothed-scenes", type=int, default=48)
    args = ap.parse_args(argv)
    dtypes = args.dtype or ["float32", "bfloat16"]

    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("measure_report_torch: no CUDA device (pass --device cpu for the host)",
                  file=sys.stderr)
            return 2
        # float32 means float32: no TF32 in the convolutions or products.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = card_line(args.device)
    print(card, flush=True)

    t0 = time.time()
    mapper = PlaneMapper()
    scale = np.linalg.norm(
        mapper.plane_mm[FRAME_HW[0] // 2, FRAME_HW[1] // 2 + 10]
        - mapper.plane_mm[FRAME_HW[0] // 2, FRAME_HW[1] // 2]) / 10.0
    print(f"plane map ready ({time.time()-t0:.1f}s); centre scale {scale:.4f} mm/px", flush=True)

    rng = np.random.default_rng(args.seed)
    frames, truths = [], []
    for i in range(args.scenes):
        bgr, truth = make_measure_scene(mapper, rng)
        frames.append(bgr)
        truths.append(truth)
        if (i + 1) % 32 == 0:
            print(f"rendered {i+1}/{args.scenes} ({time.time()-t0:.0f}s)", flush=True)
    frames = np.stack(frames)
    gt_edge = np.array([t.frame_edge for t in truths])
    gt_width = np.array([t.frame_width for t in truths])
    gt_edge_perp = np.array([float(np.mean(t.edge_perp)) for t in truths])
    gt_width_nom = np.array([float(np.mean(t.width_nominal)) for t in truths])
    gt_n = np.array([t.n_stitches for t in truths])
    # The reference's deployment correction constants (config.py:156-157).
    SEAM_OFFSET, WIDTH_OFFSET = -1.3, -1.0
    configs = [(name, und, dtype) for name, und in (("reference-native", False),
                                                    ("rectified", True)) for dtype in dtypes]
    if args.paths:
        keep = set(args.paths.split(","))
        configs = [c for c in configs if c[0] in keep]

    from tti_torch.kernels import maskstats, nms

    pipes, launches = {}, {}
    rows, rows_corr, per_frame = [], [], {}
    for name, und, dtype in configs:
        t1 = time.time()
        key = f"{name}/{dtype}"
        pipes[key] = pipe = build_pipeline(args.weights, undistort=und, dtype=dtype,
                                           imgsz=args.imgsz, device=args.device)
        readout = ("sub-cell 0.5-crossing (soft-mask checkpoint)"
                   if pipe.measure_cfg.subcell_edge else "binary 0.5-threshold")
        maskstats.reset_launch_counts()
        nms.reset_launch_counts()
        edge_m, width_m, n_det = run_pipeline(frames, args.weights, undistort=und,
                                              dtype=dtype, batch=args.batch, pipe=pipe)
        launches[key] = {**maskstats.LAUNCHES, **nms.LAUNCHES}
        per_frame[key] = {
            "edge_measured": edge_m.tolist(), "width_measured": width_m.tolist(),
            "n_detected": n_det.tolist()}
        es, ws = error_stats(edge_m, gt_edge), error_stats(width_m, gt_width)
        det_ratio = float(np.mean(np.minimum(n_det / np.maximum(gt_n, 1), 1.0)))
        rows.append((name, dtype, es, ws, det_ratio))
        rows_corr.append((name, dtype, error_stats(edge_m + SEAM_OFFSET, gt_edge_perp),
                          error_stats(width_m + WIDTH_OFFSET, gt_width_nom), det_ratio))
        print(f"{name}/{dtype}: {es['n']}/{args.scenes} frames; edge p50 {es['p50']:.4f} "
              f"p95 {es['p95']:.4f} bias {es['bias']:+.4f}; width p50 {ws['p50']:.4f} "
              f"p95 {ws['p95']:.4f} bias {ws['bias']:+.4f}; kernel launches "
              f"{launches[key]} ({time.time()-t1:.0f}s)", flush=True)
    versus = rectified_vs_native(rows, per_frame)
    for line in versus:
        print(line, flush=True)

    smooth_rows = []
    if args.smoothing:
        T, S = args.smoothing, args.smoothed_scenes
        sframes, struths = [], []
        for i in range(S):
            for t in range(T):
                # One geometry stream per scene, a fresh appearance stream per
                # variant: T frames of one physical scene under temporal
                # nuisance (noise, blur, lighting, JPEG).
                g = np.random.default_rng([args.seed, 7001, i])
                a = np.random.default_rng([args.seed, 7002, i, t])
                bgr, truth = make_measure_scene(mapper, g, rng_app=a)
                sframes.append(bgr)
                if t == 0:
                    struths.append(truth)
            if (i + 1) % 16 == 0:
                print(f"rendered sequence {i+1}/{S} ({time.time()-t0:.0f}s)", flush=True)
        sframes = np.stack(sframes)
        sg_edge = np.array([t.frame_edge for t in struths])
        sg_width = np.array([t.frame_width for t in struths])
        for name, und, dtype in configs:
            t1 = time.time()
            pipe = pipes[f"{name}/{dtype}"]
            edge_m, width_m, _ = run_pipeline(sframes, args.weights, undistort=und,
                                              dtype=dtype, batch=args.batch, pipe=pipe)
            sm_edge, sm_width = ring_smoothed(edge_m.reshape(S, T), width_m.reshape(S, T),
                                              pipe.measure_cfg.frame_buffer, args.device)
            es, ws = error_stats(sm_edge, sg_edge), error_stats(sm_width, sg_width)
            raw_es = error_stats(edge_m, np.repeat(sg_edge, T))
            raw_ws = error_stats(width_m, np.repeat(sg_width, T))
            smooth_rows.append((name, dtype, es, ws, raw_es, raw_ws))
            print(f"smoothed {name}/{dtype}: {es['n']}/{S} scenes; edge p50 {es['p50']:.4f} "
                  f"p95 {es['p95']:.4f}; width p50 {ws['p50']:.4f} p95 {ws['p95']:.4f}; raw "
                  f"edge p95 {raw_es['p95']:.4f} width p95 {raw_ws['p95']:.4f} "
                  f"({time.time()-t1:.0f}s)", flush=True)

    def fr(name, dtype, es, ws, det):
        return (f"| {name} | {dtype} | {es['n']}/{args.scenes} | "
                f"{es['p50']:.3f} | {es['p95']:.3f} | {es['max']:.3f} | {es['bias']:+.3f} | "
                f"{ws['p50']:.3f} | {ws['p95']:.3f} | {ws['max']:.3f} | {ws['bias']:+.3f} | "
                f"{det:.3f} |")

    table_head = [
        "| path | dtype | frames w/ value | edge p50 | edge p95 | edge max | edge bias "
        "| width p50 | width p95 | width max | width bias | det ratio |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    lines = [
        "# MEASURE_REPORT (tti_torch) — millimetre accuracy vs analytic ground truth",
        "",
        f"- {card}; torch {torch.__version__}.",
        f"- {args.scenes} deployment-geometry scenes, seed {args.seed} (1280x960, the",
        "  deployment's calibration), rendered through the exact camera model",
        f"  (tools/measure_report_torch.py). Centre scale {scale:.4f} mm/px.",
        f"- Weights: `{args.weights}` (architecture from the sidecar). Boundary readout:",
        f"  {readout}. The port's deploy step at imgsz={args.imgsz}: reference-native",
        "  (point undistortion) and rectified (the two-pass undistort warp ahead of",
        "  the model); per-frame raw values vs protocol-exact truth.",
        "",
        *table_head,
        *[fr(*r) for r in rows],
        "",
        "All error columns in mm, |measured - truth| per frame; bias = mean",
        "signed error. det ratio = detected/rendered stitches (capped at 1).",
        *([""] + [f"- {line}" for line in versus] if versus else []),
        "",
        "## With the deployment offsets, against physical truth",
        "",
        *table_head,
        *[fr(*r) for r in rows_corr],
    ]
    if smooth_rows:
        lines += [
            "",
            "## Smoothed (deployed) accuracy",
            "",
            f"- {args.smoothed_scenes} scenes x {args.smoothing} temporal variants through the",
            "  production ring; the reading it emits at the last variant.",
            "",
            "| path | dtype | scenes w/ value | edge p50 | edge p95 | edge max "
            "| width p50 | width p95 | width max | raw edge p95 | raw width p95 |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
            *[f"| {n} | {d} | {es['n']}/{args.smoothed_scenes} | "
              f"{es['p50']:.3f} | {es['p95']:.3f} | {es['max']:.3f} | "
              f"{ws['p50']:.3f} | {ws['p95']:.3f} | {ws['max']:.3f} | "
              f"{res['p95']:.3f} | {rws['p95']:.3f} |"
              for n, d, es, ws, res, rws in smooth_rows],
        ]
    lines += ["", f"Generated by tools/measure_report_torch.py, "
                  f"{time.strftime('%Y-%m-%d %H:%M:%S')}."]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump({
            "card": card, "torch": torch.__version__, "seed": args.seed,
            "weights": args.weights, "readout": readout, "kernel_launches": launches,
            "rectified_vs_native": versus,
            "protocol": [{"path": n, "dtype": d, "edge": es, "width": ws, "det_ratio": det}
                         for n, d, es, ws, det in rows],
            "offset_corrected_vs_physical": [
                {"path": n, "dtype": d, "edge": es, "width": ws, "det_ratio": det}
                for n, d, es, ws, det in rows_corr],
            "smoothed": [{"path": n, "dtype": d, "edge": es, "width": ws, "raw_edge": res,
                          "raw_width": rws, "window": args.smoothing,
                          "scenes": args.smoothed_scenes}
                         for n, d, es, ws, res, rws in smooth_rows],
            "truth": {"edge": gt_edge.tolist(), "width": gt_width.tolist(),
                      "edge_perp": gt_edge_perp.tolist(), "width_nominal": gt_width_nom.tolist(),
                      "n_stitches": gt_n.tolist()},
            "per_frame": per_frame,
        }, f, indent=1)
    print(f"wrote {args.out} ({time.time()-t0:.0f}s total)")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
