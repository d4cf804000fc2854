"""Planar PnP: homography init + Levenberg-Marquardt refinement (host,
float64; copy of ``tti.calib.pnp``).

Replacement for ``cv2.solvePnP(..., SOLVEPNP_ITERATIVE)`` used by the extrinsic
calibration (reference: calibration.py:200-202). The board is planar (ChArUco on
the fabric plane, z=0 object points), so the classic planar-pose recipe applies:

1. undistort image points to normalized coordinates (float64 fixed point),
2. DLT homography object(x,y) -> normalized(x,y) via SVD,
3. decompose H into (R, t) with SVD orthogonalization,
4. Levenberg-Marquardt on the pinhole reprojection residual in normalized
   coordinates (the same reduction OpenCV performs) with accept/reject damping.

Precision: calibration is a one-shot host operation, not a device path, and
pose refinement needs float64. A float32 version of this solver stalled at
0.1-0.4 px residual on noise-free data, with convergence flipping as the
compiler reordered the normal equations; numpy float64 is deterministic and
converges to ~1e-5 px. The device-side geometry
(:mod:`tti_torch.calib.geometry`) only evaluates the forward maps, which are
well-conditioned in float32.
"""

from __future__ import annotations

import numpy as np

Array = np.ndarray


def rotation_to_rvec(R: Array) -> Array:
    """Log map SO(3) -> rotation vector (inverse Rodrigues), float64."""
    R = np.asarray(R, dtype=np.float64)
    trace = np.trace(R)
    cos_theta = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    axis_raw = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_theta = np.sin(theta)
    if abs(sin_theta) >= 1e-7:
        return axis_raw / (2.0 * sin_theta) * theta
    if cos_theta > 0.0:  # theta ~ 0
        return axis_raw * 0.5
    # theta ~ pi: axis from diagonal of (R + I)/2 = kk^T.
    kk = (np.diag(R) + 1.0) * 0.5
    axis = np.sqrt(np.clip(kk, 0.0, None))
    major = int(np.argmax(axis))
    signs = np.sign(R[major] + np.eye(3)[major])
    signs[signs == 0] = 1.0
    axis = axis * signs
    axis /= np.linalg.norm(axis) + 1e-30
    return axis * theta


def _rodrigues_np(rvec: Array) -> Array:
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k) + np.sin(theta) * K


def _undistort_np(uv: Array, K: Array, dist: Array, iters: int = 20) -> Array:
    """float64 fixed-point inverse of the 5-coeff distortion model (same math
    as tti_torch.calib.geometry.undistort_points, converged)."""
    k1, k2, p1, p2, k3 = np.asarray(dist, np.float64).ravel()[:5]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy, skew = K[0, 2], K[1, 2], K[0, 1]
    v0 = (uv[..., 1] - cy) / fy
    u0 = (uv[..., 0] - cx - skew * v0) / fx
    x, y = u0.copy(), v0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (u0 - dx) * icdist
        y = (v0 - dy) * icdist
    return np.stack([x, y], axis=-1)


def _homography_dlt(src: Array, dst: Array, weights: Array) -> Array:
    """Weighted DLT homography src (N,2) -> dst (N,2); weight-0 rows are padding."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    rows_u = np.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=-1)
    rows_v = np.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], axis=-1)
    A = np.concatenate([rows_u, rows_v], axis=0) * np.concatenate([weights, weights])[:, None]
    _, _, vt = np.linalg.svd(A, full_matrices=False)
    return vt[-1].reshape(3, 3)


def _pose_from_homography(H: Array) -> tuple[Array, Array]:
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    scale = 1.0 / max(np.linalg.norm(h1), 1e-12)
    sign = 1.0 if h3[2] * scale > 0 else -1.0  # board in front of camera
    r1, r2, t = h1 * scale * sign, h2 * scale * sign, h3 * scale * sign
    R_raw = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    u, _, vt = np.linalg.svd(R_raw)
    d = np.sign(np.linalg.det(u @ vt))
    R = u @ np.diag([1.0, 1.0, d]) @ vt
    return R, t


def solve_pnp_planar(
    object_pts: Array,
    image_pts: Array,
    K: Array,
    dist: Array,
    valid: Array | None = None,
    lm_iters: int = 50,
) -> tuple[Array, Array, float]:
    """Solve planar PnP. object_pts (N,3) with z=0; image_pts (N,2) distorted px.

    ``valid`` masks padding rows (None => all valid). Returns (rvec (3,),
    tvec (3,), rms reprojection error in pixels over valid points).
    """
    obj = np.asarray(object_pts, np.float64)
    img = np.asarray(image_pts, np.float64)
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64)
    w = np.ones(len(obj)) if valid is None else np.asarray(valid, np.float64)
    sqrt_w = np.sqrt(w)

    norm_xy = _undistort_np(img, K, dist)
    H = _homography_dlt(obj[:, :2], norm_xy, w)
    R0, t0 = _pose_from_homography(H)
    params = np.concatenate([rotation_to_rvec(R0), t0])

    def residuals(p: Array) -> Array:
        R = _rodrigues_np(p[:3])
        pc = obj @ R.T + p[3:]
        xy = pc[:, :2] / pc[:, 2:3]
        return ((xy - norm_xy) * sqrt_w[:, None]).ravel()

    def jac(p: Array) -> Array:
        eps = 1e-7
        cols = []
        for i in range(6):
            dp = np.zeros(6)
            dp[i] = eps
            cols.append((residuals(p + dp) - residuals(p - dp)) / (2 * eps))
        return np.stack(cols, axis=1)

    lam = 1e-3
    cost = float(residuals(params) @ residuals(params))
    for _ in range(lm_iters):
        r = residuals(params)
        J = jac(params)
        JtJ = J.T @ J
        try:
            step = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ)) + 1e-15 * np.eye(6), J.T @ r)
        except np.linalg.LinAlgError:
            lam *= 10.0
            continue
        cand = params - step
        cand_cost = float(residuals(cand) @ residuals(cand))
        if cand_cost < cost:
            params, cost = cand, cand_cost
            lam = max(lam * 0.3, 1e-12)
            if np.linalg.norm(step) < 1e-14:
                break
        else:
            lam = min(lam * 4.0, 1e8)

    rms_norm = float(np.sqrt(cost / max(w.sum() * 2.0, 1.0)))
    focal = 0.5 * (K[0, 0] + K[1, 1])
    return params[:3], params[3:], rms_norm * focal
