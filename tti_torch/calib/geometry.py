"""Camera geometry on batched tensors (port of ``tti.calib.geometry``).

OpenCV's 5-coefficient pinhole model. Every function takes ``(..., N, 2)``
batches; the undistort inverse is cv2.undistortPoints' fixed-point iteration
with a static count.
"""

from __future__ import annotations

import torch

from tti_torch.preprocess.letterbox import jit_divide

Tensor = torch.Tensor

_DENOM_EPS = 1e-9  # degenerate-ray guard


def rodrigues(rvec: Tensor) -> Tensor:
    """Rotation vector (3,) -> 3x3 rotation matrix (cv2.Rodrigues)."""
    rvec = rvec.reshape(3)
    theta = torch.sqrt(torch.sum(rvec * rvec) + 1e-30)
    small = theta < 1e-8
    k = rvec / torch.where(small, torch.ones_like(theta), theta)
    zero = torch.zeros_like(k[0])
    kx = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    c, s = torch.cos(theta), torch.sin(theta)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = c * eye + (1.0 - c) * (k[:, None] * k[None, :]) + s * kx
    return torch.where(small, eye, R)


def camera_plane(R: Tensor, t: Tensor) -> tuple[Tensor, Tensor]:
    """Fabric plane in camera coordinates: normal n and offset d, n.X + d = 0."""
    n_c = R[:, 2]
    d_c = -torch.dot(n_c, t.reshape(3))
    return n_c, d_c


def _radial_tangential(x: Tensor, y: Tensor, dist: Tensor) -> tuple[Tensor, Tensor]:
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x * radial + dx, y * radial + dy


def distort_points(xy: Tensor, K: Tensor, dist: Tensor) -> Tensor:
    """Normalized ideal coords (..., 2) -> distorted pixel coords (..., 2)."""
    xd, yd = _radial_tangential(xy[..., 0], xy[..., 1], dist)
    u = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return torch.stack([u, v], dim=-1)


def undistort_points(uv: Tensor, K: Tensor, dist: Tensor, iters: int = 5) -> Tensor:
    """Distorted pixel coords (..., 2) -> ideal normalized coords (..., 2);
    cv2.undistortPoints semantics (iters=5 reproduces cv2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    fx, fy, cx, cy, skew = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    v0 = jit_divide(uv[..., 1] - cy, fy)
    u0 = jit_divide(uv[..., 0] - cx - skew * v0, fx)
    x, y = u0, v0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (u0 - dx) * icdist
        y = (v0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


def pixels_to_world(uv: Tensor, K: Tensor, dist: Tensor, R: Tensor, t: Tensor,
                    iters: int = 5) -> tuple[Tensor, Tensor]:
    """Batched pixel -> 3D world point by ray-plane intersection.
    Returns (world (..., 3) meters, valid (...,) bool); invalid rows are 0."""
    t = t.reshape(3)
    n_c, d_c = camera_plane(R, t)
    xy = undistort_points(uv, K, dist, iters=iters)
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    denom = ray @ n_c
    valid = torch.abs(denom) >= _DENOM_EPS
    s = -d_c / torch.where(valid, denom, torch.ones_like(denom))
    x_world = (s[..., None] * ray - t) @ R
    return torch.where(valid[..., None], x_world, torch.zeros_like(x_world)), valid


def pixels_to_plane_mm(uv: Tensor, K: Tensor, dist: Tensor, R: Tensor, t: Tensor,
                       iters: int = 5) -> tuple[Tensor, Tensor]:
    """:func:`pixels_to_world` in millimetres."""
    world, valid = pixels_to_world(uv, K, dist, R, t, iters=iters)
    return world * 1000.0, valid


def _f32(a, like: Tensor) -> Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def project_points(points_w: Tensor, rvec, tvec, K, dist) -> Tensor:
    """World points (..., 3) -> distorted pixel coords (..., 2), as
    cv2.projectPoints; in float32 on ``points_w``'s device, as ``tti``
    computes it (its arrays are float32)."""
    pts = points_w.to(torch.float32)
    R = rodrigues(_f32(rvec, pts))
    pc = pts @ R.T + _f32(tvec, pts).reshape(3)
    return distort_points(pc[..., :2] / pc[..., 2:3], _f32(K, pts), _f32(dist, pts))


def local_mm_per_px(uv: Tensor, K, dist, R, t, probe_px: float = 10.0,
                    iters: int = 5) -> tuple[Tensor, Tensor]:
    """Local mm-per-pixel scale at pixel(s) ``uv`` (..., 2): ``uv`` and ``uv +
    (probe_px, 0)`` go to the fabric plane and the world distance is divided
    by the probe length, in float32 on ``uv``'s device. Returns (scale
    (...,), valid (...,) bool: both probe rays meet the plane)."""
    uv = uv.to(torch.float32)
    K, dist, R, t = (_f32(a, uv) for a in (K, dist, R, t))
    uv2 = torch.stack([uv[..., 0] + probe_px, uv[..., 1]], -1)
    w1, v1 = pixels_to_plane_mm(uv, K, dist, R, t, iters=iters)
    w2, v2 = pixels_to_plane_mm(uv2, K, dist, R, t, iters=iters)
    return jit_divide(torch.linalg.vector_norm(w1 - w2, dim=-1), probe_px), v1 & v2
