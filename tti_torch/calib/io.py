"""Calibration file IO (copy of ``tti.calib.io``): loaders and writers.

``camera_calibration.json`` holds a 3x3 camera_matrix, 5 dist_coeffs and
optionally rms/image_size; ``extrinsics.json`` holds {rvec, tvec}.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from tti_torch.core.errors import CalibrationError


@dataclass(frozen=True)
class CalibrationData:
    """Host-side calibration bundle (numpy float64)."""

    K: np.ndarray  # (3,3) camera matrix
    dist: np.ndarray  # (5,) k1,k2,p1,p2,k3
    rvec: np.ndarray  # (3,) Rodrigues rotation
    tvec: np.ndarray  # (3,) translation, meters
    image_size: tuple[int, int] | None = None  # (w,h)
    rms: float | None = None

    @staticmethod
    def load(intrinsics_path: str, extrinsics_path: str) -> "CalibrationData":
        K, dist, image_size, rms = load_intrinsics(intrinsics_path)
        rvec, tvec = load_extrinsics(extrinsics_path)
        return CalibrationData(K=K, dist=dist, rvec=rvec, tvec=tvec,
                               image_size=image_size, rms=rms)


def load_intrinsics(path: str) -> tuple[np.ndarray, np.ndarray, tuple[int, int] | None, float | None]:
    if not os.path.exists(path):
        raise CalibrationError(f"Calibration file missing: {path}")
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        K = np.asarray(data["camera_matrix"], dtype=np.float64)
        dist = np.asarray(data["dist_coeffs"], dtype=np.float64).ravel()
    except (KeyError, ValueError, json.JSONDecodeError) as e:
        raise CalibrationError(f"Failed to load intrinsics from {path}: {e}") from e
    if K.shape != (3, 3):
        raise CalibrationError(f"camera_matrix must be 3x3, got {K.shape}")
    size = tuple(int(v) for v in data["image_size"]) if "image_size" in data else None
    rms = float(data["rms"]) if "rms" in data else None
    return K, dist, size, rms


def load_extrinsics(path: str) -> tuple[np.ndarray, np.ndarray]:
    if not os.path.exists(path):
        raise CalibrationError(f"Extrinsics file missing: {path}")
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        rvec = np.asarray(data["rvec"], dtype=np.float64).reshape(3)
        tvec = np.asarray(data["tvec"], dtype=np.float64).reshape(3)
    except (KeyError, ValueError, json.JSONDecodeError) as e:
        raise CalibrationError(f"Failed to load extrinsics from {path}: {e}") from e
    return rvec, tvec


def save_extrinsics(rvec: np.ndarray, tvec: np.ndarray, path: str) -> None:
    """Write {rvec, tvec} as flat lists (the reference's bytes)."""
    data = {
        "rvec": np.asarray(rvec, dtype=np.float64).flatten().tolist(),
        "tvec": np.asarray(tvec, dtype=np.float64).flatten().tolist(),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)


def save_intrinsics(K: np.ndarray, dist: np.ndarray, path: str,
                    image_size: tuple[int, int] | None = None, rms: float | None = None) -> None:
    """Write camera_matrix, dist_coeffs (one nested row) and optionally rms
    and image_size (the reference's bytes)."""
    data: dict = {
        "camera_matrix": np.asarray(K, dtype=np.float64).tolist(),
        "dist_coeffs": [np.asarray(dist, dtype=np.float64).ravel().tolist()],
    }
    if rms is not None:
        data["rms"] = float(rms)
    if image_size is not None:
        data["image_size"] = [int(image_size[0]), int(image_size[1])]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
