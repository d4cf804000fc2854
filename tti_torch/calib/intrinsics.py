"""Intrinsic camera calibration from ChArUco board views (port of
``tti.calib.intrinsics``).

The reference has no in-repo intrinsic calibration — deployments download a
separate GUI app for it (reference: download_calibartion_app.sh; the output
lands in camera_calibration.json). Here it is a command: collect board
detections across N views, run cv2.calibrateCamera, and write the
reference-format JSON (camera_matrix + dist_coeffs + rms + image_size).

Detection reuses :mod:`tti_torch.calib.charuco` (inverted-gray ChArUco); the
capture loop takes a frame iterator so it works with cameras, directories or
synthetic renders. OpenCV is imported inside the functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

from tti_torch.calib.charuco import CharucoBoard, aruco_cv2, create_charuco_board, detect_charuco
from tti_torch.calib.io import save_intrinsics
from tti_torch.core.config import BoardConfig
from tti_torch.core.errors import CalibrationError
from tti_torch.core.logging import get_logger

log = get_logger("calib.intrinsics")

MIN_VIEWS = 5
MIN_CORNERS_PER_VIEW = 8


@dataclass
class IntrinsicsResult:
    K: np.ndarray
    dist: np.ndarray
    rms: float
    image_size: tuple[int, int]
    n_views: int


def collect_views(
    frames: Iterable[np.ndarray],
    board: CharucoBoard,
    max_views: int = 25,
    min_corner_delta_px: float = 20.0,
) -> tuple[list[np.ndarray], list[np.ndarray], tuple[int, int] | None]:
    """Detect the board across frames, keeping views that moved enough since
    the last kept one (diversity matters more than count for calibration)."""
    corners_all: list[np.ndarray] = []
    ids_all: list[np.ndarray] = []
    image_size: tuple[int, int] | None = None
    last_mean: np.ndarray | None = None
    for frame in frames:
        if image_size is None:
            image_size = (frame.shape[1], frame.shape[0])
        det = detect_charuco(board, frame)
        if det is None:
            continue
        corners, ids = det
        if len(ids) < MIN_CORNERS_PER_VIEW:
            continue
        mean = corners.mean(axis=0)
        if last_mean is not None and np.linalg.norm(mean - last_mean) < min_corner_delta_px:
            continue  # too similar to the previous kept view
        corners_all.append(corners.astype(np.float32))
        ids_all.append(ids.astype(np.int32))
        last_mean = mean
        log.debug("kept view %d (%d corners)", len(corners_all), len(ids))
        if len(corners_all) >= max_views:
            break
    return corners_all, ids_all, image_size


def calibrate_intrinsics(
    frames: Iterable[np.ndarray],
    board: CharucoBoard | None = None,
    output_path: str | None = None,
    max_views: int = 25,
    fix_k3: bool = True,
) -> IntrinsicsResult:
    """Full intrinsic calibration. Raises CalibrationError on insufficient data.

    fix_k3=True pins the 6th-order radial term (it is unconstrained and
    explodes with few/low-distortion views; release it only with 20+ diverse
    views).
    """
    cv2 = aruco_cv2()
    board = board or create_charuco_board(BoardConfig())
    corners_all, ids_all, image_size = collect_views(frames, board, max_views)
    if image_size is None or len(corners_all) < MIN_VIEWS:
        raise CalibrationError(
            f"need >= {MIN_VIEWS} diverse board views, got {len(corners_all)}"
        )

    template = board.chessboard_corners().astype(np.float32)
    obj_points = [template[ids.ravel()] for ids in ids_all]
    img_points = [c.reshape(-1, 1, 2) for c in corners_all]

    flags = cv2.CALIB_FIX_K3 if fix_k3 else 0
    rms, K, dist, _, _ = cv2.calibrateCamera(
        obj_points, img_points, image_size, None, None, flags=flags
    )
    result = IntrinsicsResult(
        K=np.asarray(K), dist=np.asarray(dist).ravel()[:5], rms=float(rms),
        image_size=image_size, n_views=len(corners_all),
    )
    log.info(
        "intrinsics from %d views: fx=%.1f fy=%.1f rms=%.3f px",
        result.n_views, result.K[0, 0], result.K[1, 1], result.rms,
    )
    if output_path:
        save_intrinsics(result.K, result.dist, output_path,
                        image_size=result.image_size, rms=result.rms)
    return result
