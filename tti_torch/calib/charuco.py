"""ChArUco extrinsic calibration on the host (port of ``tti.calib.charuco``).

One-shot, not hot: corner detection runs on the CPU through OpenCV's aruco
module; the pose solve uses either ``cv2.solvePnP`` or the float64 LM solver
of :mod:`tti_torch.calib.pnp`. OpenCV is imported inside the functions, so
the module imports without it; without ``cv2.aruco`` they raise
``CalibrationError``.

Behaviour of the reference (calibration.py:85-222):
- board: DICT_4X4_50, 5x6 squares, 10 mm squares / 8 mm markers (config defaults),
- detection runs on **inverted** grayscale (reference: calibration.py:121-122,131),
- auto-capture after a fixed delay (5 s) then fail-fast if too few corners
  (reference: calibration.py:188-195),
- extrinsics persisted as {rvec, tvec} JSON (reference: calibration.py:37-47).

The capture loop takes a frame iterator and an injectable clock, so it runs
on synthetic board renders with no camera and no GUI; a finite iterator ends
the loop at its last frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np

from tti_torch.calib.io import save_extrinsics
from tti_torch.calib.pnp import solve_pnp_planar
from tti_torch.core.config import BoardConfig
from tti_torch.core.errors import CalibrationError
from tti_torch.core.logging import get_logger

log = get_logger("calib.charuco")


def aruco_cv2():
    """OpenCV with its aruco module, or ``CalibrationError``."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None or not hasattr(cv2, "aruco"):
        raise CalibrationError("OpenCV with aruco support is required for ChArUco detection")
    return cv2


@dataclass
class CharucoBoard:
    """Board + detector handles (reference: calibration.py:52-80)."""

    board: object
    detector: object | None
    config: BoardConfig

    def chessboard_corners(self) -> np.ndarray:
        return np.asarray(self.board.getChessboardCorners(), dtype=np.float64)


def create_charuco_board(config: BoardConfig | None = None) -> CharucoBoard:
    cv2 = aruco_cv2()
    config = config or BoardConfig()
    aruco_dict = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, config.dict_name))
    # The reference passes (SQUARES_Y, SQUARES_X) (reference: calibration.py:57-62);
    # keep the same geometry so saved extrinsics stay interchangeable.
    board = cv2.aruco.CharucoBoard(
        (config.squares_y, config.squares_x),
        config.square_length_m,
        config.marker_length_m,
        aruco_dict,
    )
    detector = cv2.aruco.CharucoDetector(
        board, cv2.aruco.CharucoParameters(), cv2.aruco.DetectorParameters()
    )
    return CharucoBoard(board=board, detector=detector, config=config)


def detect_charuco(board: CharucoBoard, frame_bgr: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Detect ChArUco corners on an inverted-grayscale view of the frame.

    Returns (corners (N,2), ids (N,)) or None. Inversion matches the reference's
    white-on-black boards (reference: calibration.py:121-122,131).
    """
    cv2 = aruco_cv2()
    if frame_bgr.ndim == 3:
        gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    else:
        gray = frame_bgr
    if board.config.invert_gray:
        gray = cv2.bitwise_not(gray)
    corners, ids, _, _ = board.detector.detectBoard(gray)
    if ids is None or len(ids) == 0:
        return None
    return corners.reshape(-1, 2).astype(np.float64), ids.reshape(-1).astype(np.int64)


def solve_board_pose(
    board: CharucoBoard,
    corners: np.ndarray,
    ids: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    solver: str = "tti",
) -> tuple[np.ndarray, np.ndarray, float]:
    """Pose from detected corners. solver='tti' (the float64 LM of
    :mod:`tti_torch.calib.pnp`, cv2-free) or 'cv2' (reference:
    calibration.py:197-202). Returns (rvec, tvec, rms_px)."""
    obj_pts = board.chessboard_corners()[ids]
    img_pts = np.asarray(corners, dtype=np.float64).reshape(-1, 2)
    if solver == "cv2":
        cv2 = aruco_cv2()
        ok, rvec, tvec = cv2.solvePnP(
            obj_pts.astype(np.float64),
            img_pts,
            np.asarray(K, dtype=np.float64),
            np.asarray(dist, dtype=np.float64),
            flags=cv2.SOLVEPNP_ITERATIVE,
        )
        if not ok:
            raise CalibrationError("cv2.solvePnP failed")
        proj, _ = cv2.projectPoints(obj_pts, rvec, tvec, K, dist)
        rms = float(np.sqrt(np.mean(np.sum((proj.reshape(-1, 2) - img_pts) ** 2, axis=1))))
        return rvec.reshape(3), tvec.reshape(3), rms
    rvec, tvec, rms = solve_pnp_planar(obj_pts, img_pts, K, dist)
    return np.asarray(rvec, np.float64), np.asarray(tvec, np.float64), float(rms)


def run_extrinsic_calibration(
    frames: Iterable[np.ndarray],
    K: np.ndarray,
    dist: np.ndarray,
    extrinsics_path: str,
    board: CharucoBoard | None = None,
    capture_delay_s: float | None = None,
    clock: Callable[[], float] = time.monotonic,
    solver: str = "tti",
) -> bool:
    """Watch ``frames`` until the capture delay elapses, then solve + save pose.

    Mirrors the reference loop (calibration.py:109-222): keep detecting during the
    delay window; at deadline, require >= min_corners detected on the latest frame
    else fail. Returns True on success (extrinsics written), False otherwise —
    the caller decides whether stale extrinsics are an acceptable fallback
    (reference: main.py:41-45).
    """
    board = board or create_charuco_board()
    delay = board.config.capture_delay_s if capture_delay_s is None else capture_delay_s
    deadline = clock() + delay
    last_detection: tuple[np.ndarray, np.ndarray] | None = None

    for frame in frames:
        det = detect_charuco(board, frame)
        if det is not None:
            last_detection = det
            log.debug("detected %d charuco corners", len(det[1]))
        if clock() >= deadline:
            break

    if last_detection is None or len(last_detection[1]) < board.config.min_corners:
        found = 0 if last_detection is None else len(last_detection[1])
        log.warning(
            "calibration failed: %d/%d charuco corners", found, board.config.min_corners
        )
        return False

    corners, ids = last_detection
    try:
        rvec, tvec, rms = solve_board_pose(board, corners, ids, K, dist, solver=solver)
    except CalibrationError as e:
        log.warning("pose solve failed: %s", e)
        return False
    save_extrinsics(rvec, tvec, extrinsics_path)
    log.info("extrinsics saved to %s (reprojection rms %.3f px)", extrinsics_path, rms)
    return True
