"""The deployment a configuration file describes, as the program takes it.

Frozen at commit bb8100e from ``bench_torch.py``: the intrinsics of the
1280x960 sensor scaled to the frame (``bench_calibration``) and the ROI
rule (``bench_roi``); the numbers themselves (``K_960``, ``DIST``,
``RVEC``, ``TVEC``) are in each ``benchmark/configs/<name>.json`` under
``run.camera``. This module builds the program's objects from them and is
imported by the harness only: the reference reads the same numbers itself.
"""

from __future__ import annotations

import numpy as np


def calibration_arrays(camera: dict, frame_hw) -> dict:
    """K scaled from the sensor to the frame, with the distortion and pose."""
    h, w = frame_hw
    K = np.array(camera["K_sensor"], np.float64)
    K[0] *= w / camera["sensor_wh"][0]
    K[1] *= h / camera["sensor_wh"][1]
    return {"K": K, "dist": np.array(camera["dist"], np.float64),
            "rvec": np.array(camera["rvec"], np.float64),
            "tvec": np.array(camera["tvec"], np.float64)}


def roi_bounds(roi: dict, frame_hw) -> dict:
    """``bench_roi``: x from ``x_min`` to ``w + x_max_from_right``, y from
    ``min(y_min, h // 3)`` to ``h - min(y_max_from_bottom, h // 5)``."""
    h, w = frame_hw
    return {"x_min": roi["x_min"], "x_max": w + roi["x_max_from_right"],
            "y_min": min(roi["y_min"], h // 3), "y_max": h - min(roi["y_max_from_bottom"], h // 5)}
