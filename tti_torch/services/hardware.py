"""Hardware discovery, host-side and never at import time (copy of
``tti.services.hardware``).

Same contracts as the reference (hardware_utils.py:5-20): ESP32 by USB VID/PID
0x303A/0x1001; camera by probing /dev/video0..2. The reference probes at config
import (config.py:58,114), which breaks any tool that merely imports config
(see Utils/check_model.py:62-92); here consumers call these explicitly.
"""

from __future__ import annotations

from tti_torch.core.logging import get_logger

log = get_logger("services.hardware")

ESP32_VID = 0x303A
ESP32_PID = 0x1001
CAMERA_CANDIDATES = ("/dev/video0", "/dev/video1", "/dev/video2")


def find_esp32() -> str | None:
    """Locate the ESP32 stitch counter by USB VID/PID (reference:
    hardware_utils.py:5-10). Returns the device path or None."""
    try:
        import serial.tools.list_ports  # optional dependency
    except ImportError:
        log.debug("pyserial not installed; ESP32 discovery unavailable")
        return None
    for port in serial.tools.list_ports.comports():
        if port.vid == ESP32_VID and port.pid == ESP32_PID:
            return port.device
    return None


def find_camera() -> str | None:
    """Probe /dev/video0..2 for an openable camera (reference:
    hardware_utils.py:13-20). Returns the first working device or None
    (the reference returns /dev/video0 even when nothing opens; returning None
    lets the caller degrade explicitly instead of failing later)."""
    try:
        import cv2
    except ImportError:
        log.debug("cv2 not installed; camera discovery unavailable")
        return None
    for cam in CAMERA_CANDIDATES:
        cap = cv2.VideoCapture(cam)
        if cap.isOpened():
            cap.release()
            return cam
    return None
