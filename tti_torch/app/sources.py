"""Frame sources: the host IO boundary (port of ``tti.app.sources``).

Capture is a small protocol so that the orchestrator, the stream runtime,
the tests and the smoke run share one loop:

- OpenCVCameraSource: V4L2 camera with the reference's resolution/exposure
  setup and reconnect,
- DirectorySource: replay of image files,
- SyntheticSource: generated frames (tests, runs without hardware).

The camera and directory sources import OpenCV in their constructors.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Protocol

import numpy as np

from tti_torch.core.config import CameraConfig
from tti_torch.core.logging import get_logger

log = get_logger("app.sources")


class FrameSource(Protocol):
    def read(self) -> tuple[bool, np.ndarray | None]: ...

    def reconnect(self) -> None: ...

    def release(self) -> None: ...


class SyntheticSource:
    """Deterministic generated frames (tests and runs without hardware)."""

    def __init__(self, height: int = 960, width: int = 1280, seed: int = 0,
                 count: int | None = None) -> None:
        self._rng = np.random.default_rng(seed)
        self.height, self.width = height, width
        self.count = count
        self._emitted = 0

    def read(self) -> tuple[bool, np.ndarray | None]:
        if self.count is not None and self._emitted >= self.count:
            return False, None
        self._emitted += 1
        frame = self._rng.integers(0, 255, size=(self.height, self.width, 3), dtype=np.uint8)
        return True, frame

    def reconnect(self) -> None: ...

    def release(self) -> None: ...


class DirectorySource:
    """Replays image files from a directory in sorted order. ``_idx`` is the
    next file's index (set it to 0 to rewind)."""

    def __init__(self, directory: str, loop: bool = False) -> None:
        import cv2

        self._cv2 = cv2
        self.paths = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
        )
        if not self.paths:
            raise FileNotFoundError(f"no images in {directory}")
        self.loop = loop
        self._idx = 0

    def read(self) -> tuple[bool, np.ndarray | None]:
        if self._idx >= len(self.paths):
            if not self.loop:
                return False, None
            self._idx = 0
        frame = self._cv2.imread(self.paths[self._idx])
        self._idx += 1
        return (frame is not None), frame

    def reconnect(self) -> None: ...

    def release(self) -> None: ...


class OpenCVCameraSource:
    """V4L2 camera with the reference's setup: resolution, a 2 s settle,
    exposure; a full re-open on reconnect."""

    def __init__(self, config: CameraConfig, index: str | int | None = None) -> None:
        import cv2

        self._cv2 = cv2
        self.config = config
        if index is None:
            index = config.index
        if index is None:
            from tti_torch.services.hardware import find_camera

            index = find_camera()
        if index is None:
            raise RuntimeError("no camera found")
        self.index = index
        self.cap = None
        self._open()

    def _open(self) -> None:
        cv2 = self._cv2
        self.cap = cv2.VideoCapture(self.index, cv2.CAP_V4L2)
        cap = self.cap
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.config.width)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.config.height)
        time.sleep(2)  # let the camera settle
        aw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        ah = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, self.config.auto_exposure)
        cap.set(cv2.CAP_PROP_EXPOSURE, self.config.exposure)
        if (aw, ah) != (self.config.width, self.config.height):
            log.warning("camera resolution %dx%d, expected %dx%d",
                        aw, ah, self.config.width, self.config.height)

    def read(self) -> tuple[bool, np.ndarray | None]:
        ok, frame = self.cap.read()
        return ok, frame

    def reconnect(self) -> None:
        try:
            self.cap.release()
        except Exception:
            pass
        time.sleep(1)
        self._open()

    def release(self) -> None:
        if self.cap is not None:
            self.cap.release()


def frames_iter(source: FrameSource) -> Iterator[np.ndarray]:
    """Adapter: FrameSource -> iterator of frames, until a read fails."""
    while True:
        ok, frame = source.read()
        if not ok:
            return
        yield frame
