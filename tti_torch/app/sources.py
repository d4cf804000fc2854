"""Frame sources: the host IO boundary (port of the protocol and the
synthetic source of ``tti.app.sources``).

Capture is a small protocol so that the stream runtime, the tests and the
smoke run share one loop. The camera and directory sources need OpenCV and
come with the CLI slice.
"""

from __future__ import annotations

from typing import Iterator, Protocol

import numpy as np


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


def frames_iter(source: FrameSource) -> Iterator[np.ndarray]:
    """Adapter: FrameSource -> iterator of frames, until a read fails."""
    while True:
        ok, frame = source.read()
        if not ok:
            return
        yield frame
