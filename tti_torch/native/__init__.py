"""Native host runtime: the C++ frame ring and batch assembler with ctypes
bindings (the port's own copy of ``tti.native``).

``framering.cpp`` is compiled at first use (g++ -O3 -shared) into ``build/``
at the repository root, keyed by a hash of the source; no library is shipped.
Without a compiler :class:`FrameRing` falls back to a pure-Python ring
(functionally identical, GIL-bound) unless ``native=True`` was asked for.
See ``framering.cpp`` for the concurrency model.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

from tti_torch.core.logging import get_logger

log = get_logger("native")

_SRC = Path(__file__).resolve().parent / "framering.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lib: ctypes.CDLL | None = None
_lib_failed = False
_lib_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load_library() -> ctypes.CDLL | None:
    """The ring library, compiled if need be; None when no compiler works."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libtti_framering_{tag}.so"
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(["g++", *_GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
                log.info("compiled %s", out)
            except (subprocess.SubprocessError, OSError) as e:
                log.warning("native build failed (%s); using python fallback", e)
                _lib_failed = True
                return None
        lib = ctypes.CDLL(str(out))
        lib.tti_ring_create.restype = ctypes.c_void_p
        lib.tti_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.tti_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.tti_ring_push.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64]
        lib.tti_ring_head.restype = ctypes.c_uint64
        lib.tti_ring_head.argtypes = [ctypes.c_void_p]
        lib.tti_ring_snapshot.restype = ctypes.c_int64
        lib.tti_ring_snapshot.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_uint64)]
        lib.tti_ring_gather_batch.restype = ctypes.c_uint64
        lib.tti_ring_gather_batch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, _U8P]
        lib.tti_ring_dropped.restype = ctypes.c_uint64
        lib.tti_ring_dropped.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def gather_batch(rings: "list[FrameRing]", out: np.ndarray) -> int:
    """Copy the freshest frame of each ring into the contiguous batch ``out``
    (S, *frame_shape) with one native call. Returns a bitmask of the rings
    that had a frame; an empty ring leaves its slot untouched. Falls back to
    per-ring snapshots when any ring is not native."""
    lib = _load_library()
    if lib is None or not all(r.native for r in rings):
        mask = 0
        for i, ring in enumerate(rings):
            snap = ring.snapshot(1)
            if snap.shape[0]:
                out[i] = snap[0]
                mask |= 1 << i
        return mask
    if not out.flags.c_contiguous or out.dtype != np.uint8:
        raise ValueError("gather_batch needs a C-contiguous uint8 batch")
    handles = (ctypes.c_void_p * len(rings))(*[r._handle for r in rings])
    return int(lib.tti_ring_gather_batch(handles, len(rings), out.ctypes.data_as(_U8P)))


class FrameRing:
    """Latest-N frame ring over the C++ seqlock implementation (or a locked
    Python deque). Frames are fixed-shape uint8 arrays."""

    def __init__(self, capacity: int, frame_shape: tuple[int, ...],
                 native: bool | None = None) -> None:
        self.capacity = capacity
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self._lib = _load_library() if native in (None, True) else None
        if native is True and self._lib is None:
            raise RuntimeError("native frame ring requested but unavailable")
        if self._lib is not None:
            self._handle = self._lib.tti_ring_create(capacity, self.frame_bytes)
            if not self._handle:
                raise MemoryError("tti_ring_create failed")
        else:
            self._deque: deque[np.ndarray] = deque(maxlen=capacity)
            self._pushed = 0
            self._lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def push(self, frame: np.ndarray, timestamp_ns: int | None = None) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.nbytes != self.frame_bytes:
            raise ValueError(f"frame bytes {frame.nbytes} != ring frame {self.frame_bytes}")
        ts = time.monotonic_ns() if timestamp_ns is None else timestamp_ns
        if self._lib is not None:
            self._lib.tti_ring_push(self._handle, frame.ctypes.data_as(_U8P), ts)
        else:
            with self._lock:
                self._deque.append(frame.copy())
                self._pushed += 1

    def head(self) -> int:
        if self._lib is not None:
            return int(self._lib.tti_ring_head(self._handle))
        with self._lock:
            return self._pushed

    def dropped(self) -> int:
        """Frames overwritten before being part of any snapshot window."""
        if self._lib is not None:
            return int(self._lib.tti_ring_dropped(self._handle))
        with self._lock:
            return max(0, self._pushed - self.capacity)

    def snapshot(self, count: int) -> np.ndarray:
        """Newest ``count`` frames, oldest first, as one contiguous
        (n, *frame_shape) uint8 batch (n <= count)."""
        out = np.empty((count, *self.frame_shape), np.uint8)
        if self._lib is not None:
            ids = (ctypes.c_uint64 * count)()
            n = self._lib.tti_ring_snapshot(self._handle, out.ctypes.data_as(_U8P), count, ids)
            return out[:n]
        with self._lock:
            frames = list(self._deque)[-count:]
        for i, f in enumerate(frames):
            out[i] = f.reshape(self.frame_shape)
        return out[:len(frames)]

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_handle", None):
            lib.tti_ring_destroy(self._handle)
            self._handle = None
