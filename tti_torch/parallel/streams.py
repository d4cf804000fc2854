"""Multi-camera stream runtime (port of ``tti.parallel.streams``).

One capture thread per camera pushes frames into its ``FrameRing``
(``tti_torch.native``: C++ seqlock ring, copies outside the GIL); the feed
loop snapshots the freshest frame of every stream straight into the
pipeline's pinned staging buffer and runs the shared ``InspectionPipeline``
step; the temporal smoothing state is carried per stream, on the pipeline's
device. The rings always hold the freshest frame, so a slow step drops
frames instead of building a queue, which is what a live line wants.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from tti_torch.app.sources import FrameSource
from tti_torch.core.logging import get_logger
from tti_torch.measure.pipeline import init_measure_state, smooth_measurement
from tti_torch.native import FrameRing, gather_batch

log = get_logger("parallel.streams")


@dataclass
class StreamStats:
    captured: int = 0
    processed_batches: int = 0
    dropped_reads: int = 0


class StreamWorker:
    """Capture thread: FrameSource -> FrameRing."""

    def __init__(self, source: FrameSource, frame_shape: tuple[int, int, int],
                 ring_capacity: int = 8, native: bool | None = None) -> None:
        self.source = source
        self.ring = FrameRing(ring_capacity, frame_shape, native=native)
        self.stats = StreamStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tti-stream-capture")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            ok, frame = self.source.read()
            if not ok or frame is None:
                self.stats.dropped_reads += 1
                if self.stats.dropped_reads % 100 == 99:
                    self.source.reconnect()
                time.sleep(0.005)
                continue
            self.ring.push(frame)
            self.stats.captured += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.source.release()


class MultiStreamRunner:
    """S capture workers and one shared device pipeline, with per-stream
    smoothing. ``native`` is passed to every ring (True: the C++ ring or an
    error; None: the C++ ring when a compiler is found)."""

    def __init__(self, pipeline, sources: Sequence[FrameSource], frame_hw: tuple[int, int],
                 ring_capacity: int = 8, native: bool | None = None) -> None:
        self.pipeline = pipeline
        shape = (frame_hw[0], frame_hw[1], 3)
        self.workers = [StreamWorker(s, shape, ring_capacity, native) for s in sources]
        self.frame_hw = frame_hw
        self.measure_states = [
            init_measure_state(pipeline.measure_cfg.frame_buffer, device=pipeline.device)
            for _ in sources
        ]
        self.batches = 0
        self._inflight: dict | None = None  # device results of the step not yet read

    def start(self) -> None:
        for w in self.workers:
            w.start()

    def wait_for_frames(self, timeout_s: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(w.ring.head() > 0 for w in self.workers):
                return True
            time.sleep(0.01)
        return False

    def assemble_batch(self) -> np.ndarray:
        """One freshest frame per stream, stream-major (S, H, W, 3), gathered
        by one native call into the pipeline's staging buffer (pinned on a
        CUDA device), which ``process_batch_async`` uploads as it is. A ring
        that has no frame yet leaves its slot as it was."""
        shape = (len(self.workers), self.frame_hw[0], self.frame_hw[1], 3)
        batch = self.pipeline.staging_batch(shape)
        gather_batch([w.ring for w in self.workers], batch)
        return batch

    def _finish(self, inflight: dict):
        """Read one step's results and do the per-stream bookkeeping, for
        the blocking and the pipelined path alike. The smoothing reads the
        device-side measurement (each field sliced per stream), so it costs
        no upload."""
        outs = self.pipeline.outputs_to_host(inflight)
        results = []
        meas = inflight.get("measurements")
        if meas is not None:
            for i in range(len(self.workers)):
                per = dataclasses.replace(meas, **{f.name: getattr(meas, f.name)[i]
                                                   for f in dataclasses.fields(meas)})
                self.measure_states[i], smoothed = smooth_measurement(self.measure_states[i], per)
                results.append(smoothed)
        self.batches += 1
        for w in self.workers:
            w.stats.processed_batches += 1
        return outs, results

    def step(self):
        """One blocking device step over all streams: (raw outputs,
        per-stream smoothed measurements)."""
        return self._finish(self.pipeline.process_batch_async(self.assemble_batch()))

    def step_pipelined(self):
        """Double-buffered step: dispatch this batch without blocking, then
        read the previous batch's results, so the ring snapshot, the upload
        and the host bookkeeping overlap the device's work on the batch in
        flight. Returns None on the first call (nothing in flight yet);
        :meth:`flush` drains the last batch."""
        inflight = self.pipeline.process_batch_async(self.assemble_batch())
        prev, self._inflight = self._inflight, inflight
        return None if prev is None else self._finish(prev)

    def flush(self):
        """Read the last batch in flight (pipelined mode)."""
        prev, self._inflight = self._inflight, None
        return None if prev is None else self._finish(prev)

    def run(self, num_batches: int, interval_s: float = 0.0) -> list:
        out = []
        for _ in range(num_batches):
            out.append(self.step())
            if interval_s:
                time.sleep(interval_s)
        return out

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
