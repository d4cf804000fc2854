"""The closed loop, one batch deep, over the program's host API.

Each turn hands batch i + 1 to the program, then reads batch i's results
back to the host (``InspectionPipeline.outputs_to_host``). Two feeds, by
the traffic file's ``feed``:

- ``host``: the frames sit in the program's own two pinned staging buffers
  (``InspectionPipeline.staging_batch``), filled at set-up; each batch is
  ``process_batch_async`` on one of them, so every batch crosses the host
  link and no host copy of frames runs in the loop;
- ``resident``: two batches uploaded at set-up stay on the card; each batch
  is ``InspectionPipeline.step`` on one of them.

Batch i uses buffer ``i % 2``. A traced segment also keeps every hand-over
and read-back as a span of the host clock (``bench.dispatch``,
``bench.read``), to name the device's idle gaps by.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    """Host-clock times (s, ``time.perf_counter``) of one batch."""

    index: int
    handed: float
    dispatched: float
    read: float = 0.0


@dataclass
class LoopResult:
    records: list[Record] = field(default_factory=list)  # batches read back
    kept: list[tuple[int, int, object]] = field(default_factory=list)  # (buffer, frame, outputs)


class Feed:
    """The program and its two batches of frames, as ``feed`` hands them."""

    def __init__(self, pipeline, frames: list[np.ndarray], feed: str) -> None:
        import torch

        self.pipeline = pipeline
        if feed == "host":
            self.buffers = []
            for batch in frames:
                buf = pipeline.staging_batch(batch.shape)
                np.copyto(buf, batch)
                self.buffers.append(buf)
            self._hand = pipeline.process_batch_async
        elif feed == "resident":
            self.buffers = [torch.from_numpy(b).to(pipeline.device) for b in frames]
            self._hand = pipeline.step
        else:
            raise ValueError(f"feed must be 'host' or 'resident', got {feed!r}")

    def refill(self, frames: list[np.ndarray]) -> None:
        """The same two buffers, with new frames."""
        import torch

        for buf, batch in zip(self.buffers, frames):
            if isinstance(buf, np.ndarray):
                np.copyto(buf, batch)
            else:
                buf.copy_(torch.from_numpy(batch))

    def hand(self, i: int):
        return self._hand(self.buffers[i % 2])

    def read(self, outs):
        return self.pipeline.outputs_to_host(outs)


def run_loop(feed: Feed, *, seconds: float | None = None, batches: int | None = None,
             keep=None, first: int = 0, spans: list | None = None) -> LoopResult:
    """Run the loop for ``seconds`` (the batches read back by then count;
    the one in flight is drained and not counted) or for ``batches``
    batches. ``keep(record, outputs)`` may return frames of the batch to
    keep as ``(buffer, frame, outputs)``. Batch numbers start at
    ``first``. ``spans``, where given, gets ``(name, start s, end s)`` of
    every hand-over and read-back."""
    out = LoopResult()
    end = None if seconds is None else time.perf_counter() + seconds
    i, pending = first, None
    while True:
        t_hand = time.perf_counter()
        outs = feed.hand(i)
        rec = Record(i, t_hand, time.perf_counter())
        if spans is not None:
            spans.append(("bench.dispatch", rec.handed, rec.dispatched))
        if pending is not None:
            prev_rec, prev_outs = pending
            host = feed.read(prev_outs)
            prev_rec.read = time.perf_counter()
            if spans is not None:
                spans.append(("bench.read", rec.dispatched, prev_rec.read))
            if end is not None and prev_rec.read > end:
                pending = (rec, outs)
                break
            out.records.append(prev_rec)
            if keep is not None:
                out.kept.extend(keep(prev_rec, host))
            if batches is not None and len(out.records) >= batches:
                pending = (rec, outs)
                break
        pending = (rec, outs)
        i += 1
    t_read = time.perf_counter()
    feed.read(pending[1])  # drained: past the window, not counted
    if spans is not None:
        spans.append(("bench.read", t_read, time.perf_counter()))
    return out
