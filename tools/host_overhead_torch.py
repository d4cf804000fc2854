"""Host-side cost of the multi-stream feed path, through the port
(``tti_torch``): the counterpart of ``tools/host_overhead.py``.

It times the stages of one batch of the feed loop
(``tti_torch.parallel.streams.MultiStreamRunner``), each on its own:

  1. ring snapshot: ``tti_torch.native.gather_batch``, the C++ seqlock copy
     of the freshest frame of each stream's ring into one contiguous
     (S, H, W, 3) batch (host memcpy);
  2. host postproc: the per-stream temporal smoothing of ``_finish``
     (``smooth_measurement``, on ``--device`` as the runner does it);
  3. H2D: the pinned host batch copied to the card, timed with CUDA events
     (``null`` with ``--device cpu``);
  4. device step: the headline step (``--imgsz``, bench.py's geometry, a
     fresh model's weights) at batch ``--streams`` on device-resident
     frames, the median of ``--iters`` synchronised steps;
     ``--device-step-ms`` replaces the measurement with a given figure.

The double-buffered feed (``step_pipelined``) overlaps the stages, so the
sustained batch period is the slowest of (host stages, H2D, device step);
``binding_stage`` names it.

Run: python tools/host_overhead_torch.py [--streams 4] [--iters 50] [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def time_ring_snapshot(streams: int, hw: tuple[int, int], iters: int) -> dict:
    from tti_torch.app.sources import SyntheticSource
    from tti_torch.native import gather_batch
    from tti_torch.parallel.streams import StreamWorker

    h, w = hw
    workers = []
    for i in range(streams):
        sw = StreamWorker(SyntheticSource(height=h, width=w, seed=i), (h, w, 3))
        # The ring filled synchronously (no capture thread), as tti's tool does.
        ok, frame = sw.source.read()
        assert ok
        sw.ring.push(frame)
        workers.append(sw)
    batch = np.zeros((streams, h, w, 3), np.uint8)
    rings = [sw.ring for sw in workers]
    gather_batch(rings, batch)  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        gather_batch(rings, batch)
    dt = (time.perf_counter() - t0) / iters
    return {"snapshot_ms": dt * 1e3, "snapshot_GBps": batch.nbytes / dt / 1e9,
            "batch_MB": batch.nbytes / 1e6}


def synthetic_measurements(streams: int, device):
    """tti's tool's per-stream measurement, stacked over the streams."""
    import torch

    from tti_torch.measure.pipeline import FrameMeasurement

    full = lambda v, dt: torch.full((streams,), v, dtype=dt, device=device)
    return FrameMeasurement(
        edge_distance_mm=full(float("nan"), torch.float32),
        stitch_width_mm=full(float("nan"), torch.float32),
        raw_edge_mm=full(4.2, torch.float32), raw_width_mm=full(3.3, torch.float32),
        n_dist=full(5, torch.int32), n_width=full(5, torch.int32),
        n_stitches=full(7, torch.int32), fabric_detected=full(True, torch.bool))


def smooth_streams(states: list, meas) -> tuple[list, list]:
    """One batch's smoothing, as ``MultiStreamRunner._finish`` does it: each
    stream's fields sliced from the stacked measurement, then its window."""
    from tti_torch.measure.pipeline import smooth_measurement

    new, smoothed = [], []
    for i, state in enumerate(states):
        per = dataclasses.replace(meas, **{f.name: getattr(meas, f.name)[i]
                                           for f in dataclasses.fields(meas)})
        state, out = smooth_measurement(state, per)
        new.append(state)
        smoothed.append(out)
    return new, smoothed


def time_host_postproc(streams: int, iters: int, device: str = "cpu") -> dict:
    """The smoothing of ``_finish`` over ``streams`` streams, per batch."""
    import torch

    from tti_torch.measure.pipeline import init_measure_state

    meas = synthetic_measurements(streams, device)
    states = [init_measure_state(device=device) for _ in range(streams)]
    states, _ = smooth_streams(states, meas)  # warm
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        states, _ = smooth_streams(states, meas)
    sync()
    return {"postproc_ms": (time.perf_counter() - t0) / iters * 1e3}


def time_h2d(streams: int, hw: tuple[int, int], iters: int, device: str) -> float | None:
    """Median ms of the pinned host batch's copy to the card (CUDA events);
    None on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    host = torch.empty((streams, *hw, 3), dtype=torch.uint8).pin_memory()
    host.numpy()[:] = np.random.default_rng(0).integers(0, 255, host.shape, dtype=np.uint8)
    dev = torch.empty(host.shape, dtype=torch.uint8, device=device)
    dev.copy_(host, non_blocking=True)  # warm
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_device_step(streams: int, hw: tuple[int, int], imgsz: int, iters: int,
                     device: str) -> float:
    """Median ms of the headline step at batch ``streams`` on frames
    already on ``device``, each step synchronised."""
    import torch

    from tools.tune_device_torch import build_pipeline

    pipe = build_pipeline(streams, imgsz, hw, "n", "bfloat16", device=device)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (streams, *hw, 3), dtype=np.uint8)).to(device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    for _ in range(2):
        pipe.step(frames)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pipe.step(frames)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--imgsz", type=int, default=640, help="the device step's model input size")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device-step-ms", type=float, default=None,
                    help="use this device step (ms per batch of --streams) instead of "
                         "measuring it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    hw = (args.height, args.width)

    snap = time_ring_snapshot(args.streams, hw, args.iters)
    post = time_host_postproc(args.streams, args.iters, args.device)
    h2d = time_h2d(args.streams, hw, args.iters, args.device)
    measured = args.device_step_ms is None
    step_ms = (time_device_step(args.streams, hw, args.imgsz, args.iters, args.device)
               if measured else args.device_step_ms)
    # step_pipelined overlaps the host stages, the upload and the device
    # step: the sustained batch period is the slowest of them.
    host_ms = snap["snapshot_ms"] + post["postproc_ms"]
    stages = {"host(snapshot)": host_ms, "h2d": h2d or 0.0, "device": step_ms}
    period = max(stages.values())
    out = {
        "streams": args.streams,
        **{k: round(v, 4) for k, v in snap.items()},
        **{k: round(v, 4) for k, v in post.items()},
        "h2d_ms_pinned": None if h2d is None else round(h2d, 4),
        "host_stages_ms": round(host_ms, 4),
        "device_step_ms": round(step_ms, 4),
        "device_step": "measured" if measured else "given",
        "sustained_fps": round(args.streams / period * 1e3, 2),
        "binding_stage": max(stages, key=stages.get),
        "device": args.device,
    }
    json.dump(out, sys.stdout)
    print()


if __name__ == "__main__":
    main()
