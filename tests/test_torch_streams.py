"""The port's frame ring (tti_torch.native), sources and multi-stream runner
(tti_torch.parallel.streams), tested as tests/test_native.py and
tests/test_streams.py test tti's, and held to tti's where there is a value
to compare.
"""

import threading

import numpy as np
import pytest

import tti.app.sources as jsources
from tti.native import FrameRing as JaxSideRing
from tti_torch.app.sources import SyntheticSource, frames_iter
from tti_torch.core.logging import StageTimer, get_logger
from tti_torch.native import BUILD_DIR, FrameRing, _load_library, gather_batch
from tti_torch.parallel.streams import MultiStreamRunner
from tests.torch_pair import pipelines

SHAPE = (8, 12, 3)


@pytest.fixture(params=["native", "python"])
def ring(request):
    if request.param == "native":
        if _load_library() is None:
            pytest.skip("no compiler for the native ring")
        return FrameRing(4, SHAPE, native=True)
    return FrameRing(4, SHAPE, native=False)


def _frame(value):
    return np.full(SHAPE, value, np.uint8)


def test_library_is_built_into_the_build_directory():
    if _load_library() is None:
        pytest.skip("no compiler for the native ring")
    assert list(BUILD_DIR.glob("libtti_framering_*.so"))
    assert FrameRing(2, SHAPE, native=True).native and not FrameRing(2, SHAPE, native=False).native


def test_push_snapshot_order(ring):
    for v in range(3):
        ring.push(_frame(v))
    batch = ring.snapshot(3)
    assert batch.shape == (3, *SHAPE)
    assert [int(batch[i, 0, 0, 0]) for i in range(3)] == [0, 1, 2]


def test_overwrite_keeps_newest_like_tti(ring):
    other = JaxSideRing(4, SHAPE, native=False)
    for v in range(7):  # capacity 4 keeps 3, 4, 5, 6
        ring.push(_frame(v))
        other.push(_frame(v))
    batch = ring.snapshot(4)
    assert [int(b[0, 0, 0]) for b in batch] == [3, 4, 5, 6]
    np.testing.assert_array_equal(batch, other.snapshot(4))
    assert ring.head() == other.head() == 7 and ring.dropped() == other.dropped() == 3


def test_snapshot_fewer_than_requested(ring):
    ring.push(_frame(9))
    batch = ring.snapshot(4)
    assert batch.shape[0] == 1 and int(batch[0, 0, 0, 0]) == 9


def test_wrong_frame_size_rejected(ring):
    with pytest.raises(ValueError):
        ring.push(np.zeros((2, 2), np.uint8))


def test_concurrent_producer_consumer():
    if _load_library() is None:
        pytest.skip("no compiler for the native ring")
    ring = FrameRing(8, SHAPE, native=True)
    stop = threading.Event()
    errors = []

    def producer():
        v = 0
        while not stop.is_set():
            ring.push(_frame(v % 251))
            v += 1

    def consumer():
        for _ in range(2000):
            for frame in ring.snapshot(4):
                if frame.min() != frame.max():  # every frame is uniform: no torn copies
                    errors.append("torn frame")
                    return

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    consumer()
    stop.set()
    t.join(timeout=2)
    assert not errors and ring.head() > 0


@pytest.mark.parametrize("native", [True, False])
def test_gather_batch(native):
    if native and _load_library() is None:
        pytest.skip("no compiler for the native ring")
    rings = [FrameRing(4, SHAPE, native=native) for _ in range(3)]
    rings[0].push(_frame(10))
    rings[2].push(_frame(30))
    out = np.zeros((3, *SHAPE), np.uint8)
    assert gather_batch(rings, out) == 0b101
    assert out[0, 0, 0, 0] == 10 and out[2, 0, 0, 0] == 30
    assert out[1].sum() == 0  # an empty ring leaves its slot untouched


def test_synthetic_source_matches_tti():
    got, ref = SyntheticSource(6, 8, seed=3, count=2), jsources.SyntheticSource(6, 8, seed=3, count=2)
    for _ in range(2):
        (ok_a, a), (ok_b, b) = got.read(), ref.read()
        assert ok_a and ok_b
        np.testing.assert_array_equal(a, b)
    assert got.read() == (False, None)
    assert len(list(frames_iter(SyntheticSource(6, 8, seed=1, count=3)))) == 3


def test_logging_and_stage_timer():
    assert get_logger("native").name == "tti_torch.native"
    timer = StageTimer()
    with timer.stage("a"):
        pass
    timer.record("a", 0.5)
    s = timer.summary()["a"]
    assert s["n"] == 2 and s["total_s"] >= 0.5


class RepeatingSource:
    """One fixed frame, for ever."""

    def __init__(self, frame):
        self.frame = frame

    def read(self):
        return True, self.frame

    def reconnect(self): ...

    def release(self): ...


def _runner(ref_intrinsics, sources, calibrated, native=None):
    pipe, _, _ = pipelines("headline", ref_intrinsics, calibrated=calibrated)
    return MultiStreamRunner(pipe, sources, pipe.frame_hw, native=native), pipe


def test_four_stream_line(ref_intrinsics):
    """As tests/test_streams.py: four synthetic cameras through one pipeline,
    blocking steps, then the pipelined protocol (None, previous, flush)."""
    sources = [SyntheticSource(216, 384, seed=i) for i in range(4)]
    runner, pipe = _runner(ref_intrinsics, sources, calibrated=False)
    runner.start()
    try:
        assert runner.wait_for_frames(timeout_s=10.0)
        results = runner.run(num_batches=3)
        assert len(results) == 3
        outs, res = results[-1]
        assert outs.boxes_frame.shape == (4, pipe.model_cfg.max_detections, 4)
        assert res == []  # no calibration: detection only, nothing to smooth
        assert all(w.stats.captured > 0 for w in runner.workers)
        assert runner.step_pipelined() is None
        outs1, res1 = runner.step_pipelined()
        assert outs1.boxes_frame.shape == (4, pipe.model_cfg.max_detections, 4) and res1 == []
        assert runner.flush() is not None
        assert runner.flush() is None  # nothing left in flight
        assert runner.batches == 3 + 2
        assert all(w.stats.processed_batches == 5 for w in runner.workers)
    finally:
        runner.stop()


def test_pipelined_equals_blocking_on_a_fixed_frame(ref_intrinsics):
    """Sources that repeat one frame each: every batch is the same, so the
    pipelined results equal the blocking ones, and equal process_batch on
    that batch; the per-stream median smoothing carries its own state."""
    from tests.torch_synth import textile_frames

    frames = textile_frames(2, 216, 384, seed=5)
    runner, pipe = _runner(ref_intrinsics, [RepeatingSource(f) for f in frames], calibrated=True)
    want = pipe.process_batch(frames)
    assert np.isfinite(want.measurements.raw_width_mm).any()
    runner.start()
    try:
        assert runner.wait_for_frames(timeout_s=10.0)
        blocking, smoothed = runner.step()
        assert runner.step_pipelined() is None
        piped, smoothed_2 = runner.step_pipelined()
        last, smoothed_3 = runner.flush()
    finally:
        runner.stop()
    for outs in (blocking, piped, last):
        np.testing.assert_array_equal(outs.valid, want.valid)
        np.testing.assert_array_equal(outs.boxes_frame, want.boxes_frame)
        np.testing.assert_array_equal(outs.measurements.raw_edge_mm, want.measurements.raw_edge_mm)
        np.testing.assert_array_equal(outs.measurements.raw_width_mm,
                                      want.measurements.raw_width_mm)
    assert len(smoothed) == len(smoothed_3) == 2
    for i in range(2):
        # A constant input: the median of the window is the raw value.
        for res in (smoothed, smoothed_2, smoothed_3):
            np.testing.assert_allclose(float(res[i].stitch_width_mm),
                                       want.measurements.raw_width_mm[i], equal_nan=True)
        assert int(runner.measure_states[i].width_n) == (
            3 if np.isfinite(want.measurements.raw_width_mm[i]) else 0)
        assert runner.measure_states[i].dist_buf.device == pipe.device
