"""The camera tools of both command lines, ``capture``, ``view`` and
``tune-camera``, on a scripted ``cv2.VideoCapture`` with a headless
``imshow`` / ``waitKey`` (and ``namedWindow`` / ``createTrackbar``): the
same files with the same bytes and names, the same printed lines, the same
calls on the camera and the windows, and the same exit code, also on an
unknown property and on a camera that stops giving frames.

Then ``bench`` of the port: it exists with tti's flags and exits 1 naming
its ROADMAP item.
"""

import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from tti.cli.__main__ import main as tti_main  # noqa: E402
from tti_torch.cli.__main__ import main as port_main  # noqa: E402


class Script:
    """What the fake camera gives and what the fake windows answer, and a
    record of every call. ``reads``: True for a frame, False for a failed
    read (then frames forever); ``quit_at``: the ``waitKey`` call that
    returns 'q'."""

    def __init__(self, reads, quit_at=None):
        self.reads, self.quit_at = list(reads), quit_at
        self.calls, self.keys = [], 0
        self.rng = np.random.default_rng(3)

    def read(self):
        ok = self.reads.pop(0) if self.reads else True
        if not ok:
            self.calls.append(("read", False))
            return False, None
        frame = self.rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        self.calls.append(("read", int(frame.sum())))
        return True, frame

    def wait_key(self, delay):
        self.keys += 1
        self.calls.append(("waitKey", delay))
        return ord("q") if self.keys == self.quit_at else -1


def _install(monkeypatch, script):
    class FakeCapture:
        def __init__(self, index, api=None):
            self.props = {}
            script.calls.append(("open", index, api))

        def set(self, prop, value):
            script.calls.append(("set", prop, float(value)))
            self.props[prop] = float(value)
            return True

        def get(self, prop):
            return self.props.get(prop, {cv2.CAP_PROP_FRAME_WIDTH: 64.0,
                                         cv2.CAP_PROP_FRAME_HEIGHT: 48.0}.get(prop, 0.0))

        def read(self):
            return script.read()

        def release(self):
            script.calls.append(("release",))

    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    monkeypatch.setattr(cv2, "imshow",
                        lambda window, frame: script.calls.append(("imshow", window)))
    monkeypatch.setattr(cv2, "waitKey", script.wait_key)
    monkeypatch.setattr(cv2, "destroyAllWindows",
                        lambda: script.calls.append(("destroyAllWindows",)))
    monkeypatch.setattr(cv2, "namedWindow", lambda w: script.calls.append(("namedWindow", w)))
    monkeypatch.setattr(cv2, "createTrackbar",
                        lambda name, w, v, top, cb: script.calls.append(
                            ("createTrackbar", name, w, v, top)))


@pytest.fixture
def camera(monkeypatch, tmp_path):
    """Both CLIs against one scripted camera each, from their own working
    directories: ``run(main, argv, reads, quit_at) -> (rc, stdout lines,
    calls, files)``."""
    monkeypatch.setenv("CAMERA_INDEX", "0")
    monkeypatch.setenv("CALIB_W", "64")
    monkeypatch.setenv("CALIB_H", "48")
    for name in ("TTI_COORDINATOR", "TTI_NUM_PROCESSES", "TTI_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the camera's 2 s settle
    monkeypatch.setattr(jax.config, "update", lambda *a: None)  # tti's compile cache

    def run(main, tag, argv, reads=(), quit_at=None, capsys=None):
        work = tmp_path / tag
        work.mkdir()
        monkeypatch.chdir(work)
        script = Script(reads, quit_at)
        _install(monkeypatch, script)
        rc = main(argv)
        out = capsys.readouterr().out.splitlines() if capsys else []
        files = {p.relative_to(work).as_posix(): p.read_bytes()
                 for p in sorted(work.rglob("*")) if p.is_file()}
        return rc, out, script.calls, files

    return run


def _both(camera, capsys, argv, **kw):
    ours = camera(port_main, "port", argv, capsys=capsys, **kw)
    theirs = camera(tti_main, "tti", argv, capsys=capsys, **kw)
    return ours, theirs


def test_capture_equals_tti(camera, capsys):
    ours, theirs = _both(camera, capsys, ["capture", "--out", "shots", "--interval", "0",
                                          "--max-frames", "3"], reads=[True, False, True])
    assert ours == theirs
    rc, out, calls, files = ours
    assert rc == 0 and out == [f"saved shots/capture_0000{i}.jpg" for i in range(3)]
    assert list(files) == [f"shots/capture_0000{i}.jpg" for i in range(3)]
    assert calls[-1] == ("release",) and [c for c in calls if c[0] == "read"][1] == ("read", False)


@pytest.mark.parametrize("reads,quit_at,rc", [((), 3, 0), ((True, False), 5, 1)])
def test_view_equals_tti(camera, capsys, reads, quit_at, rc):
    """'q' on the third key ends with 0; a failed read ends with 1."""
    ours, theirs = _both(camera, capsys, ["view"], reads=reads, quit_at=quit_at)
    assert ours == theirs
    assert ours[0] == rc
    calls = ours[2]
    assert ("imshow", "tti view (q to quit)") in calls
    assert calls[-2:] == [("release",), ("destroyAllWindows",)]


def test_tune_camera_set_equals_tti(camera, capsys):
    ours, theirs = _both(camera, capsys, ["tune-camera", "--set", "exposure=5", "gain=2.5"])
    assert ours == theirs
    rc, out, calls, _ = ours
    assert rc == 0 and out == ["exposure = 5.0", "gain = 2.5"]
    assert ("set", cv2.CAP_PROP_GAIN, 2.5) in calls and calls[-1] == ("release",)


def test_tune_camera_unknown_property_equals_tti(camera, capsys):
    ours, theirs = _both(camera, capsys, ["tune-camera", "--set", "exposure=4", "focus=1"])
    assert ours == theirs
    rc, out, _, _ = ours
    assert rc == 1 and out == ["exposure = 4.0", "unknown property 'focus'; choose from "
                               "['brightness', 'contrast', 'exposure', 'gain']"]


def test_tune_camera_window_equals_tti(camera, capsys):
    """The trackbar window: four trackbars, then reads that fail are
    skipped until 'q'."""
    ours, theirs = _both(camera, capsys, ["tune-camera"], reads=[False, True, False],
                         quit_at=4)
    assert ours == theirs
    calls = ours[2]
    assert ours[0] == 0
    assert [c[1] for c in calls if c[0] == "createTrackbar"] == [
        "exposure", "brightness", "contrast", "gain"]
    assert ("namedWindow", "tti tune-camera (q to quit)") in calls
    assert sum(c[0] == "waitKey" for c in calls) == 4


@pytest.mark.parametrize("argv", [["bench"]])
def test_bench_and_tune_device_name_their_roadmap_items(argv, monkeypatch):
    """``bench`` runs ``bench_torch.main`` (``tests/test_torch_bench.py``
    holds it to ``bench.py``) and exits 0, as ``tti``'s runs ``bench.main``;
    ``tune-device`` is served too (``tests/test_torch_tune_device.py``)."""
    import bench_torch

    calls = []
    monkeypatch.setattr(bench_torch, "main", lambda: calls.append("main"))
    assert port_main(argv) == 0
    assert calls == ["main"]
