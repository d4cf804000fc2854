"""The port's calibration (``tti_torch.calib.pnp``, ``.charuco``,
``.intrinsics``, the startup gate and the ``calibrate-intrinsics`` and
``run`` commands) against tti's, on synthetically rendered boards.

- PnP: the same float64 code, so rvec/tvec within 1e-9 and rms within 1e-9 px.
- Detection: corners and ids equal (the same OpenCV calls on the same image).
- Extrinsics files: byte-equal JSON.
- Intrinsics: the same cv2.calibrateCamera on the same detections, K within
  1e-6 relative.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import tti.app.orchestrator as jorch
import tti.calib.charuco as jcharuco
import tti.calib.intrinsics as jintr
import tti.calib.pnp as jpnp
import tti.core.config as jcfg
import tti_torch.app.orchestrator as torch_orch
import tti_torch.app.sources as sources
import tti_torch.calib.charuco as tcharuco
import tti_torch.calib.intrinsics as tintr
import tti_torch.calib.pnp as tpnp
import tti_torch.core.config as tcfg
from tti_torch.calib.io import load_extrinsics, save_extrinsics, save_intrinsics
from tti_torch.cli.__main__ import main as port_main
from tti_torch.core.errors import CalibrationError

REPO = Path(__file__).resolve().parents[1]
K_VIEW = np.array([[900.0, 0, 640.0], [0, 900.0, 480.0], [0, 0, 1.0]])
RVEC_VIEW = np.array([0.1, -0.15, 0.05])
TVEC_VIEW = np.array([-0.03, -0.02, 0.25])


@pytest.fixture(autouse=True)
def cv2_one_thread():
    """OpenCV on one thread for each test: with its thread pool,
    calibrateCamera's sums run in another order from call to call (1e-6
    relative apart on the same views), and both packages call it."""
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        yield
    finally:
        cv2.setNumThreads(threads)


@pytest.fixture(scope="module")
def boards():
    return tcharuco.create_charuco_board(), jcharuco.create_charuco_board(jcfg.BoardConfig())


def render_board_view(board, K, rvec, tvec, hw=(960, 1280)):
    """The board at a known pose through a zero-distortion camera, written
    pre-inverted (the detector inverts), as tests/test_charuco.py renders it."""
    cfg = board.config
    px_per_m = 8000
    bw = int(cfg.squares_y * cfg.square_length_m * px_per_m)
    bh = int(cfg.squares_x * cfg.square_length_m * px_per_m)
    img = board.board.generateImage((bw, bh), marginSize=0, borderBits=1)
    R, _ = cv2.Rodrigues(rvec)
    H = K @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ np.diag([1.0 / px_per_m, 1.0 / px_per_m,
                                                                   1.0])
    view = cv2.warpPerspective(img, H, (hw[1], hw[0]), flags=cv2.INTER_LINEAR, borderValue=255)
    return cv2.bitwise_not(view)


@pytest.fixture(scope="module")
def view(boards):
    return render_board_view(boards[0], K_VIEW, RVEC_VIEW, TVEC_VIEW)


def intrinsic_views(board, n=16, hw=(960, 1280), K=None):
    """Board views at diverse poses (tests/test_charuco.py's sweep)."""
    K = np.array([[880.0, 0, 640.0], [0, 880.0, 480.0], [0, 0, 1.0]]) if K is None else K
    rng = np.random.default_rng(3)
    frames = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        tilt = 0.35 + 0.15 * rng.uniform()
        rvec = np.array([tilt * np.cos(ang), tilt * np.sin(ang), 0.0]) + rng.normal(scale=0.05,
                                                                                   size=3)
        depth = 0.18 + 0.1 * rng.uniform()
        tvec = np.array([-0.03 + 0.02 * rng.uniform(), -0.025 + 0.02 * rng.uniform(), depth])
        frames.append(render_board_view(board, K, rvec, tvec, hw))
    return frames


def _board_points(nx=5, ny=4, square=0.01):
    xs, ys = np.meshgrid(np.arange(nx) * square, np.arange(ny) * square)
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(nx * ny)], axis=-1)


@pytest.mark.parametrize("noise_px", [0.0, 0.3])
def test_solve_pnp_planar_equals_tti(ref_intrinsics, ref_extrinsics, noise_px):
    """tests/test_pnp.py's board through both solvers: the same float64 code."""
    K, dist = ref_intrinsics
    obj = _board_points()
    img, _ = cv2.projectPoints(obj, *ref_extrinsics, K, dist)
    img = img.reshape(-1, 2) + np.random.default_rng(0).normal(scale=noise_px, size=(len(obj), 2))
    valid = np.ones(len(obj))
    valid[3] = 0.0  # a padding row
    for kw in ({}, {"valid": valid}):
        got = tpnp.solve_pnp_planar(obj, img, K, dist, **kw)
        want = jpnp.solve_pnp_planar(obj, img, K, dist, **kw)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
        assert abs(got[2] - want[2]) < 1e-9
    rvec, tvec, rms = tpnp.solve_pnp_planar(obj, img, K, dist)
    assert np.abs(tvec - ref_extrinsics[1]).max() < (1e-6 if noise_px == 0 else 1e-3)


def test_rotation_to_rvec_equals_tti():
    """Random rotations, and the theta ~ 0 and theta ~ pi branches."""
    rng = np.random.default_rng(1)
    rots = [cv2.Rodrigues(rng.normal(size=3))[0] for _ in range(20)]
    rots += [np.eye(3), cv2.Rodrigues(np.array([np.pi, 0, 0]))[0],
             cv2.Rodrigues(np.array([0, np.pi - 1e-9, 0]))[0]]
    for R in rots:
        np.testing.assert_allclose(tpnp.rotation_to_rvec(R), jpnp.rotation_to_rvec(R), atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(cv2.Rodrigues(tpnp.rotation_to_rvec(R))[0], R, atol=1e-6)


def test_create_charuco_board_geometry_equals_tti(boards):
    """The reference's (squares_y, squares_x) order: the same corner template."""
    port, ref = boards
    np.testing.assert_array_equal(port.chessboard_corners(), ref.chessboard_corners())
    assert port.chessboard_corners().shape == (20, 3)


def test_detect_charuco_equals_tti(boards, view):
    got = tcharuco.detect_charuco(boards[0], view)
    want = jcharuco.detect_charuco(boards[1], view)
    assert got is not None and len(got[1]) >= boards[0].config.min_corners
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tcharuco.detect_charuco(boards[0], np.full((480, 640), 255, np.uint8)) is None


@pytest.mark.parametrize("solver", ["tti", "cv2"])
def test_solve_board_pose_equals_tti(boards, view, solver):
    """Both solvers against tti's (1e-9) and against the render's pose (3 mm,
    1 degree, as tests/test_charuco.py holds tti)."""
    corners, ids = tcharuco.detect_charuco(boards[0], view)
    rv, tv, rms = tcharuco.solve_board_pose(boards[0], corners, ids, K_VIEW, np.zeros(5),
                                            solver=solver)
    jrv, jtv, jrms = jcharuco.solve_board_pose(boards[1], corners, ids, K_VIEW, np.zeros(5),
                                               solver=solver)
    np.testing.assert_allclose(rv, jrv, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tv, jtv, atol=1e-9, rtol=0)
    assert abs(rms - jrms) < 1e-9 and rms < 1.0
    assert np.abs(tv - TVEC_VIEW).max() < 0.003
    R_err = cv2.Rodrigues(rv)[0] @ cv2.Rodrigues(RVEC_VIEW)[0].T
    assert np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1))) < 1.0


def test_run_extrinsic_calibration_writes_tti_bytes(boards, view, tmp_path):
    clock = lambda: iter(np.arange(0, 100, 0.5))
    paths = []
    for mod, board, name in ((tcharuco, boards[0], "port.json"), (jcharuco, boards[1], "tti.json")):
        ticks = clock()
        assert mod.run_extrinsic_calibration([view] * 30, K_VIEW, np.zeros(5),
                                             str(tmp_path / name), board=board,
                                             capture_delay_s=2.0,
                                             clock=lambda: float(next(ticks)))
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    blank = np.full((480, 640), 255, np.uint8)
    assert not tcharuco.run_extrinsic_calibration([blank] * 3, K_VIEW, np.zeros(5),
                                                  str(tmp_path / "e.json"), board=boards[0])
    assert not (tmp_path / "e.json").exists()


def test_calibrate_intrinsics_equals_tti(boards, tmp_path):
    frames = intrinsic_views(boards[0])
    got = tintr.calibrate_intrinsics(frames, board=boards[0], output_path=str(tmp_path / "p.json"))
    want = jintr.calibrate_intrinsics(frames, board=boards[1], output_path=str(tmp_path / "t.json"))
    assert got.n_views == want.n_views >= 5 and got.image_size == want.image_size
    np.testing.assert_allclose(got.K, want.K, rtol=1e-6)
    np.testing.assert_allclose(got.dist, want.dist, rtol=1e-6, atol=1e-9)
    assert got.rms == pytest.approx(want.rms, rel=1e-6)
    assert abs(got.K[0, 0] - 880.0) / 880.0 < 0.05
    p, t = (json.loads((tmp_path / n).read_text()) for n in ("p.json", "t.json"))
    assert p.keys() == t.keys() == {"camera_matrix", "dist_coeffs", "rms", "image_size"}
    with pytest.raises(CalibrationError):
        tintr.calibrate_intrinsics([np.full((480, 640), 255, np.uint8)] * 5, board=boards[0])


class ListSource:
    """A camera that returns ``frames`` once, then reads fail."""

    def __init__(self, frames):
        self.frames, self.i = list(frames), 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def reconnect(self):
        pass

    def release(self):
        pass


def _gate_configs(tmp_path):
    files = dict(intrinsics_file=str(tmp_path / "camera_calibration.json"),
                 extrinsics_file=str(tmp_path / "extrinsics.json"))
    return (tcfg.AppConfig(runtime=tcfg.RuntimeConfig(**files)),
            jcfg.AppConfig(runtime=jcfg.RuntimeConfig(**files)))


@pytest.mark.parametrize("intrinsics,stale,board,expect", [
    (True, False, True, True),
    (True, True, False, True),
    (False, True, True, True),
    (True, False, False, False),
], ids=["success", "stale_fallback", "no_intrinsics_extrinsics_on_disk", "failure"])
def test_startup_gate_outcomes_equal_tti(view, tmp_path, intrinsics, stale, board, expect):
    """The four outcomes of run_startup_calibration, port and tti on the same
    frames and files; the extrinsics file after each gate is byte-equal."""
    blank = np.full((960, 1280, 3), 255, np.uint8)
    frames = [view] * 3 if board else [blank] * 3
    results, written = [], []
    for gate, cfg in zip((torch_orch.run_startup_calibration, jorch.run_startup_calibration),
                         _gate_configs(tmp_path)):
        rt = cfg.runtime
        for path in (rt.intrinsics_file, rt.extrinsics_file):
            if (tmp_path / path).exists():
                (tmp_path / path).unlink()
        if intrinsics:
            save_intrinsics(K_VIEW, np.zeros(5), rt.intrinsics_file, image_size=(1280, 960))
        if stale:
            save_extrinsics(np.zeros(3), np.array([0.0, 0.0, 0.5]), rt.extrinsics_file)
        results.append(gate(cfg, ListSource(frames)))
        exists = (tmp_path / rt.extrinsics_file).exists()
        written.append((tmp_path / rt.extrinsics_file).read_bytes() if exists else None)
    assert results == [expect, expect]
    assert written[0] == written[1]
    if board:
        rvec, tvec = load_extrinsics(str(tmp_path / "extrinsics.json"))
        if intrinsics:
            assert np.abs(tvec - TVEC_VIEW).max() < 0.003  # fresh extrinsics
        else:
            assert tvec[2] == 0.5  # no intrinsics: the file on disk is used as it is
    elif stale:
        assert load_extrinsics(str(tmp_path / "extrinsics.json"))[1][2] == 0.5


def test_calibrate_intrinsics_cli_equals_tti(boards, tmp_path, monkeypatch, capsys):
    """``calibrate-intrinsics --images DIR`` in both CLIs on the same PNGs:
    exit 0, an rms printed, K within 1e-6 relative."""
    from tti.cli.__main__ import main as tti_main

    images = tmp_path / "views"
    images.mkdir()
    for i, frame in enumerate(intrinsic_views(boards[0], n=8)):
        cv2.imwrite(str(images / f"view_{i:02d}.png"), frame)
    monkeypatch.chdir(tmp_path)
    for main, out in ((port_main, "port.json"), (tti_main, "tti.json")):
        assert main(["calibrate-intrinsics", "--images", str(images), "--out", out]) == 0
        assert "RESULT: rms=" in capsys.readouterr().out
    got, want = (json.loads((tmp_path / n).read_text()) for n in ("port.json", "tti.json"))
    np.testing.assert_allclose(got["camera_matrix"], want["camera_matrix"], rtol=1e-6)
    assert got["image_size"] == want["image_size"] == [1280, 960]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_run_cli_on_a_camera_calibrates_first(boards, ref_intrinsics, tmp_path, monkeypatch):
    """``run`` on a camera without ``--skip-calibration``: the gate reads the
    camera's board views until a read fails, writes the extrinsics, and the
    loop then measures from the same camera with them."""
    from tests.torch_synth import textile_frames

    monkeypatch.chdir(tmp_path)
    K = K_VIEW.copy()
    K[:2] *= 0.25
    save_intrinsics(K, np.zeros(5), "camera_calibration.json", image_size=(320, 240))
    weights = str(REPO / "checkpoints" / "yolov8n_textile_cam.msgpack")
    (tmp_path / ".env").write_text(
        f"TTI_WEIGHTS={weights}\nTTI_SQLITE_PATH=line.db\nCALIB_W=320\nCALIB_H=240\n"
        "TTI_IMAGE_SIZE=256\nROI_Y_MIN=60\nROI_Y_MAX=200\n")
    views = [render_board_view(boards[0], K, RVEC_VIEW, np.array([-0.03, -0.02, 0.08]),
                               hw=(240, 320))] * 3
    camera = ListSource([*views, None, *textile_frames(2, 240, 320, seed=5)])
    camera.read = _failing_once(camera.read)
    monkeypatch.setattr(sources, "OpenCVCameraSource", lambda cfg, index=None: camera)
    handler = _Records()
    logger = logging.getLogger("tti_torch.app.orchestrator")
    logger.addHandler(handler)
    try:
        assert port_main(["run", "--max-frames", "1", "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(handler)
    said = [r.getMessage() for r in handler.records]
    assert "calibration complete" in said and said.count("measurement") == 1
    rvec, tvec = load_extrinsics("extrinsics.json")
    assert np.abs(tvec - np.array([-0.03, -0.02, 0.08])).max() < 0.003


def _failing_once(read):
    """A read of the ``None`` frame fails (ends the gate's capture loop)."""
    def wrapped():
        ok, frame = read()
        return (ok and frame is not None), frame
    return wrapped
