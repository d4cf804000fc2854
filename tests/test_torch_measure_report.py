"""``tools/measure_report_torch.py`` against ``tools/measure_report.py``.

- The tool's copy of the scene oracle renders byte-equal frames and equal
  truths for seed 0 (2 scenes), and its plane map equals the original's.
- The port's ``run_pipeline`` (CPU, float32) against tti's on those two
  full-size deploy scenes (1280x960, imgsz 960, the cam checkpoint,
  reference-native, and rectified: the two-pass undistort warp ahead of the
  model): per-frame raw_edge_mm / raw_width_mm within 1e-3 mm, as
  tests/torch_pair.py holds the step, NaN pattern and n_stitches equal
  (conftest sets jax_default_matmul_precision="highest").
- ``main``'s ``--paths`` and ``--dtype`` select among the four
  configurations.
"""

import gc
import json

import numpy as np
import pytest

pytest.importorskip("cv2")

import tools.measure_report as ref_tool
import tools.measure_report_torch as port_tool

WEIGHTS = "checkpoints/yolov8n_textile_cam.msgpack"


@pytest.fixture(scope="module")
def scenes():
    """Seed 0's first two scenes from both oracles."""
    out = []
    for tool in (port_tool, ref_tool):
        mapper = tool.PlaneMapper()
        rng = np.random.default_rng(0)
        out.append((mapper, [tool.make_measure_scene(mapper, rng) for _ in range(2)]))
    return out


def test_oracle_copy_renders_the_same_scenes(scenes):
    (port_mapper, port_scenes), (ref_mapper, ref_scenes) = scenes
    np.testing.assert_array_equal(port_mapper.plane_mm, ref_mapper.plane_mm)
    for (frame, truth), (ref_frame, ref_truth) in zip(port_scenes, ref_scenes):
        assert frame.shape == (960, 1280, 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, ref_frame)
        assert truth.n_stitches == ref_truth.n_stitches >= 3
        for field in ("width_protocol", "width_nominal", "edge_protocol", "edge_perp"):
            np.testing.assert_array_equal(getattr(truth, field), getattr(ref_truth, field))
        assert (truth.frame_edge, truth.frame_width) == (ref_truth.frame_edge,
                                                         ref_truth.frame_width)
    for name in ("REF_K", "REF_DIST", "REF_RVEC", "REF_TVEC", "FRAME_HW"):
        np.testing.assert_array_equal(getattr(port_tool, name), getattr(ref_tool, name))
    m = np.array([1.0, np.nan, 3.5])
    assert port_tool.error_stats(m, np.ones(3)) == ref_tool.error_stats(m, np.ones(3))


def _both_runs(scenes, undistort=False):
    """(port, tti) ``run_pipeline`` results on the two deploy scenes."""
    frames = np.stack([f for f, _ in scenes[0][1]])
    got = port_tool.run_pipeline(frames, WEIGHTS, undistort=undistort, dtype="float32",
                                 batch=len(frames), device="cpu")
    gc.collect()  # the rectified step's float32 warp weights are several GB
    want = ref_tool.run_pipeline(frames, WEIGHTS, undistort=undistort, dtype="float32",
                                 batch=len(frames))
    return got, want


def _assert_runs_agree(got, want):
    edge, width, n_stitch = got
    np.testing.assert_array_equal(n_stitch, want[2])
    for a, b, what in ((edge, want[0], "edge"), (width, want[1], "width")):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=what)
    assert np.isfinite(width).all()  # both scenes give a width reading


@pytest.fixture(scope="module")
def default_runs(scenes):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TTI_READOUT_CAL", raising=False)
        return _both_runs(scenes)


def test_run_pipeline_equals_tti_on_deploy_scenes(default_runs):
    _assert_runs_agree(*default_runs)


def test_run_pipeline_equals_tti_with_readout_cal_off(scenes, default_runs, monkeypatch):
    """``TTI_READOUT_CAL=0`` drops the sidecar's readout offsets in both
    packages: the readings agree as above (well inside the report's 0.02 mm
    parity limit), and each lies below the default run's by the deploy
    sidecar's 0.1175 mm (edge) and 0.1606 mm (width)."""
    monkeypatch.setenv("TTI_READOUT_CAL", "0")
    got, want = _both_runs(scenes)
    _assert_runs_agree(got, want)
    for i, (offset, what) in enumerate(((0.1175, "edge"), (0.1606, "width"))):
        shift = default_runs[0][i] - got[i]
        assert np.isfinite(shift).any(), what
        np.testing.assert_allclose(shift[np.isfinite(shift)], offset, atol=1e-5, err_msg=what)


def test_run_pipeline_rectified_equals_tti(scenes, default_runs, monkeypatch):
    """The rectified path (``undistort=True``: the two-pass warp ahead of
    the model, the points not undistorted again) against tti's on the same
    two scenes, at the same bar; its readings are not the native path's."""
    monkeypatch.delenv("TTI_READOUT_CAL", raising=False)
    got, want = _both_runs(scenes, undistort=True)
    _assert_runs_agree(got, want)
    native = default_runs[0]
    assert not np.allclose(got[1], native[1], atol=1e-3)  # the warp ran


def test_main_paths_select_configurations(tmp_path, capsys):
    """``--paths rectified --dtype float32`` runs that configuration alone
    (one small scene at imgsz 320 on the CPU); the JSON holds its per-frame
    readings and its launch counts."""
    out = tmp_path / "report.md"
    assert port_tool.main(["--weights", WEIGHTS, "--scenes", "1", "--imgsz", "320",
                           "--paths", "rectified", "--dtype", "float32", "--device", "cpu",
                           "--out", str(out)]) == 0
    report = json.loads(out.with_suffix(".json").read_text())
    assert list(report["per_frame"]) == ["rectified/float32"]
    assert [(r["path"], r["dtype"]) for r in report["protocol"]] == [("rectified", "float32")]
    assert list(report["kernel_launches"]) == ["rectified/float32"]
    assert report["rectified_vs_native"] == []
    assert "| rectified | float32 | " in out.read_text()
    assert "rectified/float32: " in capsys.readouterr().out


def test_ring_smoothed_is_the_production_ring():
    """Per scene, what the production ring emits at the last variant: the
    median of the scene's readings with a value (as tools/measure_report.py's
    ring_median), NaN where the last variant has none."""
    edge = np.array([[5.0, np.nan, 6.0, 7.5], [1.0, 2.0, 3.0, np.nan], [np.nan] * 4])
    width = np.array([[3.0, 3.2, 3.1, 3.6], [2.0, np.nan, np.nan, 2.5], [3.3] * 4])
    got_e, got_w = port_tool.ring_smoothed(edge, width, frame_buffer=8, device="cpu")
    np.testing.assert_allclose(got_e, [6.0, np.nan, np.nan])
    np.testing.assert_allclose(got_w, [3.15, 2.25, 3.3], rtol=1e-6)


def test_compare_measure_reports():
    from tools import compare_measure_reports as cmp

    def report(edge, width, n):
        return {"truth": {"edge": [6.0, 5.0, 4.0]},
                "per_frame": {"reference-native/float32": {
                    "edge_measured": edge, "width_measured": width, "n_detected": n}}}

    a = report([6.1, float("nan"), 4.2], [3.0, 3.1, 3.2], [5, 6, 7])
    b = report([6.0, 5.0, 4.25], [3.0, 3.1, 3.3], [5, 6, 8])
    (line,) = cmp.compare(a, b)
    assert ("edge: 2 frames in both, 0 only in A, 1 only in B, |A - B| max 0.100000 "
            "median 0.075000 mm") in line
    assert "width: 3 frames in both" in line and "max 0.100000" in line
    assert line.endswith("n_detected differs on 1 frames")
    with pytest.raises(SystemExit):
        cmp.compare(a, {**b, "truth": {"edge": [1.0, 2.0, 3.0]}})
