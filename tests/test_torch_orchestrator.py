"""The port's Orchestrator against tti's.

- The scripted-pipeline scheme of ``tests/test_orchestrator.py``: a fake
  pipeline hands both orchestrators the same per-frame (edge, width)
  readings (port dataclasses on the port's side), a fake serial counter the
  same stitch counts and ``random.Random`` the same seed; the per-frame
  result dicts, the totals and the database rows must be equal (the same
  float32 readings through the same host arithmetic: exactly).
- Once on the deploy pair of ``tests/torch_pair.py`` (real checkpoint,
  240x320 frames, float32, CPU): three frames through both orchestrators,
  seam and width within 1e-3 mm; the port's pipelined loop equal to its
  blocking loop.
- ``PipelineOutputs.budget_overflows`` on the same telemetry.
- The rectified-frame overlay (a deliberate difference): the port's
  ``render_annotated`` undistorts the frame when the pipeline has a warp;
  tti's asks for a ``remap_xy`` attribute, so it would draw the port's
  rectified geometry on the distorted frame.
"""

import random
import sqlite3
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tti.app.orchestrator as jorch
import tti.core.config as jcfg
import tti.measure.pipeline as jmp
import tti.parallel.runtime as jrt
import tti_torch.app.orchestrator as torch_orch
import tti_torch.core.config as tcfg
import tti_torch.measure.pipeline as tmp
import tti_torch.parallel.runtime as trt
from tests.torch_pair import pipelines

torch.set_num_threads(2)
D = 8


def _port_outputs(edge, width):
    f32 = lambda v: np.asarray([v], np.float32)
    i32 = lambda v: np.asarray([v], np.int32)
    meas = tmp.FrameMeasurement(edge_distance_mm=f32(edge), stitch_width_mm=f32(width),
                                raw_edge_mm=f32(edge), raw_width_mm=f32(width), n_dist=i32(5),
                                n_width=i32(5), n_stitches=i32(5),
                                fabric_detected=np.asarray([not np.isnan(edge)]))
    return trt.PipelineOutputs(boxes_frame=np.zeros((1, D, 4), np.float32),
                               scores=np.zeros((1, D), np.float32),
                               classes=np.full((1, D), -1, np.int32),
                               valid=np.zeros((1, D), bool), masks=None, measurements=meas)


def _tti_outputs(edge, width):
    meas = jmp.FrameMeasurement(
        edge_distance_mm=jnp.asarray([edge], jnp.float32),
        stitch_width_mm=jnp.asarray([width], jnp.float32),
        raw_edge_mm=jnp.asarray([edge], jnp.float32), raw_width_mm=jnp.asarray([width], jnp.float32),
        n_dist=jnp.asarray([5], jnp.int32), n_width=jnp.asarray([5], jnp.int32),
        n_stitches=jnp.asarray([5], jnp.int32), fabric_detected=jnp.asarray([not np.isnan(edge)]))
    return jrt.PipelineOutputs(boxes_frame=np.zeros((1, D, 4), np.float32),
                               scores=np.zeros((1, D), np.float32),
                               classes=np.full((1, D), -1, np.int32),
                               valid=np.zeros((1, D), bool), masks=None, measurements=meas)


class FakePipeline:
    """Scripted per-frame (edge, width) measurements, blocking only."""

    def __init__(self, script, make_outputs):
        self.script = list(script)
        self.make_outputs = make_outputs
        self.roi_bounds = None
        self.device = torch.device("cpu")
        self.warp = None

    def process_batch(self, frames):
        edge, width = self.script.pop(0) if self.script else (np.nan, np.nan)
        return self.make_outputs(edge, width)


class FakeSerial:
    def __init__(self, counts):
        self.counts = list(counts)

    def get_stitch_count(self):
        return self.counts.pop(0) if self.counts else 0

    def stop(self):
        pass


class ListSource:
    """The given frames once, then failed reads."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return (True, self.frames.pop(0)) if self.frames else (False, None)

    def reconnect(self):
        pass

    def release(self):
        pass


class FlakySource:
    def __init__(self):
        self.fails = 0
        self.reconnects = 0

    def read(self):
        if self.reconnects:
            return True, np.zeros((32, 48, 3), np.uint8)
        self.fails += 1
        return False, None

    def reconnect(self):
        self.reconnects += 1

    def release(self):
        pass


PACKAGES = {"port": (tcfg, torch_orch, _port_outputs), "tti": (jcfg, jorch, _tti_outputs)}


def _orchestrator(side, tmp_path, pipeline, counts, seed, source=None):
    cfg_mod, orch_mod, _ = PACKAGES[side]
    cfg = cfg_mod.AppConfig().replace(
        database=cfg_mod.DatabaseConfig(backend="sqlite", table="t",
                                        sqlite_path=str(tmp_path / f"{side}.db")),
        runtime=cfg_mod.RuntimeConfig(save_dir=str(tmp_path / f"{side}_ann"),
                                      inference_interval_s=0.0))
    frames = [np.zeros((32, 48, 3), np.uint8)] * 40
    orch = orch_mod.Orchestrator(cfg, pipeline, source or ListSource(frames),
                                 sleep=lambda s: None, rng=random.Random(seed),
                                 save_annotated=False)
    orch.serial = FakeSerial(counts)
    db = import_module(orch_mod.__name__.split(".")[0] + ".services.database").DatabaseHandler(
        cfg.database)
    assert db.connect()
    orch.db = db
    results = []
    fuse = orch._fuse_outputs
    orch._fuse_outputs = lambda outs: results.append(fuse(outs)) or results[-1]
    return orch, results


def _comparable(result):
    return {k: v for k, v in result.items() if k not in ("timestamp", "outputs")}


def _db_rows(tmp_path, side):
    with sqlite3.connect(str(tmp_path / f"{side}.db")) as con:
        return con.execute("SELECT stitch_length, seam_allowance, total_distance FROM t "
                           "ORDER BY id").fetchall()


WINDOW = [(7.8, 4.9), (7.9, 4.8), (np.nan, np.nan), (20.0, 4.9), (7.7, 5.0), (7.6, 4.85),
          (7.8, 9.0), (7.81, 4.91), (7.9, 4.7), (7.7, 4.95), (7.75, 4.9), (np.nan, 4.8)]
SCENARIOS = {  # script, stitch counts, rng seed, how to drive it
    "valid": ([(7.8, 4.9)], [10], 0, "once"),
    "out_of_range": ([(20.0, 4.9)], [5], 0, "once"),
    "no_delta": ([(7.8, 4.9)], [0], 0, "once"),
    "nan": ([(np.nan, np.nan)], [3], 0, "once"),
    "resume": ([(7.8, 4.9)], [10], 0, "resume"),
    "bounded_run": ([(7.8, 4.9)] * 3, [1, 2, 3], 0, "run"),
    "pipelined": ([(7.8, 4.9), (7.9, 4.8), (7.7, 5.0), (7.8, 4.9)], [1, 2, 3, 4], 3,
                  "pipelined"),
    "median_window": (WINDOW, [1, 2, 2, 5, 6, 9, 10, 10, 12, 15, 16, 20], 7, "run"),
    "reconnect": ([(7.8, 4.9)] * 2, [1, 2], 0, "flaky"),
}


def _drive(side, tmp_path, name):
    script, counts, seed, how = SCENARIOS[name]
    make = PACKAGES[side][2]
    source = FlakySource() if how == "flaky" else None
    orch, results = _orchestrator(side, tmp_path, FakePipeline(script, make), counts, seed,
                                  source)
    if how == "resume":
        orch.db.insert_measurement(total_distance=500.0, stitch_length=3.9, seam_allowance=6.5)
        orch.total_distance_mm = float(orch.db.get_last_record_total_distance())
    if how in ("once", "resume"):
        orch.process_once(np.zeros((32, 48, 3), np.uint8))
        orch.db.close()
    else:
        orch.run(max_frames=len(script) if how != "flaky" else 1,
                 pipelined=how == "pipelined")
    extra = (orch.source.reconnects, orch.source.fails >= 10) if how == "flaky" else ()
    return ([_comparable(r) for r in results], orch.total_distance_mm, orch.frame_count,
            _db_rows(tmp_path, side), extra)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_orchestrator_matches_tti(name, tmp_path):
    got, want = _drive("port", tmp_path, name), _drive("tti", tmp_path, name)
    assert got == want
    assert len(got[0]) == (1 if SCENARIOS[name][3] in ("once", "resume", "flaky")
                           else len(SCENARIOS[name][0]))


TELEMETRY = {
    "all": {"n_candidates": [3, 300, 256], "n_valid": [3, 200, 199], "n_roi_valid": [2, 70, 64],
            "n_stitches_raw": [1, 65, 64]},
    "no_measure": {"n_candidates": [3, 257], "n_valid": [200, 1]},
    "candidates_only": {"n_candidates": [0, 512]},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(TELEMETRY))
def test_budget_overflows_match_tti(name):
    tel = {k: np.asarray(v, np.int32) for k, v in TELEMETRY[name].items()}
    args = dict(boxes_frame=None, scores=None, classes=None, valid=None, masks=None,
                measurements=None, telemetry=tel)
    got = trt.PipelineOutputs(**args)
    want = jrt.PipelineOutputs(**args)
    for measure in (None, "cfg"):
        g = got.budget_overflows(tcfg.ModelConfig(), measure and tcfg.MeasureConfig())
        w = want.budget_overflows(jcfg.ModelConfig(), measure and jcfg.MeasureConfig())
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.fixture(scope="module")
def deploy(ref_intrinsics):
    return pipelines("deploy", ref_intrinsics, n_frames=3)


def _real_run(side, pipeline, frames, tmp_path, pipelined=False):
    tmp_path.mkdir(parents=True, exist_ok=True)
    orch, results = _orchestrator(side, tmp_path, pipeline, [5, 10, 15], 0,
                                  ListSource(list(frames)))
    orch.run(max_frames=len(frames), pipelined=pipelined)
    return orch, results


def test_deploy_pair_through_both_orchestrators(deploy, tmp_path):
    got_pipe, ref_pipe, frames = deploy
    _, got = _real_run("port", got_pipe, frames, tmp_path / "a")
    _, want = _real_run("tti", ref_pipe, frames, tmp_path / "b")
    assert len(got) == len(want) == 3
    measured = 0
    for g, w in zip(got, want):
        for key in ("valid", "inserted", "stitch_delta", "stitch_count_hw", "stitch_count",
                    "error"):
            assert g.get(key) == w.get(key), key
        for key in ("edge_distance_mm", "stitch_width_mm", "seam_mm", "width_mm", "moved_mm",
                    "total_mm"):
            assert (g[key] is None) == (w[key] is None), key
            if g[key] is not None:
                assert g[key] == pytest.approx(w[key], abs=1e-3), key
        measured += g["edge_distance_mm"] is not None
    assert measured > 0, "the deploy pair should measure on the seeded frames"
    _, piped = _real_run("port", got_pipe, frames, tmp_path / "c", pipelined=True)
    assert [_comparable(r) for r in piped] == [_comparable(r) for r in got]


def test_render_annotated_undistorts_rectified_frames(deploy, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from tti_torch.app.annotate import annotate_frame

    got_pipe, _, frames = deploy
    assert got_pipe.warp is not None
    orch, results = _real_run("port", got_pipe, frames[:1], tmp_path)
    result = results[0]
    drawn = orch.render_annotated(frames[0], result)
    outs = result["outputs"]
    calib = got_pipe.calibration

    def expected(frame):
        env = torch_orch.envelope_to_polyline(outs.envelope[0], got_pipe.spec)
        hud = [f"Count: {result['stitch_count_hw']} | Moved: {result['moved_mm']:.2f}mm | "
               f"Total: {result['total_mm']:.2f}mm | Seam: {result['seam_mm']:.2f}mm | "
               f"Width: {result['width_mm']:.2f}mm"]
        out = annotate_frame(frame, outs.boxes_frame[0], outs.classes[0], outs.valid[0], 0, 1,
                             envelope_frame_xy=env, roi_bounds=got_pipe.roi_bounds, hud_lines=hud)
        return torch_orch.draw_measurement_geometry(out, outs.stitches, None, index=0)

    assert result["valid"]
    np.testing.assert_array_equal(drawn, expected(cv2.undistort(frames[0], calib.K, calib.dist)))
    # tti's orchestrator keys on `remap_xy`, which the port's pipeline does
    # not have: handed the same pipeline, it draws on the distorted frame.
    stale = jorch.Orchestrator.render_annotated(orch, frames[0], result)
    np.testing.assert_array_equal(stale, expected(frames[0]))
    assert (stale != drawn).any()
