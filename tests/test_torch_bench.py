"""``bench_torch.py`` (the port's ``bench.py``) against ``bench.py`` on the CPU.

- The rows: both ``main``s under the same fakes of ``_build_pipeline`` and
  ``_measure`` print the same stdout and stderr lines, draw the same frames
  and hand the same checkpoints and filters to the build.
- The configuration: at a small geometry, for both committed checkpoints
  under both rows' filters, the port's ``_build_pipeline`` and
  ``bench._build_pipeline`` agree on the weights used, the sidecar, the
  calibration, the ROI, the model's proto head and the measurement config
  (the sub-cell readout fields among it), and print the same random-init
  line.
- One step: the port's bench pipeline in float32 against ``tti``'s
  ``InspectionPipeline`` built from the same calibration, ROI and measure
  config, on one of ``bench.py``'s random frames and four textile frames, at
  ``tests/torch_pair.py``'s tolerances.
- ``main`` on the CPU at small geometries with ``TTI_BENCH_CONFIGS=all``;
  the runtime switches (``TTI_APPROX_TOPK=1`` refused before anything is
  built, ``TTI_QUANT`` and ``TTI_REMAP`` given to every pipeline); no CPU
  fallback on the default device.
"""

import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

import bench
import bench_torch
import tti.calib.io as jio
import tti.core.config as jcfg
from tti.parallel.runtime import InspectionPipeline as JaxPipeline
from tti_torch.app.sources import SyntheticSource
from tti_torch.core.errors import ConfigError
from tests.torch_pair import SWITCHES, assert_outputs_match
from tests.torch_synth import textile_frames

REPO = Path(__file__).resolve().parents[1]
CKPTS = {"cam": str(REPO / "checkpoints" / "yolov8n_textile_cam.msgpack"),
         "headline": str(REPO / "checkpoints" / "yolov8n_textile.msgpack")}
FILTERS = {"deploy": bench_torch.deploy_arch, "headline": bench_torch.headline_arch}
KNOBS = ("TTI_BENCH_BATCH", "TTI_BENCH_ITERS", "TTI_BENCH_DEPLOY_WEIGHTS", "TTI_BENCH_WEIGHTS",
         "TTI_BENCH_CONFIGS")
ROW_KEYS = ["metric", "value", "unit", "vs_baseline", "weights", "p50_ms_unclamped",
            "sync_roundtrip_ms"]
# Small geometries for the runs of main on the CPU.
SMALL = {"DEPLOY": ((240, 320), 160), "HEADLINE": ((216, 384), 128)}


@pytest.fixture
def clean_env(monkeypatch):
    """No bench knob and no runtime switch from the caller's environment."""
    for name in KNOBS + SWITCHES + ("TTI_QUANT_SCALES",):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _fakes(record):
    """A fake ``_build_pipeline`` and ``_measure`` that record their
    arguments; the two rows' readings carry more digits than the rounding
    keeps."""
    readings = iter([(1973.456789, 10.123456, 0.5678912), (5675.04321, 25.98765, 0.3456789)])

    def build(frame_hw, imgsz, weights_path, arch_filter, **kw):
        record.append(("build", frame_hw, imgsz, weights_path, arch_filter))
        return object(), weights_path, {}

    def measure(pipeline, frames, batch, iters):
        record.append(("measure", frames.copy(), batch, iters))
        return next(readings)

    return build, measure


def test_rows_equal_bench_py(clean_env, capsys):
    """bench.main() and bench_torch.main() under the same fakes print the
    same lines, deploy first, with bench.py's keys and rounding."""
    import jax

    clean_env.setenv("TTI_BENCH_BATCH", "1")
    # bench.main points jax's compilation cache elsewhere; keep this process's.
    update = jax.config.update
    clean_env.setattr(jax.config, "update", lambda name, value: None
                      if name == "jax_compilation_cache_dir" else update(name, value))
    ref_calls, got_calls = [], []
    build, measure = _fakes(ref_calls)
    clean_env.setattr(bench, "_build_pipeline", build)
    clean_env.setattr(bench, "_measure", measure)
    bench.main()
    ref = capsys.readouterr()
    build, measure = _fakes(got_calls)
    clean_env.setattr(bench_torch, "_build_pipeline", build)
    clean_env.setattr(bench_torch, "_measure", measure)
    bench_torch.main(device="cpu")
    got = capsys.readouterr()

    assert got.out == ref.out
    assert got.err == ref.err
    rows = [json.loads(line) for line in got.out.splitlines()]
    assert [r["metric"] for r in rows] == [
        "deploy_960p_imgsz960_s2_frames_per_sec_per_chip_e2e",
        "undistorted_1080p_frames_per_sec_per_chip_e2e"]
    assert all(list(r) == ROW_KEYS for r in rows)
    assert rows[0]["value"] == 1973.46 and rows[0]["vs_baseline"] == 3.947
    assert rows[1]["weights"] == CKPTS["headline"] and rows[0]["weights"] == CKPTS["cam"]
    # The same builds (geometry, checkpoint, filter) and the same frames.
    metas = [{}, {"variant": "s"}, {"mask_stride": 2}, {"proto_head": "subpixel"},
             {"variant": "n", "mask_stride": 4, "proto_head": "deconv"},
             {"mask_stride": 2, "proto_head": "subpixel", "variant": "n"}]
    assert len(got_calls) == len(ref_calls) == 4
    for g, r in zip(got_calls, ref_calls):
        assert g[0] == r[0]
        if g[0] == "build":
            assert g[1:4] == r[1:4]
            assert [g[4](m) for m in metas] == [r[4](m) for m in metas]
        else:
            np.testing.assert_array_equal(g[1], r[1])
            assert g[2:] == r[2:] == (1, 50)


def _calibration(pipe):
    c = pipe.calibration
    return [np.asarray(x, np.float64) for x in (c.K, c.dist, c.rvec, c.tvec)]


@pytest.mark.parametrize("ckpt", sorted(CKPTS))
@pytest.mark.parametrize("row", sorted(FILTERS))
def test_build_pipeline_equals_bench_py(ckpt, row, clean_env, capsys):
    """The port's ``_build_pipeline`` and ``bench._build_pipeline`` at frame
    (240, 320), imgsz 160: the same weights, sidecar, calibration, ROI,
    proto head and measurement config, and the same stderr line."""
    hw, imgsz = (240, 320), 160
    ref, ref_used, ref_meta = bench._build_pipeline(hw, imgsz, CKPTS[ckpt], FILTERS[row])
    ref_err = capsys.readouterr().err
    got, got_used, got_meta = bench_torch._build_pipeline(hw, imgsz, CKPTS[ckpt], FILTERS[row],
                                                          device="cpu")
    got_err = capsys.readouterr().err

    rejected = (ckpt, row) == ("cam", "headline")
    assert got_used == ref_used == ("random-init" if rejected else CKPTS[ckpt])
    assert got_meta == ref_meta and bool(got_meta) != rejected
    line = f"weights {CKPTS[ckpt]} arch "
    assert (line in got_err) == (line in ref_err) == rejected
    if rejected:
        assert got_err == ref_err
    for g, r in zip(_calibration(got), _calibration(ref)):
        np.testing.assert_array_equal(g, r)
    assert got.roi_bounds == ref.roi_bounds
    assert (got.model_cfg.mask_stride, got.model_cfg.proto_head) == (
        ref.model.mask_stride, ref.model.proto_head)
    assert (got.model_cfg.image_size, got.model_cfg.dtype, got.frame_hw) == (
        ref.model_cfg.image_size, ref.model_cfg.dtype, ref.frame_hw)
    ours, theirs = dataclasses.asdict(got.measure_cfg), dataclasses.asdict(ref.measure_cfg)
    assert {"subcell_edge", "subcell_envelope", "cal_edge_mm", "cal_width_mm"} <= set(ours)
    assert {k: v for k, v in ours.items() if k in theirs} == {
        k: v for k, v in theirs.items() if k in ours}
    assert got.measure_cfg.subcell_edge is (ckpt == "cam" and not rejected)


# Geometries at which the rows' checkpoints detect stitches in textile
# frames at the default confidence (the stitches about 16 px wide in the
# model input or more).
@pytest.mark.parametrize("row, ckpt, hw, imgsz", [
    ("deploy", "cam", (480, 640), 640),
    ("headline", "headline", (360, 640), 384),
])
def test_step_matches_tti(row, ckpt, hw, imgsz, clean_env):
    """The port's bench pipeline in float32 against ``tti``'s pipeline from
    the same calibration, ROI and measure config, on one of bench.py's
    random frames and four textile frames."""
    got, used, meta = bench_torch._build_pipeline(hw, imgsz, CKPTS[ckpt], FILTERS[row],
                                                  dtype="float32", device="cpu")
    assert used == CKPTS[ckpt]
    with open(CKPTS[ckpt], "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    K, dist, rvec, tvec = _calibration(got)
    roi = bench_torch.bench_roi(hw)
    ref = JaxPipeline(
        jcfg.ModelConfig(variant="n", num_classes=2, image_size=imgsz, dtype="float32",
                         mask_stride=meta.get("mask_stride", 4),
                         proto_head=meta.get("proto_head", "deconv")),
        variables, hw, jio.CalibrationData(K=K, dist=dist, rvec=rvec, tvec=tvec),
        jcfg.MeasureConfig().with_subcell_from(meta),
        jcfg.RoiConfig(enabled=True, x_min=roi.x_min, x_max=roi.x_max, y_min=roi.y_min,
                       y_max=roi.y_max))
    random_frame = np.random.default_rng(0).integers(0, 255, size=(1, *hw, 3), dtype=np.uint8)
    frames = np.concatenate([random_frame, textile_frames(4, *hw, seed=5)])
    out, ref_out = got.process_batch(frames), ref.process_batch(frames)
    assert_outputs_match(out, ref_out)
    assert out.valid[1:].sum(1).max() >= 2 and np.isfinite(out.measurements.raw_width_mm).any()


class PacedSource(SyntheticSource):
    """A synthetic camera at about 200 frames/s. Four capture threads that
    draw frames without a pause starve the step of this host's cores (the
    4-stream line ran at 2 frames/s here)."""

    def read(self):
        time.sleep(0.005)
        return super().read()


def test_main_on_the_cpu(clean_env, capsys):
    """``main(device="cpu")`` with small geometries, batch 2, one iteration
    and every configuration: two rows with finite positive readings and the
    dual and 4-stream lines. The round trip of a finished sum takes
    microseconds on the CPU and may round to 0.00 ms."""
    for name, value in SMALL.items():
        clean_env.setattr(bench_torch, name, value)
    clean_env.setattr("tti_torch.app.sources.SyntheticSource", PacedSource)
    clean_env.setenv("TTI_BENCH_BATCH", "2")
    clean_env.setenv("TTI_BENCH_ITERS", "1")
    clean_env.setenv("TTI_BENCH_CONFIGS", "all")
    bench_torch.main(device="cpu")
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["metric"] for r in rows] == [
        "deploy_960p_imgsz960_s2_frames_per_sec_per_chip_e2e",
        "undistorted_1080p_frames_per_sec_per_chip_e2e"]
    for r, ckpt in zip(rows, ("cam", "headline")):
        assert list(r) == ROW_KEYS and r["unit"] == "frames/s" and r["weights"] == CKPTS[ckpt]
        assert all(math.isfinite(r[k]) and r[k] > 0
                   for k in ("value", "vs_baseline", "p50_ms_unclamped"))
        assert math.isfinite(r["sync_roundtrip_ms"]) and r["sync_roundtrip_ms"] >= 0
    lines = err.splitlines()
    starts = ["deploy batch=2 iters=1 p50_unclamped=", "headline batch=2 iters=1 p50_unclamped=",
              "config4 dual-model: ", "config5 4-stream line host-fed: "]
    found = [next(i for i, line in enumerate(lines) if line.startswith(s)) for s in starts]
    assert found == sorted(found)
    dual = float(lines[found[2]].split()[2])
    sync, pipelined = (float(x.split()[0]) for x in lines[found[3]].split(": ")[1].split(", ")[:2])
    assert min(dual, sync, pipelined) > 0


def test_approx_topk_refused_before_anything_is_built(clean_env, capsys):
    from tti_torch.cli.__main__ import main as port_main

    def never(*a, **k):
        raise AssertionError("a pipeline was built")

    clean_env.setattr(bench_torch, "_build_pipeline", never)
    clean_env.setattr("tti_torch.parallel.runtime.InspectionPipeline.__init__", never)
    clean_env.setenv("TTI_APPROX_TOPK", "1")
    with pytest.raises(ConfigError, match="TTI_APPROX_TOPK=1 is not ported"):
        bench_torch.main(device="cpu")
    assert port_main(["bench"]) == 1
    assert "TTI_APPROX_TOPK=1 is not ported" in capsys.readouterr().err


def test_switches_reach_every_pipeline(clean_env):
    """``TTI_QUANT=int8`` and ``TTI_REMAP=packed`` reach the deploy, the
    headline and the dual step's second pipeline (the timing is faked); a
    set switch with no counterpart is logged."""
    import logging

    import tti_torch.parallel.runtime as rt

    built = []
    init = rt.InspectionPipeline.__init__

    def recording(self, *args, **kwargs):
        built.append(kwargs)
        init(self, *args, **kwargs)

    clean_env.setattr(rt.InspectionPipeline, "__init__", recording)
    clean_env.setattr(bench_torch, "_measure", lambda *a: (1.0, 1.0, 1.0))
    clean_env.setattr(bench_torch, "_measure_dual", lambda *a: 1.0)
    clean_env.setattr(bench_torch, "_measure_streams", lambda *a: (1.0, 1.0))
    for name, value in SMALL.items():
        clean_env.setattr(bench_torch, name, value)
    for name, value in (("TTI_QUANT", "int8"), ("TTI_REMAP", "packed"),
                        ("TTI_LETTERBOX_ROWSLICE", "1"), ("TTI_BENCH_BATCH", "1"),
                        ("TTI_BENCH_CONFIGS", "all")):
        clean_env.setenv(name, value)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger("tti_torch.bench")
    logger.addHandler(handler)
    try:
        bench_torch.main(device="cpu")
    finally:
        logger.removeHandler(handler)
    assert [m.split(":")[0] for m in logged] == [
        "TTI_LETTERBOX_ROWSLICE has no counterpart in tti_torch and is not read"]
    assert len(built) == 3
    assert all(kw["quant"] == "int8" and kw["remap"] == "packed" and kw["device"] == "cpu"
               for kw in built)


def test_no_cpu_fallback(clean_env):
    """Without a card the default device raises; it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is served")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_torch.main()
