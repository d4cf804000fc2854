"""The whole slice: tti_torch's InspectionPipeline.process_batch against
tti's on the real checkpoints, at two small geometries:

- deploy-like: (2, 240, 320) frames at imgsz 240 (rect letterbox: a 0.8
  bilinear resize to 192x256), the stride-2 subpixel soft checkpoint;
- headline-like: (2, 216, 384) frames at imgsz 128 (an exact x3
  decimation to 72x128 content), the stride-4 binary checkpoint.

Both run float32 on the CPU with the same calibration, ROI and synthetic
textile frames; conf_thresh 0.05 and min_stitches 1 so that these small
inputs produce detections and millimetre values to compare. Tolerances:
1e-3 px on boxes (float32 through the network), 1e-3 mm on measurements.
"""

import numpy as np
import pytest
from flax import serialization

import tti.calib.io as jio
import tti.core.config as jcfg
from tti.parallel.runtime import InspectionPipeline as JaxPipeline
import tti_torch.calib.io as tio
import tti_torch.core.config as tcfg
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.parallel.runtime import InspectionPipeline
from tests.torch_synth import textile_frames

RVEC = np.array([-0.8631369244225452, -0.3919482615538663, -1.3591256137314185])
TVEC = np.array([0.005016396186926285, 0.03590342712705542, 0.09382141278570659])

GEOMETRIES = {
    "deploy": ("yolov8n_textile_cam", (240, 320), 240),
    "headline": ("yolov8n_textile", (216, 384), 128),
}


def _pipelines(name, ref_intrinsics, calibrated=True):
    ckpt, hw, imgsz = GEOMETRIES[name]
    path = f"checkpoints/{ckpt}.msgpack"
    meta = checkpoint_metadata(path)
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= hw[1] / 1280.0
    K[1] *= hw[0] / 960.0
    model_kw = dict(variant="n", num_classes=2, image_size=imgsz, dtype="float32",
                    conf_thresh=0.05, mask_stride=meta.get("mask_stride", 4),
                    proto_head=meta.get("proto_head", "deconv"))
    roi_kw = dict(enabled=True, x_min=10, x_max=hw[1] - 10, y_min=min(300, hw[0] // 3),
                  y_max=hw[0] - min(200, hw[0] // 5))
    calib = dict(K=K, dist=dist, rvec=RVEC, tvec=TVEC)
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    ref = JaxPipeline(jcfg.ModelConfig(**model_kw), variables, hw,
                      jio.CalibrationData(**calib) if calibrated else None,
                      jcfg.MeasureConfig(min_stitches=1).with_subcell_from(meta),
                      jcfg.RoiConfig(**roi_kw))
    got = InspectionPipeline(tcfg.ModelConfig(**model_kw), load_flax_msgpack(path), hw,
                             tio.CalibrationData(**calib) if calibrated else None,
                             tcfg.MeasureConfig(min_stitches=1).with_subcell_from(meta),
                             tcfg.RoiConfig(**roi_kw), device="cpu")
    return got, ref, textile_frames(2, *hw, seed=5)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_process_batch_matches_tti(name, ref_intrinsics, monkeypatch):
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    pipe, ref_pipe, frames = _pipelines(name, ref_intrinsics)
    assert pipe.spec.__dict__ == ref_pipe.spec.__dict__
    assert pipe.measure_cfg.subcell_edge == (name == "deploy")
    got, ref = pipe.process_batch(frames), ref_pipe.process_batch(frames)

    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.classes, ref.classes)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=1e-3)
    for key in ref.telemetry:
        np.testing.assert_array_equal(got.telemetry[key], np.asarray(ref.telemetry[key]),
                                      err_msg=key)
    for field in ("raw_edge_mm", "raw_width_mm", "edge_distance_mm", "stitch_width_mm"):
        np.testing.assert_allclose(getattr(got.measurements, field),
                                   np.asarray(getattr(ref.measurements, field)), atol=1e-3,
                                   err_msg=field)
    for field in ("n_dist", "n_width", "n_stitches", "fabric_detected"):
        np.testing.assert_array_equal(getattr(got.measurements, field),
                                      np.asarray(getattr(ref.measurements, field)), err_msg=field)
    np.testing.assert_allclose(got.envelope, np.asarray(ref.envelope), atol=1e-3)
    for field in ("cx", "cy", "left", "right"):
        sv = got.stitches.valid
        np.testing.assert_allclose(getattr(got.stitches, field)[sv],
                                   np.asarray(getattr(ref.stitches, field))[sv], atol=1e-3)
    # The comparison is not vacuous: detections, stitches and mm values exist.
    assert got.valid.sum() >= 2 and got.measurements.n_stitches.sum() >= 1
    assert np.isfinite(got.measurements.raw_width_mm).any()
    assert np.isfinite(got.measurements.raw_edge_mm).any()


def test_uncalibrated_pipeline_detects_only(ref_intrinsics):
    pipe, ref_pipe, frames = _pipelines("headline", ref_intrinsics, calibrated=False)
    got, ref = pipe.process_batch(frames), ref_pipe.process_batch(frames)
    assert got.measurements is None and pipe.warp is None
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=1e-3)
