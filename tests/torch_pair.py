"""Builds the same inspection pipeline twice, in tti (JAX) and in tti_torch,
for the tests that hold one against the other: same checkpoint, calibration,
ROI and synthetic textile frames, float32 on the CPU. conf_thresh 0.05 and
min_stitches 1 so that the small inputs give detections and millimetre
values to compare.

- deploy: (240, 320) frames at imgsz 240 (rect letterbox: a 0.8 bilinear
  resize to 192x256), the stride-2 subpixel soft checkpoint;
- headline: (216, 384) frames at imgsz 128 (an exact x3 decimation to 72x128
  content), the stride-4 binary checkpoint; headline_b is the same geometry
  with the other stride-4 checkpoint of the repository.
"""

import numpy as np
from flax import serialization

import tti.calib.io as jio
import tti.core.config as jcfg
from tti.parallel.runtime import InspectionPipeline as JaxPipeline
import tti_torch.calib.io as tio
import tti_torch.core.config as tcfg
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.parallel.runtime import InspectionPipeline
from tests.torch_dist import GEOMETRIES, RVEC, TVEC, pipeline_settings  # noqa: F401
from tests.torch_synth import textile_frames


def pipelines(name, ref_intrinsics, calibrated=True, dist=None, port_kw=None, ref_kw=None,
              n_frames=2):
    """(port pipeline, tti pipeline, frames). ``port_kw`` / ``ref_kw`` are
    extra constructor arguments of either side; tti's environment switches
    are the caller's to set (they are read at construction)."""
    s = pipeline_settings(name, ref_intrinsics, dist)
    path, meta, hw, calib = s["path"], s["meta"], s["hw"], s["calib"]
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    ref = JaxPipeline(jcfg.ModelConfig(**s["model"]), variables, hw,
                      jio.CalibrationData(**calib) if calibrated else None,
                      jcfg.MeasureConfig(min_stitches=1).with_subcell_from(meta),
                      jcfg.RoiConfig(**s["roi"]), **(ref_kw or {}))
    got = InspectionPipeline(tcfg.ModelConfig(**s["model"]), load_flax_msgpack(path), hw,
                             tio.CalibrationData(**calib) if calibrated else None,
                             tcfg.MeasureConfig(min_stitches=1).with_subcell_from(meta),
                             tcfg.RoiConfig(**s["roi"]), device="cpu", **(port_kw or {}))
    return got, ref, textile_frames(n_frames, *hw, seed=5)


def assert_outputs_match(got, ref, box_atol=1e-3, mm_atol=1e-3, score_atol=1e-5, grid_atol=1e-3):
    """Port outputs against tti's: 1e-3 px on boxes (float32 through the
    network), 1e-3 mm on measurements, 1e-5 on scores, 1e-3 on the envelope
    and the stitches' grid coordinates, counts and flags equal."""
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.classes, ref.classes)
    np.testing.assert_allclose(got.scores, ref.scores, atol=score_atol)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=box_atol)
    for key in ref.telemetry:
        np.testing.assert_array_equal(got.telemetry[key], np.asarray(ref.telemetry[key]),
                                      err_msg=key)
    if ref.measurements is None:
        assert got.measurements is None
        return
    for field in ("raw_edge_mm", "raw_width_mm", "edge_distance_mm", "stitch_width_mm"):
        np.testing.assert_allclose(getattr(got.measurements, field),
                                   np.asarray(getattr(ref.measurements, field)), atol=mm_atol,
                                   err_msg=field)
    for field in ("n_dist", "n_width", "n_stitches", "fabric_detected"):
        np.testing.assert_array_equal(getattr(got.measurements, field),
                                      np.asarray(getattr(ref.measurements, field)), err_msg=field)
    np.testing.assert_allclose(got.envelope, np.asarray(ref.envelope), atol=grid_atol)
    for field in ("cx", "cy", "left", "right"):
        sv = got.stitches.valid
        np.testing.assert_allclose(getattr(got.stitches, field)[sv],
                                   np.asarray(getattr(ref.stitches, field))[sv], atol=grid_atol)


# tti's runtime switches; a mode's test clears them all, then sets its own.
SWITCHES = ("TTI_LAZY_DECODE", "TTI_FUSED_HEAD", "TTI_FOLDED_BN", "TTI_MASKSTATS_LOGITS",
            "TTI_WARP_BLOCKED", "TTI_WARP_COLEXPAND", "TTI_REMAP", "TTI_REMAP_U8_DECIMATE",
            "TTI_WARP_S2D", "TTI_APPROX_TOPK", "TTI_QUANT", "TTI_REMAP_SWAR",
            "TTI_REMAP_SKIP_PAD_ROWS", "TTI_LETTERBOX_DECIMATE", "TTI_LETTERBOX_ROWSLICE")


def mode_against_tti(geometry, env, port_kw, ref_intrinsics, monkeypatch, exact=True,
                     match=None):
    """One opt-in mode: tti's step with the switches ``env`` set (for the
    whole test: tti reads some at construction, some at trace time) and the
    port's with ``port_kw``, on the same frames, held to each other with
    :func:`assert_outputs_match` (``match``: its tolerances, where the mode
    states others); an ``exact`` mode's port step is also held to the port's
    default step. Returns (port pipeline, port outputs)."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    default = pipelines(geometry, ref_intrinsics)[0] if exact else None
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    pipe, ref_pipe, frames = pipelines(geometry, ref_intrinsics, port_kw=port_kw)
    got, ref = pipe.process_batch(frames), ref_pipe.process_batch(frames)
    assert_outputs_match(got, ref, **(match or {}))
    assert got.valid.sum() >= 2 and np.isfinite(got.measurements.raw_width_mm).any()
    if exact:
        assert_outputs_match(got, default.process_batch(frames))
    return pipe, got
