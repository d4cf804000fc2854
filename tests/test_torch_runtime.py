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

from tests.torch_pair import assert_outputs_match, pipelines as _pipelines


@pytest.mark.parametrize("name", ["deploy", "headline"])
def test_process_batch_matches_tti(name, ref_intrinsics, monkeypatch):
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    pipe, ref_pipe, frames = _pipelines(name, ref_intrinsics)
    assert pipe.spec.__dict__ == ref_pipe.spec.__dict__
    assert pipe.measure_cfg.subcell_edge == (name == "deploy")
    got, ref = pipe.process_batch(frames), ref_pipe.process_batch(frames)

    assert_outputs_match(got, ref)
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
