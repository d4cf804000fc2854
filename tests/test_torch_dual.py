"""The port's DualPipeline and host-fed entry points against tti's, on two
in-repo checkpoints at the small headline geometry, float32 on the CPU, at
the tolerances of the whole-slice test.
"""

import numpy as np
import pytest
import torch

from tti.parallel.runtime import DualPipeline as JaxDual
from tti_torch.parallel.runtime import DualPipeline
from tti_torch.preprocess.warp2pass import TwoPassWarp
from tests.torch_pair import assert_outputs_match, pipelines

ENV = ("TTI_MASKSTATS_LOGITS", "TTI_REMAP", "TTI_WARP_S2D", "TTI_INPUT_LAYOUT")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _same_outputs(a, b, atol=1e-5):
    np.testing.assert_array_equal(a.valid, b.valid)
    np.testing.assert_allclose(a.scores, b.scores, atol=atol)
    np.testing.assert_allclose(a.boxes_frame, b.boxes_frame, atol=1e-3)
    np.testing.assert_allclose(a.measurements.raw_edge_mm, b.measurements.raw_edge_mm, atol=1e-3)
    np.testing.assert_allclose(a.measurements.raw_width_mm, b.measurements.raw_width_mm, atol=1e-3)


def test_dual_pipeline_matches_tti(ref_intrinsics, clean_env):
    a, ref_a, frames = pipelines("headline", ref_intrinsics)
    b, ref_b, _ = pipelines("headline_b", ref_intrinsics)
    own_weights = b.warp.w1
    dual, ref_dual = DualPipeline(a, b), JaxDual(ref_a, ref_b)
    # One copy of the warp weights: the secondary's is dropped.
    assert b.warp is a.warp and isinstance(a.warp, TwoPassWarp) and b.warp.w1 is not own_weights
    got_a, got_b = dual.process_batch(frames)
    want_a, want_b = ref_dual.process_batch(frames)
    assert_outputs_match(got_a, want_a)
    assert_outputs_match(got_b, want_b)
    assert got_a.valid.sum() >= 2 and got_b.valid.sum() >= 2
    # The two checkpoints are different models: the comparison tells them apart.
    assert not np.allclose(got_a.scores, got_b.scores, atol=1e-3)
    # Each model's dual output is its own single-pipeline output.
    _same_outputs(got_a, a.process_batch(frames))
    _same_outputs(got_b, b.process_batch(frames))
    # The async entry gives the same results once read.
    outs_a, outs_b = dual.process_batch_async(frames)
    _same_outputs(got_a, a.outputs_to_host(outs_a), atol=0)
    _same_outputs(got_b, b.outputs_to_host(outs_b), atol=0)


def test_dual_pipeline_mixed_s2d_input(ref_intrinsics, clean_env):
    """A primary whose model takes the blocked input beside a secondary that
    blocks its own (warp_s2d=False), and the other way round: the shared
    buffer is converted by the exact permutation, and each output equals its
    single-pipeline run."""
    a, _, frames = pipelines("headline", ref_intrinsics)
    b, _, _ = pipelines("headline_b", ref_intrinsics, port_kw=dict(warp_s2d=False))
    assert a.model.s2d_input and not b.model.s2d_input
    assert a.warp.s2d_out and not b.warp.s2d_out
    solo_a, solo_b = a.process_batch(frames), b.process_batch(frames)
    for first, second, solo_1, solo_2 in ((a, b, solo_a, solo_b), (b, a, solo_b, solo_a)):
        dual = DualPipeline(first, second)
        assert second.warp is not first.warp  # other blocking: each keeps its weights
        out_1, out_2 = dual.process_batch(frames)
        _same_outputs(out_1, solo_1)
        _same_outputs(out_2, solo_2)


def test_warp_s2d_off_matches_tti(ref_intrinsics, clean_env):
    clean_env.setenv("TTI_WARP_S2D", "0")
    pipe, ref_pipe, frames = pipelines("headline", ref_intrinsics, port_kw=dict(warp_s2d=False))
    assert not pipe.model.s2d_input and not ref_pipe.model.s2d_input
    x = pipe.preprocess(torch.from_numpy(frames))
    assert x.shape == (2, pipe.spec.dst_h, pipe.spec.dst_w, 3)
    assert_outputs_match(pipe.process_batch(frames), ref_pipe.process_batch(frames))


@pytest.mark.parametrize("reason", ["geometry", "rectification", "calibration"])
def test_dual_pipeline_refusals(ref_intrinsics, reason, clean_env):
    a, _, _ = pipelines("headline", ref_intrinsics)
    if reason == "geometry":
        b, _, _ = pipelines("deploy", ref_intrinsics)
        match = "letterbox geometry"
    elif reason == "rectification":
        b, _, _ = pipelines("headline_b", ref_intrinsics, port_kw=dict(undistort=False),
                            ref_kw=dict(undistort=False))
        assert b.warp is None and float(b.cam.dist.abs().max()) > 0
        match = "undistortion"
    else:
        b, _, _ = pipelines("headline_b", ref_intrinsics,
                            dist=np.array([0.05, 0.0, 0.0, 0.0, 0.0]))
        match = "one calibration"
    with pytest.raises(ValueError, match=match):
        DualPipeline(a, b)


def test_process_batch_async_equals_blocking_and_reuses_two_buffers(ref_intrinsics, clean_env):
    pipe, _, frames = pipelines("headline", ref_intrinsics)
    want = pipe.process_batch(frames)
    seen = set()
    for _ in range(3):
        staged = pipe.staging_batch(frames.shape)
        seen.add(staged.ctypes.data)
        np.copyto(staged, frames)
        _same_outputs(pipe.outputs_to_host(pipe.process_batch_async(staged)), want, atol=0)
    assert len(seen) == 2  # two host buffers, used in turn
    # An array that is not a staging buffer is copied into one.
    _same_outputs(pipe.outputs_to_host(pipe.process_batch_async(frames)), want, atol=0)
