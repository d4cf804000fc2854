"""The port's measurement pass against tti's: ops, prepare_frame_inputs,
measure_frame and smooth_measurement on the same seeded inputs.

The port carries the frame axis as a batch; tti's single-frame functions
run under jax.vmap, as tti's runtime runs them. Mask statistics use
quantized protos/coefs (exact logits), so the stitch geometry differs only
by float32 op order: 1e-4 px, and 1e-3 mm after the px->mm projection.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.calib.io import CalibrationData as JaxCalib
from tti.core.config import MeasureConfig as JaxMeasureConfig
from tti.measure import ops as jops
from tti.measure import pipeline as jmp
from tti.postprocess.decode import Detections as JaxDets
from tti_torch.calib.io import CalibrationData
from tti_torch.core.config import MeasureConfig
from tti_torch.measure import ops as tops
from tti_torch.measure import pipeline as tmp
from tti_torch.postprocess.decode import Detections
from tti_torch.preprocess.letterbox import make_letterbox_spec

jlb = importlib.import_module("tti.preprocess.letterbox")


def test_ops_match():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(4, 9)).astype(np.float32) * 50
    vals[2, :4] = vals[2, 4]  # ties
    mask = rng.uniform(size=(4, 9)) > 0.4
    mask[3] = False
    for fn_t, fn_j in ((tops.masked_median, jops.masked_median),
                       (tops.masked_mean, jops.masked_mean)):
        got = fn_t(torch.from_numpy(vals), torch.from_numpy(mask))
        ref = fn_j(jnp.asarray(vals), jnp.asarray(mask))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    labels, (c0, c1) = tops.kmeans_1d_two_clusters(torch.from_numpy(vals), torch.from_numpy(mask))
    for i in range(4):
        rl, (r0, r1) = jops.kmeans_1d_two_clusters(jnp.asarray(vals[i]), jnp.asarray(mask[i]))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(rl))
        np.testing.assert_allclose([c0[i], c1[i]], [r0, r1], rtol=1e-6)


SPEC_ARGS = (240, 320, 240, "rect")  # 192x256 model input, scale 0.8


def _detections(seed, b=2, d=80, hm=96, wm=128):
    """Detections in model-input px, ties in scores, some invalid rows, and
    quantized protos/coefs."""
    rng = np.random.default_rng(seed)
    spec = make_letterbox_spec(*SPEC_ARGS)
    xy = rng.uniform(0, [spec.dst_w - 20, spec.dst_h - 20], (b, d, 2))
    wh = rng.uniform(6, 60, (b, d, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 0] = [0, 80, spec.dst_w, spec.dst_h]  # a fabric-like full-width box
    scores = (np.round(rng.uniform(0.2, 1.0, (b, d)) * 20) / 20).astype(np.float32)
    valid = rng.uniform(size=(b, d)) > 0.15
    classes = np.where(valid, (rng.uniform(size=(b, d)) > 0.7).astype(np.int32), -1)
    classes[:, 0] = 1
    valid[:, 0] = True
    coefs = (rng.integers(-128, 129, (b, d, 32)) / 64).astype(np.float32)
    protos = (rng.integers(-255, 256, (b, hm, wm, 32)) / 128).astype(np.float32)
    arrays = dict(boxes=boxes, scores=scores, classes=classes.astype(np.int32), coefs=coefs,
                  valid=valid)
    tdets = Detections(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jdets = JaxDets(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return tdets, jdets, protos


ROI = (10.0, 40.0, 300.0, 230.0)


@pytest.mark.parametrize("subcell,subcell_env", [(False, None), (True, None), (True, False)])
def test_prepare_frame_inputs_matches(subcell, subcell_env, monkeypatch):
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    tdets, jdets, protos = _detections(1)
    spec, jspec = make_letterbox_spec(*SPEC_ARGS), jlb.make_letterbox_spec(*SPEC_ARGS)
    got = tmp.prepare_frame_inputs(tdets, torch.from_numpy(protos), spec, 0, 1, ROI, 16, 64,
                                   subcell=subcell, subcell_envelope=subcell_env)
    ref = jax.vmap(lambda d, p: jmp.prepare_frame_inputs(
        d, p, jspec, 0, 1, ROI, 16, 64, subcell=subcell, subcell_envelope=subcell_env))(
        jdets, jnp.asarray(protos))
    for field in ("cx", "cy", "left", "right"):
        np.testing.assert_allclose(getattr(got[0], field).numpy(),
                                   np.asarray(getattr(ref[0], field)), atol=1e-4, err_msg=field)
    np.testing.assert_array_equal(got[0].valid.numpy(), np.asarray(ref[0].valid))
    assert got[1].dtype == (torch.float32 if (subcell_env is None and subcell) else torch.int32)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for key in ref[3]:
        np.testing.assert_array_equal(got[3][key].numpy(), np.asarray(ref[3][key]), err_msg=key)
    assert got[0].valid.sum() > 0 and got[2].all()


def _cams(ref_intrinsics, ref_extrinsics, rectified):
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= 320 / 1280.0
    K[1] *= 240 / 960.0
    rvec, tvec = ref_extrinsics
    cam = tmp.CameraParams.from_calibration(CalibrationData(K=K, dist=dist, rvec=rvec, tvec=tvec),
                                            device="cpu")
    jcam = jmp.CameraParams.from_calibration(JaxCalib(K=K, dist=dist, rvec=rvec, tvec=tvec))
    if rectified:
        cam = dataclasses.replace(cam, dist=torch.zeros(5))
        jcam = jcam.replace(dist=jnp.zeros(5, jnp.float32))
    return cam, jcam


@pytest.mark.parametrize("cfg_kw", [dict(), dict(skip_cluster=True),
                                    dict(subcell_edge=True, undistort_iters=0),
                                    dict(min_stitches=2, cal_edge_mm=0.12, cal_width_mm=-0.05)])
def test_measure_frame_matches(cfg_kw, ref_intrinsics, ref_extrinsics, monkeypatch):
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    cfg_kw = {"min_stitches": 1, **cfg_kw}
    subcell = bool(cfg_kw.get("subcell_edge"))
    tdets, jdets, protos = _detections(2)
    jspec = jlb.make_letterbox_spec(*SPEC_ARGS)
    stitches, env, fab, _ = jax.vmap(lambda d, p: jmp.prepare_frame_inputs(
        d, p, jspec, 0, 1, ROI, 16, 64, subcell=subcell))(jdets, jnp.asarray(protos))
    cam, jcam = _cams(ref_intrinsics, ref_extrinsics, rectified=cfg_kw.get("undistort_iters") == 0)
    cfg, jcfg = MeasureConfig(**cfg_kw), JaxMeasureConfig(**cfg_kw)
    ref = jax.vmap(lambda s, e, f: jmp.measure_frame(s, e, f, jcam, jspec, jcfg))(stitches, env, fab)
    t = lambda a: torch.from_numpy(np.array(a))
    tst = tmp.StitchSet(**{f.name: t(getattr(stitches, f.name))
                           for f in dataclasses.fields(tmp.StitchSet)})
    got = tmp.measure_frame(tst, t(env), t(fab), cam, make_letterbox_spec(*SPEC_ARGS), cfg)
    for field in ("raw_edge_mm", "raw_width_mm", "edge_distance_mm", "stitch_width_mm"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-3, err_msg=field)
    for field in ("n_dist", "n_width", "n_stitches", "fabric_detected"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert np.isfinite(got.raw_width_mm.numpy()).any()


def test_smooth_measurement_matches():
    seq = np.array([5.0, np.nan, 5.5, 4.0, np.nan, 6.0, 5.2, 5.1, 4.9, 7.0, 6.5, np.nan],
                   np.float32)
    state = tmp.init_measure_state(4, device="cpu")
    jstate = jmp.init_measure_state(4)
    for i, v in enumerate(seq):
        w = seq[(i + 3) % len(seq)]
        vals = dict(raw_edge_mm=v, raw_width_mm=w, edge_distance_mm=v, stitch_width_mm=w,
                    n_dist=3, n_width=3, n_stitches=3, fabric_detected=True)
        meas = tmp.FrameMeasurement(**{k: torch.tensor(x) for k, x in vals.items()})
        jmeas = jmp.FrameMeasurement(**{k: jnp.asarray(x) for k, x in vals.items()})
        state, out = tmp.smooth_measurement(state, meas)
        jstate, jout = jmp.smooth_measurement(jstate, jmeas)
        for field in ("edge_distance_mm", "stitch_width_mm"):
            np.testing.assert_allclose(float(getattr(out, field)),
                                       float(getattr(jout, field)), rtol=1e-6)
        np.testing.assert_allclose(state.dist_buf.numpy(), np.asarray(jstate.dist_buf))
        assert int(state.width_n) == int(jstate.width_n)
