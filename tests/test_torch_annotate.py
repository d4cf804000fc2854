"""Annotation and the result contract against tti's: the same pixels from
``annotate_frame`` with cv2 and with cv2 blocked (the numpy fallback),
``envelope_to_polyline``, ``draw_measurement_geometry``,
``draw_fabric_contours``, ``measurement_to_dict`` and ``overlay_masks``.

``overlay_masks`` is the one deliberate difference: the port takes the proto
stride from the mask grid, tti repeats every cell 4x. Equal at stride 4; at
stride 2 the port's overlay is the mask upsampled by 2, tti's is not.
"""

from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import tti.app.annotate as jann
import tti.app.results as jres
import tti.measure.pipeline as jmp
from tti.preprocess.letterbox import make_letterbox_spec as jax_letterbox_spec
import tti_torch.app.annotate as tann
import tti_torch.app.results as tres
import tti_torch.measure.pipeline as tmp
import tti_torch.preprocess.letterbox as tlb


def _frame(h=96, w=128, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _detections(seed=1, n=7, h=96, w=128):
    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(-10, w, n), rng.uniform(-10, h, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 40, n), y1 + rng.uniform(2, 30, n)], -1)
    return boxes.astype(np.float32), rng.integers(0, 2, n).astype(np.int32), rng.random(n) > 0.3


@pytest.mark.parametrize("with_cv2", [True, False], ids=["cv2", "numpy"])
def test_annotate_frame_equal(with_cv2, monkeypatch):
    if not with_cv2:
        for mod in (jann, tann):
            monkeypatch.setattr(mod, "_HAS_CV2", False)
            monkeypatch.setattr(mod, "cv2", None)
    frame = _frame()
    boxes, classes, valid = _detections()
    env = np.stack([np.linspace(0, 127, 40), 50 + 5 * np.sin(np.arange(40))], -1)
    kw = dict(envelope_frame_xy=env, roi_bounds=(10, 20, 118, 80), hud_lines=["Seam: 6.50mm", "x"])
    got = tann.annotate_frame(frame, boxes, classes, valid, 0, 1, **kw)
    want = jann.annotate_frame(frame, boxes, classes, valid, 0, 1, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != frame).any() and (frame == _frame()).all()


@pytest.mark.parametrize("stride", [4, 2])
def test_envelope_to_polyline_equal(stride):
    spec_t = tlb.make_letterbox_spec(960, 1280, 960, "rect")
    spec_j = jax_letterbox_spec(960, 1280, 960, "rect")
    wm = spec_t.dst_w // stride
    rng = np.random.default_rng(stride)
    env = rng.uniform(10, spec_t.dst_h / stride - 1, wm).astype(np.float32)
    env[rng.random(wm) < 0.2] = -1
    got = tann.envelope_to_polyline(env, spec_t)
    np.testing.assert_array_equal(got, jann.envelope_to_polyline(env, spec_j))
    assert got.shape == ((env >= 0).sum(), 2)
    assert tann.envelope_to_polyline(np.full(wm, -1.0), spec_t).shape == (0, 2)


def test_measurement_geometry_and_contours_equal():
    rng = np.random.default_rng(3)
    s = 6
    stitches = tmp.StitchSet(cx=rng.uniform(10, 110, (2, s)), cy=rng.uniform(10, 80, (2, s)),
                             left=rng.uniform(5, 60, (2, s)), right=rng.uniform(60, 120, (2, s)),
                             valid=rng.random((2, s)) > 0.3)
    env_y = lambda cx: None if cx > 100 else 40.0 + 0.1 * cx
    got = tann.draw_measurement_geometry(_frame(), stitches, env_y, index=1)
    want = jann.draw_measurement_geometry(_frame(), stitches, env_y, index=1)
    np.testing.assert_array_equal(got, want)
    fabric = np.zeros((96, 128), np.uint8)
    fabric[50:, 10:100] = 1
    np.testing.assert_array_equal(tann.draw_fabric_contours(_frame(), fabric),
                                  jann.draw_fabric_contours(_frame(), fabric))


@pytest.mark.parametrize("index", [None, 0, 1, 2])
def test_measurement_to_dict_equal(index):
    fields = dict(edge_distance_mm=[6.5, np.nan, 7.25], stitch_width_mm=[3.9, np.nan, np.nan],
                  raw_edge_mm=[6.4, np.nan, 7.0], raw_width_mm=[3.8, np.nan, np.nan],
                  n_dist=[5, 0, 2], n_width=[5, 0, 0], n_stitches=[5, 3, 0],
                  fabric_detected=[True, False, True])
    pick = (lambda v: v) if index is not None else (lambda v: v[0])
    got_meas = tmp.FrameMeasurement(**{k: pick(np.asarray(v, np.float32 if "mm" in k else None))
                                       for k, v in fields.items()})
    want_meas = jmp.FrameMeasurement(**{k: pick(jnp.asarray(v)) for k, v in fields.items()})
    now = datetime(2026, 1, 2, 3, 4, 5)
    got = tres.measurement_to_dict(got_meas, index=index, now=now)
    assert got == jres.measurement_to_dict(want_meas, index=index, now=now)
    assert set(got) >= {"edge_distance_mm", "stitch_width_mm", "stitch_count", "timestamp"}


def _overlay_case(stride, seed=4):
    frame_hw, imgsz = (120, 160), 160
    spec_t = tlb.make_letterbox_spec(*frame_hw, imgsz, "square")
    spec_j = jax_letterbox_spec(*frame_hw, imgsz, "square")
    hm, wm = spec_t.dst_h // stride, spec_t.dst_w // stride
    rng = np.random.default_rng(seed)
    masks = np.zeros((3, hm, wm), np.float32)
    for i in range(3):  # one blob per detection, logits > 0 inside
        y0, x0 = rng.integers(hm // 4, hm // 2), rng.integers(0, wm // 2)
        masks[i, y0:y0 + hm // 4, x0:x0 + wm // 3] = 1.0
    classes = np.array([0, 1, 0], np.int32)
    valid = np.array([True, True, False])
    return _frame(*frame_hw), masks, classes, valid, spec_t, spec_j


def _expected_overlay(frame, masks, classes, valid, spec, q, alpha=0.30,
                      palette=((0, 200, 255), (255, 0, 255), (0, 255, 0), (255, 128, 0))):
    h, w = frame.shape[:2]
    layer = np.zeros_like(frame)
    hit = np.zeros((h, w), bool)
    for m, c, ok in zip(masks, classes, valid):
        if not ok:
            continue
        up = np.repeat(np.repeat(m > 0, q, 0), q, 1)
        content = up[spec.pad_top:spec.pad_top + spec.new_h, spec.pad_left:spec.pad_left + spec.new_w]
        full = cv2.resize(content.astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST) > 0
        layer[full] = palette[int(c) % len(palette)]
        hit |= full
    out = frame.copy()
    out[hit] = (alpha * layer[hit] + (1 - alpha) * out[hit]).astype(np.uint8)
    return out


def test_overlay_masks_stride4_equal():
    frame, masks, classes, valid, spec_t, spec_j = _overlay_case(4)
    got = tann.overlay_masks(frame, masks, classes, valid, spec_t)
    np.testing.assert_array_equal(got, jann.overlay_masks(frame, masks, classes, valid, spec_j))
    np.testing.assert_array_equal(got, _expected_overlay(frame, masks, classes, valid, spec_t, 4))


def test_overlay_masks_stride2_takes_stride_from_grid():
    """The stride-2 grid: the port draws each mask upsampled by 2; tti
    repeats cells 4x and draws the top-left quarter of the grid stretched
    over the frame."""
    frame, masks, classes, valid, spec_t, spec_j = _overlay_case(2)
    got = tann.overlay_masks(frame, masks, classes, valid, spec_t)
    np.testing.assert_array_equal(got, _expected_overlay(frame, masks, classes, valid, spec_t, 2))
    ref = jann.overlay_masks(frame, masks, classes, valid, spec_j)
    np.testing.assert_array_equal(ref, _expected_overlay(frame, masks, classes, valid, spec_t, 4))
    assert (got != ref).any()
