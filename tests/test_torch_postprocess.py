"""The port's DFL decode and fixed-shape NMS against tti."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model.yolo import RawPredictions as JaxRaw
from tti.postprocess import decode as jdec
from tti.postprocess import nms as jnms
from tti_torch.model.yolo import RawPredictions
from tti_torch.postprocess import decode as tdec
from tti_torch.postprocess import nms as tnms


def _raw(rng, b=2, hw=((8, 10), (4, 5), (2, 3)), nc=2, nm=32):
    mk = lambda c: [rng.normal(size=(b, h, w, c)).astype(np.float32) * 2 for h, w in hw]
    box, cls, coef = mk(64), mk(nc), mk(nm)
    protos = rng.normal(size=(b, 16, 20, nm)).astype(np.float32)
    t = lambda xs: tuple(torch.from_numpy(x) for x in xs)
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)
    return (RawPredictions(t(box), t(cls), t(coef), torch.from_numpy(protos)),
            JaxRaw(j(box), j(cls), j(coef), jnp.asarray(protos)))


def test_decode_matches():
    """float32 softmax expectation and sigmoid; 1e-4 px on boxes of ~100 px."""
    raw, jraw = _raw(np.random.default_rng(0))
    got = tdec.decode_predictions(raw)
    ref = jdec.decode_predictions(jraw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    pts, strides = tdec.make_anchors(((2, 3), (1, 2)), (8, 16))
    rpts, rstr = jdec.make_anchors(((2, 3), (1, 2)), (8, 16))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(rpts))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(rstr))


def _nms_inputs(rng, b=3, a=400, tie_levels=None):
    xy = rng.uniform(0, 200, (b, a, 2))
    wh = rng.uniform(5, 60, (b, a, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (b, a, 2)).astype(np.float32)
    if tie_levels:  # many exactly equal scores: tie order decides the keep-set
        probs = (np.floor(probs * tie_levels) / tie_levels + 0.05).astype(np.float32)
        boxes[:, 1::2] = boxes[:, ::2]  # duplicate boxes with tied scores
    coefs = rng.normal(size=(b, a, 32)).astype(np.float32)
    return boxes, probs, coefs


@pytest.mark.parametrize("ties", [None, 8])
@pytest.mark.parametrize("kw", [dict(conf_thresh=0.20, iou_thresh=0.25, max_det=200, pre_topk=256),
                                dict(conf_thresh=0.5, iou_thresh=0.5, max_det=300, pre_topk=128)])
def test_nms_keep_sets_equal(ties, kw):
    boxes, probs, coefs = _nms_inputs(np.random.default_rng(1), tie_levels=ties)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(probs),
                           torch.from_numpy(coefs), **kw)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(probs), jnp.asarray(coefs), **kw)
    assert got.valid.shape == (3, kw["max_det"])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_array_equal(got.coefs.numpy(), np.asarray(ref.coefs))
    assert got.valid.sum() > 0


def test_greedy_keep_set_matches_sequential_greedy():
    """The fixed-point sweep keeps exactly what one-at-a-time greedy keeps."""
    rng = np.random.default_rng(2)
    boxes, probs, coefs = _nms_inputs(rng, b=1, a=120)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(probs),
                           torch.from_numpy(coefs), conf_thresh=0.2, iou_thresh=0.3,
                           max_det=120, pre_topk=120, class_aware=False)
    scores = probs[0].max(-1)
    order = np.argsort(-scores, kind="stable")
    order = order[scores[order] > 0.2]
    iou = tnms.box_iou_matrix(torch.from_numpy(boxes[0])).numpy()
    kept = []
    for i in order:
        if all(iou[i, k] <= 0.3 for k in kept):
            kept.append(i)
    np.testing.assert_array_equal(got.scores[0, :len(kept)].numpy(), scores[kept])
    assert int(got.valid.sum()) == len(kept)


def test_box_iou_matrix_matches():
    boxes = _nms_inputs(np.random.default_rng(3), b=1, a=50)[0][0]
    np.testing.assert_allclose(tnms.box_iou_matrix(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jnms.box_iou_matrix(jnp.asarray(boxes))), atol=1e-6)
