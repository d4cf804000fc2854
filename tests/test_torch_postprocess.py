"""The port's DFL decode and fixed-shape NMS against tti."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model.yolo import RawPredictions as JaxRaw
from tti.postprocess import decode as jdec
from tti.postprocess import nms as jnms
from tti_torch.kernels import nms as knms
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
    iou = knms.box_iou_matrix(torch.from_numpy(boxes[0])).numpy()
    kept = []
    for i in order:
        if all(iou[i, k] <= 0.3 for k in kept):
            kept.append(i)
    np.testing.assert_array_equal(got.scores[0, :len(kept)].numpy(), scores[kept])
    assert int(got.valid.sum()) == len(kept)


def test_box_iou_matrix_matches():
    boxes = _nms_inputs(np.random.default_rng(3), b=1, a=50)[0][0]
    np.testing.assert_allclose(knms.box_iou_matrix(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jnms.box_iou_matrix(jnp.asarray(boxes))), atol=1e-6)


def _chain(n, b=2):
    """``n`` unit-height boxes along x, each overlapping the next by IoU 1/3
    and the one after by 0, with falling scores: greedy keeps every other
    box, and each sweep settles about one more link of the chain."""
    x = np.arange(n, dtype=np.float32) * 2.0
    boxes = np.stack([x, np.zeros(n), x + 4.0, np.ones(n)], -1).astype(np.float32)
    probs = np.stack([np.linspace(0.9, 0.3, n), np.zeros(n)], -1).astype(np.float32)
    coefs = np.random.default_rng(4).normal(size=(n, 32)).astype(np.float32)
    rep = lambda a: np.ascontiguousarray(np.broadcast_to(a, (b, *a.shape)))
    return rep(boxes), rep(probs), rep(coefs)


def test_nms_chain_longer_than_a_block_matches_tti():
    """A suppression chain of 48 boxes, longer than the four-sweep blocks the
    step once read the host after, and than the sweeps a real frame takes:
    the reference's sweep needs about one sweep per link (counted with
    ``sweep`` alone); the keep set equals tti's while_loop's exactly."""
    n = 48
    boxes, probs, coefs = _chain(n)
    kw = dict(conf_thresh=0.2, iou_thresh=0.25, max_det=n, pre_topk=n)
    t = [torch.from_numpy(a) for a in (boxes, probs, coefs)]
    blocked = knms.suppression_matrix(t[0], torch.zeros(2, n, dtype=torch.int32), 0.25)
    ok = torch.ones(2, n, dtype=torch.bool)
    keep, sweeps = ok, 0
    while True:
        new = knms.sweep(blocked, ok, keep)
        sweeps += 1
        if torch.equal(new, keep):
            break
        keep = new
    assert sweeps > n // 2
    got = tnms.batched_nms(*t, **kw)
    ref = jnms.batched_nms(*(jnp.asarray(a) for a in (boxes, probs, coefs)), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(ref.boxes))
    assert int(got.valid[0].sum()) == n // 2  # every other box


def test_constants_without_host_copies_are_bit_equal():
    """Box scaling with per-axis Python scalars equals the list-built
    constant tensors it replaced, bit for bit (NaN and inf included)."""
    from tti_torch.preprocess import letterbox as tlb

    rng = np.random.default_rng(6)
    boxes = torch.from_numpy(rng.uniform(-50, 1100, (3, 200, 4)).astype(np.float32))
    boxes[0, 0, 1], boxes[0, 1, 2] = float("nan"), float("inf")
    same = lambda a, b: torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0))
    for spec in (tlb.letterbox_spec(960, 1280, 960), tlb.letterbox_spec(1080, 1920, 640),
                 tlb.letterbox_spec_rect(240, 320, 240)):
        shift = boxes.new_tensor([spec.pad_left, spec.pad_top, spec.pad_left, spec.pad_top])
        limit = boxes.new_tensor([spec.src_w, spec.src_h, spec.src_w, spec.src_h])
        before = torch.minimum(torch.clamp((boxes - shift) / spec.scale, min=0.0), limit)
        assert same(tlb.scale_boxes_to_frame(boxes, spec), before)
    for sx, sy in ((480 / 960, 368 / 736), (160 / 640, 96 / 384), (80 / 320, 60 / 240)):
        before = boxes * boxes.new_tensor([sx, sy, sx, sy])
        assert same(tlb.map_xyxy(boxes, lambda x: x * sx, lambda y: y * sy), before)
