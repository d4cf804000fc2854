"""Kernel D's contract on the CPU: ``greedy_keep`` (here its plain version)
against tti's ``_greedy_suppress`` keep-set, and the lazy decode
(``nms_from_raw``, ``raw_candidate_counts``) against tti's and against the
port's eager decode + NMS, float32. The kernel itself is held to the plain
version on the card (``chip_smoke.py`` phase 3; the ``cuda`` test here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model.yolo import RawPredictions as JaxRaw
from tti.postprocess import nms as jnms
from tti_torch.kernels import nms as knms
from tti_torch.model.yolo import RawPredictions
from tti_torch.postprocess import decode as tdec
from tti_torch.postprocess import nms as tnms


def _candidates(rng, b=3, k=96, nc=2, spread=120.0, ties=None):
    """Score-sorted candidates: boxes, falling scores (``ties``: that many
    equal-score runs), classes, ok (a few invalid at the tail) and coefs
    whose first entry is the candidate's rank."""
    xy = rng.uniform(0, spread, (b, k, 2))
    wh = rng.uniform(4, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.21, 0.99, (b, k)), axis=1)[:, ::-1].astype(np.float32)
    if ties:
        scores = (np.ceil(scores * ties) / ties).astype(np.float32)
    classes = rng.integers(0, nc, (b, k)).astype(np.int32)
    ok = np.ones((b, k), bool)
    ok[:, k - k // 8:] = False
    scores = np.where(ok, scores, -1.0).astype(np.float32)
    coefs = np.zeros((b, k, 4), np.float32)
    coefs[..., 0] = np.arange(k, dtype=np.float32)
    return boxes, scores, classes, ok, coefs


def _tti_keep(boxes, scores, classes, ok, coefs, iou, class_aware):
    """tti's keep-set: ``_greedy_suppress`` with room for every candidate;
    the kept ranks come back through the first coefficient."""
    k = boxes.shape[1]
    keep = np.zeros(ok.shape, bool)
    for f in range(boxes.shape[0]):
        d = jnms._greedy_suppress(jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
                                  jnp.asarray(classes[f]), jnp.asarray(coefs[f]),
                                  jnp.asarray(ok[f]), iou, k, class_aware)
        valid = np.asarray(d.valid)
        keep[f, np.asarray(d.coefs)[valid, 0].astype(int)] = True
    return keep


def _port_keep(boxes, classes, ok, iou, class_aware):
    return knms.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(classes),
                            torch.from_numpy(ok), iou, class_aware).numpy()


@pytest.mark.parametrize("case", ["seeded", "class_blind", "negative_threshold", "ties"])
def test_greedy_keep_equals_tti_keep_set(case):
    rng = np.random.default_rng({"seeded": 0, "class_blind": 1, "negative_threshold": 2,
                                 "ties": 3}[case])
    boxes, scores, classes, ok, coefs = _candidates(rng, ties=8 if case == "ties" else None)
    iou = {"negative_threshold": -0.25}.get(case, 0.3)
    class_aware = case != "class_blind"
    got = _port_keep(boxes, classes, ok, iou, class_aware)
    np.testing.assert_array_equal(got, _tti_keep(boxes, scores, classes, ok, coefs, iou,
                                                 class_aware))
    assert got.sum() > 0 and not got[~ok].any()
    if case == "negative_threshold":
        # (same class ? iou : 0) > -0.25 holds for every pair: one box kept.
        assert (got.sum(1) == 1).all()


def test_greedy_suppress_with_tied_scores_equals_tti():
    """Tied scores: the kept rows come out in rank order, as jax.lax.top_k
    puts them, every field equal."""
    boxes, scores, classes, ok, coefs = _candidates(np.random.default_rng(4), ties=6)
    got = tnms.greedy_suppress(*(torch.from_numpy(a) for a in (boxes, scores, classes, coefs, ok)),
                               0.3, 50)
    for f in range(boxes.shape[0]):
        ref = jnms._greedy_suppress(*(jnp.asarray(a[f]) for a in (boxes, scores, classes, coefs,
                                                                   ok)), 0.3, 50, True)
        for key in ("valid", "scores", "classes", "boxes", "coefs"):
            np.testing.assert_array_equal(getattr(got, key)[f].numpy(),
                                          np.asarray(getattr(ref, key)), err_msg=key)


def test_chain_of_64_boxes_keeps_every_other():
    """A suppression chain longer than 40 boxes: each box overlaps the next
    (IoU 1/3) and not the one after; greedy keeps every other box, and the
    reference's sweep needs about one sweep per link to see it."""
    n = 64
    x = np.arange(n, dtype=np.float32) * 2.0
    boxes = np.stack([x, np.zeros(n), x + 4.0, np.ones(n)], -1).astype(np.float32)[None]
    classes = np.zeros((1, n), np.int32)
    ok = np.ones((1, n), bool)
    scores = np.linspace(0.9, 0.3, n, dtype=np.float32)[None]
    coefs = np.zeros((1, n, 4), np.float32)
    coefs[..., 0] = np.arange(n)
    got = _port_keep(boxes, classes, ok, 0.25, True)
    np.testing.assert_array_equal(got[0], np.arange(n) % 2 == 0)
    np.testing.assert_array_equal(got, _tti_keep(boxes, scores, classes, ok, coefs, 0.25, True))


def test_degenerate_candidates():
    """Every candidate invalid; every box identical; zero-area boxes (IoU 0
    with everything: all kept)."""
    k = 40
    same = np.tile(np.array([10, 10, 30, 30], np.float32), (1, k, 1))
    zeros = np.tile(np.array([5, 5, 5, 9], np.float32), (1, k, 1))
    classes = np.zeros((1, k), np.int32)
    ok = np.ones((1, k), bool)
    assert not _port_keep(same, classes, ~ok, 0.25, True).any()
    np.testing.assert_array_equal(_port_keep(same, classes, ok, 0.25, True)[0],
                                  np.arange(k) == 0)
    assert _port_keep(zeros, classes, ok, 0.25, True).all()


def test_greedy_keep_checks_its_inputs():
    boxes, _, classes, ok, _ = _candidates(np.random.default_rng(5), b=1, k=8)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="B, K, 4"):
        knms.greedy_keep(t(boxes[..., :3]), t(classes), t(ok), 0.3)
    with pytest.raises(TypeError, match="bool"):
        knms.greedy_keep(t(boxes), t(classes), t(ok).int(), 0.3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        knms.greedy_keep(t(boxes).to("meta"), t(classes).to("meta"), t(ok).to("meta"), 0.3)
    before = dict(knms.LAUNCHES)
    knms.greedy_keep(t(boxes), t(classes), t(ok), 0.3)
    assert knms.LAUNCHES == before  # the plain version counts no launch


def _raw(seed, b=2, hw=((12, 16), (6, 8), (3, 4)), nc=2, nm=32):
    rng = np.random.default_rng(seed)
    mk = lambda c, s: [(rng.normal(size=(b, h, w, c)) * s).astype(np.float32) for h, w in hw]
    box, cls, coef = mk(64, 2.0), mk(nc, 1.5), mk(nm, 1.0)
    protos = rng.normal(size=(b, 24, 32, nm)).astype(np.float32)
    t = lambda xs: tuple(torch.from_numpy(x) for x in xs)
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)
    return (RawPredictions(t(box), t(cls), t(coef), torch.from_numpy(protos)),
            JaxRaw(j(box), j(cls), j(coef), jnp.asarray(protos)))


@pytest.mark.parametrize("kw", [dict(conf_thresh=0.20, iou_thresh=0.25, max_det=200,
                                     pre_topk=256),
                                dict(conf_thresh=0.5, iou_thresh=0.45, max_det=40, pre_topk=64)])
def test_nms_from_raw_matches_tti_and_eager(kw):
    """Lazy decode against tti's (boxes within 1e-4 px: float32 softmax on
    either side) and against the port's eager decode + NMS (equal: the same
    arithmetic on the same rows)."""
    raw, jraw = _raw(6)
    got = tnms.nms_from_raw(raw, **kw)
    ref = jnms.nms_from_raw(jraw, **kw)
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(ref, key)))
    for key in ("scores", "boxes", "coefs"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(ref, key)),
                                   atol=1e-4, err_msg=key)
    eager = tnms.batched_nms(*tdec.decode_predictions(raw), **kw)
    for key in ("valid", "classes", "scores", "boxes", "coefs"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), getattr(eager, key).numpy(),
                                      err_msg=key)
    assert 0 < int(got.valid.sum())
    counts = tnms.raw_candidate_counts(raw, kw["conf_thresh"])
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jnms.raw_candidate_counts(jraw, kw["conf_thresh"])))
    probs = tdec.decode_predictions(raw)[1]
    np.testing.assert_array_equal(counts.numpy(),
                                  (probs.amax(-1) > kw["conf_thresh"]).sum(-1).numpy())


@pytest.mark.parametrize("conf", [0.0, 1.0])
def test_raw_candidate_counts_at_the_ends(conf):
    raw, jraw = _raw(7, b=1)
    np.testing.assert_array_equal(tnms.raw_candidate_counts(raw, conf).numpy(),
                                  np.asarray(jnms.raw_candidate_counts(jraw, conf)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 512, 1000, 2048])
def test_kernel_matches_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    boxes, _, classes, ok, _ = _candidates(np.random.default_rng(k), b=4, k=k, spread=300.0)
    args = [torch.from_numpy(a).cuda() for a in (boxes, classes, ok)]
    got = knms.greedy_keep(*args, 0.3)
    again = knms.greedy_keep(*args, 0.3)
    ref = knms.greedy_keep_plain(*args, 0.3)
    assert torch.equal(got, ref) and torch.equal(got, again)
