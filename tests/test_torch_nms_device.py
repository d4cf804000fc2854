"""Kernel D's contract on the CPU: ``greedy_keep`` (here its plain version)
against tti's ``_greedy_suppress`` keep-set, and the lazy decode
(``nms_from_raw``, ``raw_candidate_counts``) against tti's and against the
port's eager decode + NMS, float32; the kernel's launch shape
(``cluster_size``) and its decomposition (``_greedy_keep_by_words`` here:
rows packed tile by tile, 32 ranks decided per step) against the plain
version.
The kernel itself is held to the plain version on the card (``chip_smoke.py``
phase 3; the ``cuda`` test here)."""

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


# Kernel D's launch shape and decomposition (csrc/nms.cu), on the CPU.

def _pass1_tile(t: int) -> tuple[int, int]:
    """Pass 1's tile ``t`` -> (row block r, word w), ``t = r (r + 1) / 2 +
    w`` with ``w <= r``, as the kernel computes it (a float square root,
    then corrected)."""
    r = int((np.sqrt(np.float32(8 * t + 1), dtype=np.float32) - np.float32(1))
            * np.float32(0.5))
    while r * (r + 1) // 2 > t:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= t:
        r += 1
    return r, t - r * (r + 1) // 2


def _greedy_keep_by_words(cand_boxes, cand_classes, cand_ok, iou_thresh: float,
                          class_aware: bool = True) -> torch.Tensor:
    """Kernel D's decomposition in plain PyTorch (held here to
    ``greedy_keep_plain``): the overlap rows packed into 32-bit words
    tile by tile (:func:`_pass1_tile`), then 32 ranks decided per step: the
    word's candidates blocked by a kept rank of an earlier word, then, in
    rank order, those of the word's remaining candidates whose in-word row
    meets a kept one."""
    b, k = cand_ok.shape
    nw = (k + 31) // 32
    blocked = knms.suppression_matrix(cand_boxes, cand_classes, iou_thresh, class_aware)
    pad = torch.zeros(b, 32 * nw, 32 * nw, dtype=torch.bool)
    pad[:, :k, :k] = blocked
    weights = torch.tensor([1 << n for n in range(32)], dtype=torch.int64)
    pack = lambda bits: (bits.long() * weights).sum(-1)  # (..., 32) bool -> word
    rows = torch.zeros(b, 32 * nw, nw, dtype=torch.int64)  # row i, word w
    for t in range(nw * (nw + 1) // 2):
        r, w = _pass1_tile(t)
        rows[:, 32 * r:32 * r + 32, w] = pack(pad[:, 32 * r:32 * r + 32, 32 * w:32 * w + 32])
    okw = pack(torch.nn.functional.pad(cand_ok, (0, 32 * nw - k)).view(b, nw, 32))
    keep = torch.zeros(b, 32 * nw, dtype=torch.bool)
    for f in range(b):
        kept = []
        for w in range(nw):
            lanes = rows[f, 32 * w:32 * w + 32]
            outside = torch.zeros(32, dtype=torch.int64)
            for v in range(w):
                outside |= lanes[:, v] & kept[v]
            word = int(okw[f, w]) & ~int(pack(outside != 0))
            inword = lanes[:, w]
            todo = word & int(pack((inword & word) != 0))
            for lane in range(32):
                if todo >> lane & 1 and int(inword[lane]) & word:
                    word &= ~(1 << lane)
            kept.append(word)
            keep[f, 32 * w:32 * w + 32] = (torch.tensor(word) >> torch.arange(32)) & 1 == 1
    return keep[:, :k]


@pytest.mark.parametrize("b", [1, 2, 8, 128, 1024])
def test_cluster_size_is_a_function_of_b_and_k(b):
    """Blocks per frame: a power of two up to 8, no more than pass 1's tiles
    need (16 warps a block), the launch within the card's 132 SMs in one
    wave, and 1 where the frames alone fill the card."""
    for k in (1, 32, 200, 256, 1000, 2048, 8192):
        c = knms.cluster_size(b, k)
        nw = (k + 31) // 32
        assert c in (1, 2, 4, 8) and c <= knms.MAX_CLUSTER
        assert c == 1 or (b * c <= knms.SMS and 16 * (c // 2) < nw * (nw + 1) // 2)
        assert c == knms.cluster_size(b, k, sms=132)  # pure: the same again
        if b * 2 > knms.SMS or k <= 32:
            assert c == 1
        elif b * 8 <= knms.SMS and k >= 512:
            assert c == 8
    assert [knms.cluster_size(1, k) for k in (32, 200, 256, 512)] == [1, 2, 4, 8]
    assert knms.cluster_size(2, 256, sms=4) == 2 and knms.cluster_size(128, 256, sms=1024) == 4


def test_pass1_tiles_cover_the_triangle():
    nw = 40
    seen = [_pass1_tile(t) for t in range(nw * (nw + 1) // 2)]
    assert seen == [(r, w) for r in range(nw) for w in range(r + 1)]


@pytest.mark.parametrize("case", ["seeded", "class_blind", "negative_threshold", "ties",
                                  "nan_threshold", "chain"])
def test_word_decomposition_equals_plain(case):
    """The kernel's decomposition (rows packed tile by tile, 32 ranks
    decided per step) against the plain version, K not a multiple of 32."""
    rng = np.random.default_rng(10 + len(case))
    k = 100
    boxes, _, classes, ok, _ = _candidates(rng, b=2, k=k, ties=8 if case == "ties" else None)
    iou = {"negative_threshold": -0.25, "nan_threshold": float("nan")}.get(case, 0.3)
    if case == "chain":  # each box overlaps the next: every other one kept
        x = np.arange(k, dtype=np.float32)[None, :] * 2.0
        boxes = np.stack([x, 0 * x, x + 4.0, 0 * x + 1.0], -1).repeat(2, 0)
        ok[:] = True
        classes[:] = 0
        iou = 0.25
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (boxes, classes, ok)]
    got = _greedy_keep_by_words(*args, iou, case != "class_blind")
    assert torch.equal(got, knms.greedy_keep_plain(*args, iou, case != "class_blind"))
    if case == "chain":
        assert got.sum(1).tolist() == [k // 2] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 256, 512, 1000, 2048, 8192])
def test_kernel_matches_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    boxes, _, classes, ok, _ = _candidates(np.random.default_rng(k), b=4, k=k, spread=300.0)
    args = [torch.from_numpy(a).cuda() for a in (boxes, classes, ok)]
    got = knms.greedy_keep(*args, 0.3)
    again = knms.greedy_keep(*args, 0.3)
    ref = knms.greedy_keep_plain(*args, 0.3)
    assert torch.equal(got, ref) and torch.equal(got, again)
