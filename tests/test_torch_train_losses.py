"""The port's assigner and losses against tti.train, values and gradients.

Tolerances: float32 on both sides; elementwise terms 1e-5 relative (1e-6
absolute), reductions over a few thousand terms 1e-5 relative. Assignment
(positives, assigned GT, target classes) is exact; target scores 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.train import assigner as jas
from tti.train import losses as jlo
from tti_torch.train import assigner as tas
from tti_torch.train import losses as tlo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, whatever the host or ``OMP_NUM_THREADS``: the
    chunked and unchunked seg losses are held bit for bit, and from two
    threads on MKL splits the coefficients' gradient product (a sum over
    the grid's cells, one row per anchor) over the threads by the chunk's
    row count, so a chunk of 7 rows and one of 64 sum the same row in
    other orders (up to 9.3e-10 apart at two threads on an 8-core AVX-512
    host). At one thread each row is summed in one order. The suite runs
    in several worker processes at once, so one thread costs little."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T = lambda a: torch.from_numpy(np.asarray(a))


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(1, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_pairwise_iou():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 50), _boxes(rng, 7)
    b[3] = a[5]  # identical pair
    b[4] = [10, 10, 10, 20]  # zero area
    np.testing.assert_allclose(tas.pairwise_iou(T(a), T(b)).numpy(),
                               np.asarray(jas.pairwise_iou(a, b)), rtol=1e-6, atol=1e-7)


def test_bbox_ciou_and_gradient():
    rng = np.random.default_rng(1)
    p, t = _boxes(rng, 200), _boxes(rng, 200)
    t[:20] = p[:20]  # perfect
    t[20:40, :2] = p[20:40, 2:] + 5  # disjoint
    np.testing.assert_allclose(tlo.bbox_ciou(T(p), T(t)).numpy(),
                               np.asarray(jlo.bbox_ciou(p, t)), rtol=1e-5, atol=1e-6)
    # alpha carries no gradient on either side.
    g_ref = jax.grad(lambda x: jnp.sum(jlo.bbox_ciou(x, t) * jnp.arange(200.0)))(p)
    pt = T(p).requires_grad_(True)
    (tlo.bbox_ciou(pt, T(t)) * torch.arange(200.0)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-5)


def test_dfl_loss_and_gradient():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(300, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 17, (300, 4)).astype(np.float32)  # clipped inside
    target[:10] = np.floor(target[:10])  # on a bin
    np.testing.assert_allclose(tlo.dfl_loss(T(logits), T(target)).numpy(),
                               np.asarray(jlo.dfl_loss(logits, target)), rtol=1e-5, atol=1e-6)
    g_ref = jax.grad(lambda x: jnp.sum(jlo.dfl_loss(x, target)))(logits)
    lt = T(logits).requires_grad_(True)
    tlo.dfl_loss(lt, T(target)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)


def _assign_problem(seed, a_side=8, g=6, nc=2):
    """Anchors on an a_side^2 grid of stride 8 (64 px) plus GTs."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:a_side, 0:a_side]
    anchors = (np.stack([xs.ravel(), ys.ravel()], -1) + 0.5).astype(np.float32) * 8
    a = anchors.shape[0]
    pred = np.concatenate([anchors - rng.uniform(2, 20, (a, 2)),
                           anchors + rng.uniform(2, 20, (a, 2))], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (a, nc)).astype(np.float32)
    gt = _boxes(rng, g)
    classes = rng.integers(0, nc, g).astype(np.int32)
    valid = np.ones(g, bool)
    return pred, probs, anchors, gt, classes, valid


def _tie_problem():
    """Every anchor's prediction is the same box and every score equal, so
    the alignment metric ties across anchors inside a GT: membership is
    decided by index. GT 1 is GT 0 again (an anchor claimed by two GTs at
    equal IoU: the lower GT index wins); GT 2 is invalid; GT 3 holds no
    anchor centre."""
    pred, probs, anchors, gt, classes, valid = _assign_problem(7, g=4)
    pred[:] = [8, 8, 40, 40]
    probs[:] = 0.5
    gt[0] = gt[1] = [4, 4, 44, 44]
    gt[2] = [0, 0, 60, 60]
    valid[2] = False
    gt[3] = [1, 1, 3, 3]
    return pred, probs, anchors, gt, classes, valid


CASES = {f"random{s}": (lambda s=s: _assign_problem(s)) for s in range(3)}
CASES["ties_and_double_claims"] = _tie_problem
CASES["no_valid_gt"] = lambda: (lambda p: (*p[:5], np.zeros_like(p[5])))(_assign_problem(4))


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_aligned_assign(case):
    pred, probs, anchors, gt, classes, valid = CASES[case]()
    ref = jas.task_aligned_assign(pred, probs, anchors, gt, classes, valid)
    got = tas.task_aligned_assign(T(pred)[None], T(probs)[None], T(anchors), T(gt)[None],
                                  T(classes)[None], T(valid)[None])
    for key in ("pos_mask", "assigned_gt", "target_classes"):
        np.testing.assert_array_equal(got[key][0].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("target_boxes", "target_scores"):
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    if case == "no_valid_gt":
        assert not got["pos_mask"].any()
    if case == "ties_and_double_claims":
        pos = got["pos_mask"][0].numpy()
        assert pos.sum() == 10  # top-10 of the tied anchors, by index
        assert (got["assigned_gt"][0].numpy()[pos] == 0).all()


def test_task_aligned_assign_batched():
    """Images of a batch are independent: the batched call equals each alone."""
    probs = [_assign_problem(s) for s in (10, 11, 12)]
    stack = lambda i: torch.stack([T(p[i]) for p in probs])
    got = tas.task_aligned_assign(stack(0), stack(1), T(probs[0][2]), stack(3), stack(4), stack(5))
    for b, p in enumerate(probs):
        one = tas.task_aligned_assign(T(p[0])[None], T(p[1])[None], T(p[2]), T(p[3])[None],
                                      T(p[4])[None], T(p[5])[None])
        for key in one:
            assert torch.equal(got[key][b], one[key][0]), key


def _seg_problem(seed, soft=False, a=300, g=6, hm=20, wm=24, nm=8):
    rng = np.random.default_rng(seed)
    coefs = rng.normal(size=(a, nm)).astype(np.float32)
    protos = rng.normal(size=(hm, wm, nm)).astype(np.float32)
    masks = (rng.uniform(size=(g, hm, wm)) if soft else
             (rng.uniform(size=(g, hm, wm)) > 0.5)).astype(np.float32)
    boxes = np.stack([rng.uniform(0, wm / 2, g), rng.uniform(0, hm / 2, g),
                      rng.uniform(wm / 2, wm, g), rng.uniform(hm / 2, hm, g)], -1).astype(np.float32)
    assigned = rng.integers(0, g, a).astype(np.int32)
    pos = rng.uniform(size=a) < 0.15
    weights = rng.uniform(0.5, 2.0, a).astype(np.float32)
    return coefs, protos, masks, boxes, assigned, pos, weights


SEG_CASES = {
    "binary_unchunked": dict(chunk=None),
    "binary_chunked_7": dict(chunk=7),
    "soft_chunked_32": dict(soft=True, chunk=32),
    "soft_weighted": dict(soft=True, weights=True),
    "binary_weighted_chunked_16": dict(weights=True, chunk=16),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_seg_loss_and_gradient(case):
    """Values and gradients (coefs and protos) against tti's seg_loss; the
    port's chunked and unchunked paths agree bit for bit."""
    kw = SEG_CASES[case]
    coefs, protos, masks, boxes, assigned, pos, weights = _seg_problem(
        5, soft=kw.get("soft", False))
    w = weights if kw.get("weights") else None

    def ref_fn(c, p):
        return jlo.seg_loss(c, p, jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(assigned),
                            jnp.asarray(pos), chunk=kw.get("chunk"),
                            anchor_weights=None if w is None else jnp.asarray(w))

    ref, (gc_ref, gp_ref) = jax.value_and_grad(ref_fn, argnums=(0, 1))(coefs, protos)

    def run(chunk):
        c, p = T(coefs).requires_grad_(True), T(protos).requires_grad_(True)
        out = tlo.seg_loss(c[None], p[None], T(masks)[None], T(boxes)[None],
                           T(assigned).long()[None], T(pos)[None], chunk=chunk,
                           anchor_weights=None if w is None else T(w)[None])
        out.sum().backward()
        return out[0], c.grad, p.grad

    got, gc, gp = run(kw.get("chunk"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(gc_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gp_ref), rtol=1e-4, atol=1e-7)
    other = run(None if kw.get("chunk") else 5)
    assert torch.equal(other[0], got) and torch.equal(other[1], gc)


def test_seg_loss_chunks_above_threshold(monkeypatch):
    """The automatic policy: one sample's float32 logits above the 128 MB
    threshold go in chunks of 32 (the deployed recipe's P = 160 on a 480 x
    480 grid: 147 MB); here the threshold is lowered to the small grid."""
    coefs, protos, masks, boxes, assigned, pos, _ = _seg_problem(6)
    calls = []
    real = tlo._seg_per_anchor
    monkeypatch.setattr(tlo, "_seg_per_anchor", lambda c, *a: calls.append(c.shape[1]) or real(c, *a))
    args = (T(coefs)[None], T(protos)[None], T(masks)[None], T(boxes)[None],
            T(assigned).long()[None], T(pos)[None])
    p = 64  # max(64, 10 G) with G = 6
    full = tlo.seg_loss(*args)
    assert calls == [p]
    monkeypatch.setattr(tlo, "_SEG_CHUNK_BYTES", p * 20 * 24 * 4 - 1)
    calls.clear()
    chunked = tlo.seg_loss(*args)
    assert calls == [32, 32]
    assert torch.equal(full, chunked)
    assert 160 * 480 * 480 * 4 > 128 * 1024 * 1024
