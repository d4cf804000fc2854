"""The port's mask assembly (tti_torch.postprocess.masks) and the model's
blocking permutations against tti's, on seeded numpy inputs; then the
pipeline with ``return_masks=True``. atol 1e-6: one float32 sigmoid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model.yolo import depth_to_space2 as jax_d2s, space_to_depth2 as jax_s2d
from tti.postprocess import masks as jmasks
from tti_torch.model.yolo import depth_to_space2, space_to_depth2
from tti_torch.postprocess import masks as tmasks
from tests.torch_pair import assert_outputs_match, pipelines


def _problem(seed, b=2, n=6, hm=24, wm=32, nm=8, input_hw=(96, 128)):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(b, hm, wm, nm)).astype(np.float32)
    coefs = rng.normal(size=(b, n, nm)).astype(np.float32)
    x1 = rng.uniform(-8, input_hw[1] - 20, (b, n))
    y1 = rng.uniform(-8, input_hw[0] - 20, (b, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, 70, (b, n)), y1 + rng.uniform(8, 50, (b, n))],
                     -1).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    return protos, coefs, boxes, valid, input_hw


@pytest.mark.parametrize("threshold", [0.5, None, 0.3])
def test_assemble_masks_matches_tti(threshold):
    protos, coefs, boxes, valid, input_hw = _problem(0)
    ref = np.asarray(jax.vmap(lambda p, c, bx, v: jmasks.assemble_masks(
        p, c, bx, v, input_hw, threshold=threshold))(*map(jnp.asarray, (protos, coefs, boxes, valid))))
    t = [torch.from_numpy(a) for a in (protos, coefs, boxes, valid)]
    got = tmasks.assemble_masks(*t, input_hw, threshold=threshold)
    assert got.shape == ref.shape == (2, 6, 24, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert float(got[~t[3]].abs().sum()) == 0.0  # invalid rows are zero
    # Without the batch dimension, as tti's own signature.
    one = tmasks.assemble_masks(*(a[0] for a in t), input_hw, threshold=threshold)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_crop_masks_and_iou_match_tti():
    rng = np.random.default_rng(1)
    masks = rng.uniform(size=(5, 12, 16)).astype(np.float32)
    boxes = np.array([[0, 0, 16, 12], [2.5, 3, 9, 7.2], [-4, -4, 3, 3], [10, 6, 40, 40],
                      [5, 5, 5, 5]], np.float32)
    got = tmasks.crop_masks(torch.from_numpy(masks), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasks.crop_masks(jnp.asarray(masks),
                                                                   jnp.asarray(boxes))))
    assert got[4].sum() == 0 and np.array_equal(got[0], masks[0])
    a, b = masks[0] > 0.4, masks[1] > 0.6
    for x, y in ((a, b), (a, a), (np.zeros_like(a), np.zeros_like(b))):
        got_iou = float(tmasks.mask_iou(torch.from_numpy(x.astype(np.float32)),
                                        torch.from_numpy(y.astype(np.float32))))
        ref_iou = float(jmasks.mask_iou(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)))
        assert abs(got_iou - ref_iou) < 1e-6


def test_depth_to_space2_inverts_space_to_depth2():
    x = np.random.default_rng(2).normal(size=(2, 8, 12, 3)).astype(np.float32)
    blocked = space_to_depth2(torch.from_numpy(x))
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(jax_s2d(jnp.asarray(x))))
    back = depth_to_space2(blocked)
    assert torch.equal(back, torch.from_numpy(x))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_d2s(jnp.asarray(blocked.numpy()))))


def test_pipeline_returns_masks_like_tti(ref_intrinsics, monkeypatch):
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    kw = dict(return_masks=True)
    pipe, ref_pipe, frames = pipelines("headline", ref_intrinsics, port_kw=kw, ref_kw=kw)
    got, ref = pipe.process_batch(frames), ref_pipe.process_batch(frames)
    assert_outputs_match(got, ref)
    hm, wm = pipe.spec.dst_h // 4, pipe.spec.dst_w // 4
    assert got.masks.shape == ref.masks.shape == (2, pipe.model_cfg.max_detections, hm, wm)
    # Binary masks from float32 logits: a cell within 1e-4 of the threshold
    # may flip; on these frames at most 1 cell in 10 000 may differ.
    assert (got.masks != ref.masks).mean() < 1e-4
    assert got.masks[got.valid].sum() > 0 and got.masks[~got.valid].sum() == 0
    plain, _, _ = pipelines("headline", ref_intrinsics, calibrated=False)
    assert plain.process_batch(frames).masks is None
