"""The predict chain against tti's, float32 on the CPU: ``Predictor`` on the
stride-4 checkpoint and on the stride-2 sub-pixel deploy checkpoint, the
mask chain (``masks_at_input``, ``upsample_masks``, ``resize_nearest_cv2``
against ``tti``'s ``masks_to_frame``) and the mask packing.

Tolerances: boxes 1e-3 px and scores 1e-5 (float32 through the network;
the port runs the s2d stem and folded BN, tti's Predictor the raw model);
proto-grid masks equal. Input-resolution masks threshold a bilinear upsample
at 0.5: ``F.interpolate`` clamps the source coordinate at the border where
``jax.image.resize`` drops the outside tap and renormalises, so the two
probabilities can differ by an ulp, and a pixel at 0.5 can flip. Masks are
held equal except at pixels whose probability lies within 1e-5 of 0.5 (on
equal inputs) or 1e-4 (through the two networks), and those are counted.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tti.app.predict as jpred
import tti.core.config as jcfg
import tti.postprocess.masks as jmasks
from tests.torch_synth import textile_frames
from tti.model.yolo import create_model as jax_create_model
import tti_torch.app.predict as tpred
import tti_torch.core.config as tcfg
import tti_torch.postprocess.masks as tmasks
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.postprocess.decode import decode_predictions
from tti_torch.postprocess.nms import batched_nms
from tti_torch.preprocess.letterbox import letterbox_u8

torch.set_num_threads(2)

CASES = {  # checkpoint, frame (h, w), imgsz
    "stride4": ("yolov8n_textile", (96, 128), 128),
    "stride2_subpixel": ("yolov8n_textile_cam", (72, 96), 96),
}


def _pair(name):
    ckpt, hw, imgsz = CASES[name]
    path = f"checkpoints/{ckpt}.msgpack"
    meta = checkpoint_metadata(path)
    kw = dict(variant="n", num_classes=2, image_size=imgsz, dtype="float32", conf_thresh=0.05,
              mask_stride=meta.get("mask_stride", 4), proto_head=meta.get("proto_head", "deconv"))
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    ref = jpred.Predictor(jcfg.ModelConfig(**kw), variables, hw, mask_topk=64, proto_masks=True,
                          model=jax_create_model("n", nc=2, dtype=jnp.float32,
                                                 mask_stride=kw["mask_stride"],
                                                 proto_head=kw["proto_head"]))
    got = tpred.Predictor(tcfg.ModelConfig(**kw), load_flax_msgpack(path), hw, mask_topk=64,
                          proto_masks=True, device="cpu")
    frames = textile_frames(2, *hw, seed=5)
    return got, ref, frames, got(frames), ref(frames)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in CASES}


def _port_probs(pred, frames):
    """The port's input-resolution probabilities (before the 0.5 threshold)."""
    with torch.inference_mode():
        raw = pred.model(letterbox_u8(torch.from_numpy(frames), pred.spec, torch.float32))
        dets = batched_nms(*decode_predictions(raw), conf_thresh=pred.model_cfg.conf_thresh,
                           iou_thresh=pred.model_cfg.iou_thresh,
                           max_det=pred.model_cfg.max_detections,
                           pre_topk=pred.model_cfg.nms_pre_topk)
        k = pred.mask_topk
        hw = (pred.spec.dst_h, pred.spec.dst_w)
        probs = tmasks.assemble_masks(raw.protos, dets.coefs[:, :k], dets.boxes[:, :k],
                                      dets.valid[:, :k], hw, threshold=None)
        return tmasks.upsample_masks(probs, hw).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictor_matches_tti(pairs, name):
    got_pred, _, frames, got, ref = pairs[name]
    assert got.spec == got_pred.spec and got.masks_input.dtype == np.uint8
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.classes, ref.classes)
    assert got.valid.sum() > 0, "the seeded frames should give detections"
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=1e-3)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
    np.testing.assert_array_equal(got.masks_proto, ref.masks_proto)
    assert got.masks_input.shape == ref.masks_input.shape
    differ = got.masks_input != ref.masks_input
    near = np.abs(_port_probs(got_pred, frames) - 0.5) < 1e-4
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} pixels differ away from 0.5"
    assert differ.sum() <= near.sum()


@pytest.mark.parametrize("name", sorted(CASES))
def test_masks_to_frame_matches_tti(pairs, name):
    got_pred, ref_pred, _, got, ref = pairs[name]
    full = got_pred.masks_to_frame(got.masks_input)
    np.testing.assert_array_equal(full, ref_pred.masks_to_frame(got.masks_input))
    assert full.shape[-2:] == got_pred.frame_hw
    # The device-side gather is the same index map.
    dev = tmasks.resize_nearest_cv2(torch.from_numpy(got.masks_input), got_pred.frame_hw)
    np.testing.assert_array_equal(dev.numpy(), full)


CHAIN = {  # (Hm, Wm) proto grid, (H, W) input, detections
    "stride4": ((24, 32), (96, 128), 6),
    "stride2": ((36, 48), (72, 96), 5),
    "deploy_grid": ((368, 480), (736, 960), 2),
}


@pytest.mark.parametrize("name", sorted(CHAIN))
def test_mask_chain_matches_tti(name):
    (hm, wm), hw, n = CHAIN[name]
    rng = np.random.default_rng(len(name))
    protos = rng.normal(0, 1, (hm, wm, 32)).astype(np.float32)
    coefs = rng.normal(0, 0.5, (n, 32)).astype(np.float32)
    x1 = rng.uniform(-8, hw[1] * 0.6, n)
    y1 = rng.uniform(-8, hw[0] * 0.6, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, hw[1] * 0.6, n),
                      y1 + rng.uniform(4, hw[0] * 0.6, n)], -1).astype(np.float32)
    valid = np.arange(n) < n - 1
    want_probs = np.asarray(jmasks.upsample_masks(jmasks.assemble_masks(
        jnp.asarray(protos), jnp.asarray(coefs), jnp.asarray(boxes), jnp.asarray(valid), hw,
        threshold=None), hw))
    targs = [torch.from_numpy(a) for a in (protos, coefs, boxes, valid)]
    got_probs = tmasks.upsample_masks(tmasks.assemble_masks(*targs, hw, threshold=None), hw)
    np.testing.assert_allclose(got_probs.numpy(), want_probs, atol=1e-6)
    got = tmasks.masks_at_input(*targs, hw).numpy()
    want = np.asarray(jmasks.masks_at_input(*(jnp.asarray(a) for a in (protos, coefs, boxes,
                                                                         valid)), hw))
    near = np.abs(want_probs - 0.5) < 1e-5
    assert not ((got != want) & ~near).any()
    assert int((got != want).sum()) <= int(near.sum()) <= 2 * n
    assert got.sum() > 0 and not got[~valid].any()
    frame_hw = (hw[0] * 5 // 4 + 3, hw[1] * 4 // 3 + 1)
    full = tmasks.resize_nearest_cv2(torch.from_numpy(got), frame_hw).numpy() > 0
    np.testing.assert_array_equal(
        full[~near.any((1, 2))],
        jpred.Predictor.masks_to_frame(SimpleNamespace(frame_hw=frame_hw),
                                       want)[~near.any((1, 2))] > 0)


@pytest.mark.parametrize("out_hw", [(960, 1280), (240, 320), (1080, 1920), (100, 7)])
def test_resize_nearest_cv2_matches_tti(out_hw):
    rng = np.random.default_rng(out_hw[1])
    masks = (rng.random((2, 736, 960)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tmasks.resize_nearest_cv2(torch.from_numpy(masks), out_hw).numpy(),
        np.asarray(jmasks.resize_nearest_cv2(jnp.asarray(masks), out_hw)))


@pytest.mark.parametrize("in_hw,out_hw", [((736, 960), (1280, 1280)), ((28, 14), (1080, 1080))])
def test_resize_nearest_cv2_follows_masks_to_frame(in_hw, out_hw):
    """The one index map is cv2's, in float64, as ``tti``'s
    ``Predictor.masks_to_frame`` computes it. ``tti``'s jax
    ``resize_nearest_cv2`` computes it in float32 and differs at these
    shapes."""
    masks = np.random.default_rng(in_hw[0]).integers(0, 2, (2, *in_hw), dtype=np.uint8)
    want = jpred.Predictor.masks_to_frame(SimpleNamespace(frame_hw=out_hw), masks)
    got = tmasks.resize_nearest_cv2(torch.from_numpy(masks), out_hw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpred.Predictor.masks_to_frame(SimpleNamespace(frame_hw=out_hw), masks), want)
    assert (np.asarray(jmasks.resize_nearest_cv2(jnp.asarray(masks), out_hw)) != want).any()


@pytest.mark.parametrize("width", [1, 7, 8, 9, 96, 961])
def test_packbits_round_trip(width):
    rng = np.random.default_rng(width)
    bits = (rng.random((2, 3, 5, width)) > 0.5).astype(np.uint8)
    packed = tpred._packbits_lastdim(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(bits, axis=-1))
    np.testing.assert_array_equal(packed, np.asarray(jpred._packbits_lastdim(jnp.asarray(bits))))
    np.testing.assert_array_equal(tpred._unpackbits_lastdim(packed, width), bits)
