"""``eval``'s int8 predictor against ``tti``'s jitted one, float32 on the CPU.

``tti eval`` under ``TTI_QUANT=int8 | int8s`` serves the plain-stem model
with folded BatchNorm and quantized weights through its jitted
``Predictor`` (``tti/cli/__main__.py:647-674``); the port's
``Predictor(quant=)`` serves the same. Both read one scales file, made by
the port's ``calibrate_act_scales`` on the plain-stem float model over the
letterboxed frames, as ``tools/calibrate_int8_torch.py`` makes it. Four
square seeded textile frames per case, on the deploy checkpoint (stride-2
sub-pixel protos, imgsz 96) and the stride-4 checkpoint (imgsz 128).

Held with ``tests/test_torch_quantize_step.py``'s ``INT8_MATCH``: boxes
within 2 px and scores within 2e-2, the same number of detections of each
class per frame. The detections are paired by IoU (each of ``tti``'s, in
score order, with the port's unpaired detection of its class that overlaps
it most), not by row: on the stride-4 checkpoint, XLA's jit of ``tti``'s
int8 model rounds some int8 codes the other way from ``tti``'s own eager
forward from ``m15.m0.cv2`` on (the port equals that eager forward), which
moves scores by up to a few thousandths, enough to swap two rows of
nearly equal score. A pair must overlap at IoU 0.9 or more, and the
proto-grid masks of a pair differ in at most 5% of their union.

One bar is wider: the scores of dynamic ``int8`` on the stride-4
checkpoint, 3e-2. There every block's scale is its input's absmax, so an
ulp anywhere upstream can flip codes downstream (see
``tests/test_torch_quantize_step.py``), and ``tti`` does not agree with
itself: on these frames its jitted and its eager predictor differ by
0.0124 in score (boxes 0.17 px, IoU 0.968), the port and ``tti``'s eager
one by 0.0097, the port and the jitted one by 0.0215 (boxes 0.20 px, IoU
0.968). The ``int8s`` cases and the deploy ``int8`` case read within
0.0001.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tti.app.predict as jpred
import tti.core.config as jcfg
from tests.test_torch_quantize_step import INT8_MATCH
from tests.torch_synth import textile_frames
from tti.model.convert import fold_batchnorm
from tti.model.quantize import quantize_weights
from tti.model.yolo import YOLOv8Seg
import tti_torch.app.predict as tpred
import tti_torch.core.config as tcfg
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.model.quantize import calibrate_act_scales
from tti_torch.parallel.runtime import inference_model
from tti_torch.preprocess.letterbox import letterbox_u8

torch.set_num_threads(2)

CASES = {"deploy": ("yolov8n_textile_cam", 96), "stride4": ("yolov8n_textile", 128)}
MIN_IOU, MAX_MASK_DIFF = 0.9, 0.05
SCORE_ATOL = {("stride4", "int8"): 3e-2}  # the module's docstring


def _box_iou(a, b):
    lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    area = lambda x: np.prod(np.clip(x[2:] - x[:2], 0, None))
    return inter / max(area(a) + area(b) - inter, 1e-9)


def _pairs(got, ref, frame):
    """(tti row, port row) pairs of one frame, by IoU within each class."""
    free = set(np.flatnonzero(got.valid[frame]))
    pairs = []
    for j in np.flatnonzero(ref.valid[frame]):
        same = [i for i in free if got.classes[frame, i] == ref.classes[frame, j]]
        assert same, f"frame {frame}: tti's detection {j} has no port detection of its class"
        i = max(same, key=lambda i: _box_iou(got.boxes[frame, i], ref.boxes[frame, j]))
        free.remove(i)
        pairs.append((j, i))
    assert not free, f"frame {frame}: the port has {len(free)} more detections"
    return pairs


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("quant", ["int8", "int8s"])
def test_eval_predictor_int8_matches_tti_jit(name, quant, tmp_path):
    ckpt, imgsz = CASES[name]
    path = f"checkpoints/{ckpt}.msgpack"
    meta = checkpoint_metadata(path)
    kw = dict(variant="n", num_classes=2, image_size=imgsz, dtype="float32", conf_thresh=0.05,
              mask_stride=meta.get("mask_stride", 4), proto_head=meta.get("proto_head", "deconv"))
    hw = (imgsz, imgsz)
    frames = textile_frames(4, *hw, seed=5)
    port_cfg = tcfg.ModelConfig(**kw)
    float_model = inference_model(port_cfg, load_flax_msgpack(path), torch.device("cpu"),
                                  s2d_input=False, s2d_stem=False)
    spec = tpred.make_letterbox_spec(*hw, imgsz, port_cfg.letterbox)
    scales = calibrate_act_scales(
        float_model, [letterbox_u8(torch.from_numpy(frames), spec, torch.float32)])
    scales_path = tmp_path / "scales.json"
    scales_path.write_text(json.dumps({"scales": scales}))

    got = tpred.Predictor(port_cfg, load_flax_msgpack(path), hw, mask_topk=64, proto_masks=True,
                          device="cpu", quant=quant, quant_scales=str(scales_path))(frames)
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    act = dict(json.loads(scales_path.read_text())["scales"]) if quant == "int8s" else None
    model = YOLOv8Seg(variant="n", nc=2, dtype=jnp.float32, folded_bn=True, qmode=quant,
                      mask_stride=kw["mask_stride"], proto_head=kw["proto_head"])
    ref = jpred.Predictor(jcfg.ModelConfig(**kw),
                          quantize_weights(fold_batchnorm(variables), act_scales=act), hw,
                          mask_topk=64, model=model, proto_masks=True)(frames)

    assert ref.valid.sum() >= 4
    k = got.masks_proto.shape[1]
    for frame in range(len(frames)):
        for j, i in _pairs(got, ref, frame):
            assert _box_iou(got.boxes[frame, i], ref.boxes[frame, j]) >= MIN_IOU
            np.testing.assert_allclose(got.boxes[frame, i], ref.boxes[frame, j],
                                       atol=INT8_MATCH["box_atol"])
            assert abs(got.scores[frame, i] - ref.scores[frame, j]) <= SCORE_ATOL.get(
                (name, quant), INT8_MATCH["score_atol"])
            if i < k and j < k:
                a, b = got.masks_proto[frame, i] > 0, ref.masks_proto[frame, j] > 0
                assert (a ^ b).sum() <= MAX_MASK_DIFF * max((a | b).sum(), 1)
