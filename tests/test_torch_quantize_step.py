"""The int8 inference step of the port against tti's on the CPU (float32),
on the paired pipelines of ``tests/torch_pair.py``: the deploy and the
headline geometry, each under ``TTI_QUANT=int8`` and ``int8s``.

``int8s`` (static scales): the scales are calibrated by the port's
``calibrate_act_scales`` on the plain-stem float model over the step's own
model input, written as the calibration tools write them, and read by both
packages (tti renames the stem ``m0`` to ``m0s2d`` as the port does). Held
with the default tolerances of ``assert_outputs_match``: both packages
compute the same codes, integer sums and float32 epilogues, and the same
SiLU formula, ``x * sigmoid(x)`` (``silu_plain``). With PyTorch's
``F.silu``, ``x / (1 + exp(-x))``, a quarter of the stem's outputs lay an
ulp off ``tti``'s, one code of ``m1``'s input rounded the other way
(36.500004 against 36.5 on an 8-core AVX-512 host) and the flips
compounded to 0.0062 in two headline scores; ``tti``'s jitted and eager
forwards agree there to 3.4e-08.

``int8`` (dynamic per-sample scales): every block divides its input by the
input's absmax. The first block's output (the s2d stem, through SiLU)
can still differ by an ulp between the two packages (XLA's ``exp`` and
PyTorch's differ in the last bit of a few values in a thousand), so the
next block's divisor can differ by an ulp, and every code of the sample
near a rounding boundary can round the other way; each flipped code moves the outputs it
feeds by one quantization step, and the flips compound through the 66
blocks. :func:`test_int8_codes_flip_from_the_first_silu` shows it on one
shared model input (the layer, the scale and the count of flipped codes).
The int8 steps are therefore held with tolerances of the size of int8's
own quantization error, from the readings of this test: boxes 2 px
(largest seen 0.84 px), scores 2e-2 (0.0084), mm 0.5 (0.27), the envelope
and the stitches' grid coordinates 32 (one envelope column moved by 24
proto rows at the headline geometry, a stitch edge by 2.4 px at the
deploy's); counts and flags stay equal. So these pairs cannot catch a
wrong measurement on the int8 path (the mm report's p50 error is about
0.04 mm), and feeding both packages one stem output would not tighten
them: any block's SiLU can differ by an ulp, so any later block's scale
can. The tight checks of the int8 chain are the ``int8s`` pairs here (the
default tolerances) and the per-block ones of
``tests/test_torch_quantize.py`` (``Conv(qmode="int8" | "int8s")``
against tti's within 1e-5 at k 1/2/3, s 1/2, pad 0/1, ci 3/12/16/48 and
on a channel slice).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.torch_pair import GEOMETRIES, SWITCHES, mode_against_tti, pipelines
from tti.model.convert import fold_batchnorm, stem_to_s2d
from tti.model.quantize import quantize_weights
from tti.model.yolo import YOLOv8Seg
from tti_torch.core.config import ModelConfig
from tti_torch.kernels.int8conv import act_scale_per_sample, quantize_act_plain
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.model.layers import Conv
from tti_torch.model.quantize import calibrate_act_scales
from tti_torch.model.yolo import depth_to_space2
from tti_torch.parallel.runtime import inference_model

torch.set_num_threads(2)

INT8_MATCH = dict(box_atol=2.0, score_atol=2e-2, mm_atol=0.5, grid_atol=32.0)


def _scales_file(geometry, ref_intrinsics, monkeypatch, path):
    """Calibrate on the step's own model input (the plain-stem float model,
    fed the s2d-blocked warp output unblocked) and write the tools' JSON."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    pipe, _, frames = pipelines(geometry, ref_intrinsics)
    ckpt = GEOMETRIES[geometry][0]
    model = inference_model(pipe.model_cfg, load_flax_msgpack(f"checkpoints/{ckpt}.msgpack"),
                            torch.device("cpu"), s2d_input=False, s2d_stem=False)
    x = depth_to_space2(pipe.preprocess(torch.from_numpy(frames)))
    scales = calibrate_act_scales(model, [x])
    assert "m0" in scales and len(scales) == 66
    path.write_text(json.dumps({"scales": scales}))
    return str(path)


@pytest.mark.parametrize("geometry", ["deploy", "headline"])
@pytest.mark.parametrize("quant", ["int8", "int8s"])
def test_quantized_step_matches_tti(geometry, quant, ref_intrinsics, monkeypatch, tmp_path):
    env, kw = {"TTI_QUANT": quant}, {"quant": quant}
    if quant == "int8s":
        path = _scales_file(geometry, ref_intrinsics, monkeypatch, tmp_path / "scales.json")
        env["TTI_QUANT_SCALES"] = kw["quant_scales"] = path
    pipe, got = mode_against_tti(geometry, env, kw, ref_intrinsics, monkeypatch, exact=False,
                                 match=INT8_MATCH if quant == "int8" else None)
    blocks = [m for m in pipe.model.modules() if isinstance(m, Conv) and m.qmode]
    assert len(blocks) == 66 and all(m.qmode == quant for m in blocks)


def test_int8_codes_flip_from_the_first_silu():
    """One model input (numpy) through tti's and the port's int8 models
    (s2d stem, folded, quantized; deploy checkpoint): the stem's output
    agrees to float32 rounding (one formula, two ``exp``), and so the next
    block's per-sample scales agree to an ulp; the codes of that block's
    input that round the other way are counted (1 of 98,304 in the run
    that set this limit, with ``F.silu`` in the port; 0 since the port
    takes ``tti``'s formula)."""
    path = "checkpoints/yolov8n_textile_cam.msgpack"
    meta = checkpoint_metadata(path)
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    ref = YOLOv8Seg(variant="n", nc=2, dtype=jnp.float32, s2d_stem=True, s2d_input=True,
                    folded_bn=True, qmode="int8", mask_stride=meta["mask_stride"],
                    proto_head=meta["proto_head"])
    cfg = ModelConfig(image_size=128, dtype="float32", mask_stride=meta["mask_stride"],
                      proto_head=meta["proto_head"])
    port = inference_model(cfg, load_flax_msgpack(path), torch.device("cpu"), quant="int8")
    x = np.random.default_rng(0).uniform(0, 1, size=(2, 48, 64, 12)).astype(np.float32)
    _, inter = ref.apply(quantize_weights(fold_batchnorm(stem_to_s2d(tree))), x, train=False,
                         capture_intermediates=True, mutable=["intermediates"])
    ref_stem = np.array(inter["intermediates"]["m0s2d"]["__call__"][0])
    seen = {}
    handle = port.m1.register_forward_pre_hook(lambda m, args: seen.setdefault("x", args[0]))
    with torch.inference_mode():
        port(torch.from_numpy(x))
    handle.remove()
    stem = seen["x"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(stem, ref_stem, rtol=2e-7, atol=1e-7)  # exp: an ulp
    ref_in = torch.from_numpy(ref_stem).permute(0, 3, 1, 2)
    s_port, s_ref = act_scale_per_sample(seen["x"]), act_scale_per_sample(ref_in)
    assert (np.abs(s_port.numpy().view(np.int32) - s_ref.numpy().view(np.int32)) <= 1).all()
    flipped = int((quantize_act_plain(seen["x"], s_port) != quantize_act_plain(ref_in, s_ref))
                  .sum())
    assert flipped <= 10, flipped
