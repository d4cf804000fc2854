"""Static int8 calibration (``TTI_QUANT=int8s``): the port's
``calibrate_act_scales`` and ``tools/calibrate_int8_torch.py`` against tti's
``calibrate_act_scales`` and ``tools/calibrate_int8.py`` on the CPU.

- The function, float32 (``jax_default_matmul_precision="highest"``), the
  same plain-stem folded model and batches: the same 66 keys, values within
  rtol 2e-6 (the two networks' float32 sums differ in order; see ``REL``).
- The tools, ``--synth 4`` at imgsz 64, seed 7, both in bf16 as they run:
  the same keys and meta, values within rtol 2e-2 (bf16 activations; the
  largest difference in the run that set this limit was 1.66e-2, at
  ``m22/cv4_2_1``), and each package's ``int8s`` step serves the other's
  file.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.torch_pair import SWITCHES, pipelines
from tti.model.convert import fold_batchnorm
from tti.model.quantize import calibrate_act_scales as tti_calibrate
from tti.model.yolo import YOLOv8Seg
from tti_torch.core.config import ModelConfig
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.model.quantize import calibrate_act_scales
from tti_torch.parallel.runtime import inference_model

torch.set_num_threads(2)
CKPT = "checkpoints/yolov8n_textile.msgpack"
# float32 through up to 21 layers whose sums the two frameworks take in
# different orders: the largest relative difference in the run that set this
# limit was 1.05e-6 (m21/m0/cv1 at the 50th percentile; 1.01e-6 at absmax).
REL = 2e-6


def test_calibrate_act_scales_matches_tti_in_float32():
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    rng = np.random.default_rng(3)
    batches = [rng.uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    ref_model = YOLOv8Seg(variant="n", nc=2, dtype=jnp.float32, folded_bn=True, qmode="calib")
    want = tti_calibrate(ref_model, fold_batchnorm(tree), batches)
    model = inference_model(ModelConfig(image_size=64, dtype="float32"), load_flax_msgpack(CKPT),
                            torch.device("cpu"), s2d_input=False, s2d_stem=False)
    got = calibrate_act_scales(model, [torch.from_numpy(b) for b in batches])
    assert set(got) == set(want) and len(got) == 66 and "m0" in got
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=REL), key
    clipped = calibrate_act_scales(model, [torch.from_numpy(b) for b in batches], percentile=50.0)
    clipped_ref = tti_calibrate(ref_model, fold_batchnorm(tree), batches, percentile=50.0)
    for key in want:
        assert clipped[key] == pytest.approx(clipped_ref[key], rel=REL), key


def test_calibration_tools_round_trip(tmp_path, monkeypatch, ref_intrinsics):
    sys.path.insert(0, "tools")
    import calibrate_int8 as tti_tool
    import calibrate_int8_torch as port_tool

    args = ["--weights", CKPT, "--synth", "4", "--imgsz", "64", "--batch", "2", "--seed", "7"]
    ref_path, port_path = tmp_path / "tti.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["calibrate_int8.py", *args, "--out", str(ref_path)])
    tti_tool.main()
    assert port_tool.main([*args, "--out", str(port_path), "--device", "cpu"]) == 0
    ref, got = json.loads(ref_path.read_text()), json.loads(port_path.read_text())
    assert got["meta"] == ref["meta"]
    assert set(got["scales"]) == set(ref["scales"]) and len(got["scales"]) == 66
    rel = max(abs(got["scales"][k] - v) / v for k, v in ref["scales"].items())
    assert rel <= 2e-2, rel

    # Each package's int8s step on the other's file.
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TTI_QUANT", "int8s")
    monkeypatch.setenv("TTI_QUANT_SCALES", str(port_path))
    port, ref_pipe, frames = pipelines("headline", ref_intrinsics,
                                       port_kw=dict(quant="int8s", quant_scales=str(ref_path)))
    for out in (port.process_batch(frames), ref_pipe.process_batch(frames)):
        assert np.isfinite(np.asarray(out.scores)).all() and np.asarray(out.valid).any()
    assert float(port.model.m0s2d.ascale) == np.float32(ref["scales"]["m0"])
