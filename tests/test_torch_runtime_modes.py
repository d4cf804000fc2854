"""The step's opt-in modes against tti with the same switch set, on the
paired pipelines of ``tests/torch_pair.py`` (float32 on the CPU, boxes
within 1e-3 px, mm within 1e-3), and each exact mode against the port's
default step: lazy decode with float32 mask logits (not exact: the soft
readout's default logits are bfloat16), the fused head entry and unfolded
BatchNorm, at the deploy geometry. The warp's modes are in
``test_torch_runtime_modes_warp.py``: two files, so that the six tti
compiles spread over two workers."""

import pytest

from tests.torch_pair import mode_against_tti


def test_lazy_decode_with_f32_mask_logits(ref_intrinsics, monkeypatch):
    pipe, _ = mode_against_tti(
        "deploy", {"TTI_LAZY_DECODE": "1", "TTI_MASKSTATS_LOGITS": "f32"},
        dict(lazy_decode=True, maskstats_logits="f32"), ref_intrinsics, monkeypatch,
        exact=False)
    assert pipe.lazy_decode and pipe.measure_cfg.subcell_edge  # kernel A's readout, in f32


@pytest.mark.parametrize("mode", ["fused_head", "unfolded_bn"])
def test_model_modes(mode, ref_intrinsics, monkeypatch):
    env, kw = {"fused_head": ({"TTI_FUSED_HEAD": "1"}, dict(fused_head=True)),
               "unfolded_bn": ({"TTI_FOLDED_BN": "0"}, dict(fold_bn=False))}[mode]
    pipe, _ = mode_against_tti("deploy", env, kw, ref_intrinsics, monkeypatch)
    head = pipe.model.m22
    if mode == "fused_head":
        assert hasattr(head, "cvh_0") and not hasattr(head, "cv2_0_0")
    else:
        assert hasattr(head.cv2_0_0, "bn") and not head.training
