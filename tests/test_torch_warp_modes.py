"""The two-pass warp's banded (``block``) and column-expanded
(``col_expand``) modes and the gather's u8-decimating pack against tti's
(float32, on the CPU), and against the dense warp."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti_torch.core.errors import ConfigError
from tti_torch.preprocess import letterbox as tlb
from tti_torch.preprocess import remap as tremap
from tti_torch.preprocess.warp2pass import PAD_ROWS, TwoPassWarp
from tests.torch_pair import pipelines

jlb = importlib.import_module("tti.preprocess.letterbox")
jremap = importlib.import_module("tti.preprocess.remap")
jwarp2 = importlib.import_module("tti.preprocess.warp2pass")

FRAME_HW, IMGSZ = (216, 384), 128  # an exact x3 decimation to 72x128 content


@pytest.fixture(scope="module")
def geometry(ref_intrinsics):
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= FRAME_HW[1] / 1280.0
    K[1] *= FRAME_HW[0] / 960.0
    spec = tlb.make_letterbox_spec(*FRAME_HW, IMGSZ, "rect")
    jspec = jlb.make_letterbox_spec(*FRAME_HW, IMGSZ, "rect")
    small_map = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=True)
    frames = np.random.default_rng(8).integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    return spec, jspec, small_map, frames


def _kw(spec, mode, block):
    col = (3, 1, FRAME_HW[1]) if mode == "col_expand" else None
    return dict(col_expand=col, block=block)


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "rows"])
@pytest.mark.parametrize("mode,block", [("blocked", 16), ("blocked", 48), ("col_expand", None),
                                        ("col_expand", 32)])
def test_warp_modes_match_tti_and_dense(geometry, s2d, mode, block):
    """Through ``letterbox_then_undistort`` (the col-expanded warp takes the
    row-sliced frames there): within 1e-5 of tti's warp in the same mode
    (float32 summation order), and of the dense warp (the dropped weights
    are exact zeros)."""
    spec, jspec, small_map, frames = geometry
    src_hw = (spec.new_h, spec.new_w)
    warp = TwoPassWarp(small_map, src_hw, s2d_out=s2d, device="cpu", **_kw(spec, mode, block))
    jwarp = jwarp2.TwoPassWarp(small_map, src_hw, s2d_out=s2d, **_kw(spec, mode, block))
    dense = TwoPassWarp(small_map, src_hw, s2d_out=s2d, device="cpu")
    got = tremap.letterbox_then_undistort(torch.from_numpy(frames), spec, warp).numpy()
    ref = np.asarray(jremap.letterbox_then_undistort(jnp.asarray(frames), jspec, jwarp))
    base = tremap.letterbox_then_undistort(torch.from_numpy(frames), spec, dense).numpy()
    assert got.shape == ref.shape == base.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, base, atol=1e-5)
    if block is not None:
        # The bands hold tti's slices, each with the pad's terms after it.
        assert len(warp.w1_blocks) == len(jwarp._w1_blocks)
        for (c0, w), (jc0, jw) in zip(warp.w1_blocks, jwarp._w1_blocks):
            assert c0 == jc0 and c0 % 16 == 0
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        for (y0, w), (jy0, jw) in zip(warp.w2_blocks, jwarp._w2_blocks):
            assert y0 == jy0
            np.testing.assert_array_equal(w[..., :-PAD_ROWS].numpy(), np.asarray(jw))
        assert warp.weight_bytes < dense.weight_bytes
    if mode == "col_expand" and block is None:
        assert warp.w1.shape == (spec.new_h, FRAME_HW[1], dense.w1.shape[2])
        np.testing.assert_array_equal(warp.w1[:, 1::3].numpy(), dense.w1.numpy())


def test_blocked_pass2_from_byoc_equals_dense(geometry):
    spec, _, small_map, _ = geometry
    src_hw = (spec.new_h, spec.new_w)
    i1 = torch.from_numpy(np.random.default_rng(9).uniform(-0.4, 0.6, (2, src_hw[0], spec.new_w,
                                                                         3)).astype(np.float32))
    blocked = TwoPassWarp(small_map, src_hw, s2d_out=True, device="cpu", block=24)
    dense = TwoPassWarp(small_map, src_hw, s2d_out=True, device="cpu")
    np.testing.assert_allclose(blocked.apply_pass2(i1, torch.float32).numpy(),
                               dense.apply_pass2(i1, torch.float32).numpy(), atol=1e-5)


def test_blocked_mode_errors(geometry, ref_intrinsics):
    """tti's errors: an odd block with ``s2d_out``, and pass 2 from the
    kernel's (y, c, b, o) intermediate with banded weights; the pipeline
    names the combinations it refuses."""
    spec, _, small_map, _ = geometry
    src_hw = (spec.new_h, spec.new_w)
    for mod, kw in ((TwoPassWarp, dict(device="cpu")), (jwarp2.TwoPassWarp, {})):
        with pytest.raises(ValueError, match="even block"):
            mod(small_map, src_hw, s2d_out=True, block=15, **kw)
    TwoPassWarp(small_map, src_hw, s2d_out=False, block=15, device="cpu")  # odd is fine unblocked
    warp = TwoPassWarp(small_map, src_hw, s2d_out=True, block=16, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        warp.apply_pass2_ycbo(torch.zeros(src_hw[0], 3, 1, spec.new_w))
    with pytest.raises(ConfigError, match="even block"):
        pipelines("headline", ref_intrinsics, port_kw=dict(warp_block=15))
    for kw in (dict(warp_block=16), dict(warp_col_expand=True)):
        with pytest.raises(ConfigError, match="kernel"):
            pipelines("headline", ref_intrinsics, port_kw=dict(warp_pass1="kernel", **kw))


def test_u8_decimating_pack_matches_tti(geometry, monkeypatch):
    """The packed gather, which packs the decimated bytes at an exact
    decimation, against tti's with ``TTI_REMAP_U8_DECIMATE=1``, and against
    the float resize route it replaces: equal (the same words, the same
    blend)."""
    for var in ("TTI_REMAP_SKIP_PAD_ROWS", "TTI_REMAP_SWAR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TTI_REMAP_U8_DECIMATE", "1")
    spec, jspec, small_map, frames = geometry
    src_hw = (spec.new_h, spec.new_w)
    remap = tremap.PackedRemap(small_map, src_hw, device="cpu")
    t = torch.from_numpy(frames)
    got = tremap.letterbox_then_undistort(t, spec, remap).numpy()
    ref = np.asarray(jremap.letterbox_then_undistort(jnp.asarray(frames), jspec,
                                                     jremap.PackedRemap(small_map, src_hw)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, remap(tlb.letterbox_content(t, spec, torch.float32)).numpy())
