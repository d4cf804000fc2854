"""The port's gather remap (tti_torch.preprocess.remap) against tti's, on the
same maps and seeded inputs, float32: integer words equal exactly, floats
within 1e-6 (one division by 255), ``remap_bilinear`` within 1e-5 (float32
lerps). Then the pipeline on the gather route and on the fallback for a map
the two-pass warp refuses.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti_torch.core.errors import ConfigError
from tti_torch.preprocess import letterbox as tlb
from tti_torch.preprocess import remap as tremap
from tti_torch.preprocess.warp2pass import TwoPassWarp
from tests.torch_pair import assert_outputs_match, pipelines

# tti.preprocess re-exports functions under its module names.
jlb = importlib.import_module("tti.preprocess.letterbox")
jremap = importlib.import_module("tti.preprocess.remap")
jwarp2 = importlib.import_module("tti.preprocess.warp2pass")

FRAME_HW, IMGSZ = (216, 384), 128  # an exact x3 decimation to 72x128 content


def _geometry(ref_intrinsics):
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= FRAME_HW[1] / 1280.0
    K[1] *= FRAME_HW[0] / 960.0
    spec = tlb.make_letterbox_spec(*FRAME_HW, IMGSZ, "rect")
    jspec = jlb.make_letterbox_spec(*FRAME_HW, IMGSZ, "rect")
    return K, dist, spec, jspec


def _frames(seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, *FRAME_HW, 3), dtype=np.uint8)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("unpadded", [True, False])
def test_packed_remap_matches_tti(ref_intrinsics, interp, unpadded, monkeypatch):
    for var in ("TTI_REMAP_SKIP_PAD_ROWS", "TTI_REMAP_SWAR"):
        monkeypatch.delenv(var, raising=False)
    K, dist, spec, jspec = _geometry(ref_intrinsics)
    m = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=unpadded)
    src_hw = (spec.new_h, spec.new_w) if unpadded else (spec.dst_h, spec.dst_w)
    got_r = tremap.PackedRemap(m, src_hw, interp=interp, device="cpu")
    ref_r = jremap.PackedRemap(m, src_hw, interp=interp)
    assert (got_r.row_start, got_r.row_stop) == (ref_r.row_start, ref_r.row_stop)
    assert got_r.pad_word == int(ref_r.pad_word) and got_r.live_hw == ref_r.live_hw
    assert len(got_r.idx) == len(ref_r.idx) == (4 if interp == "bilinear" else 1)
    for a, b in zip(got_r.idx, ref_r.idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got_r.wx8.numpy(), np.asarray(ref_r.wx8).astype(np.int64))
    np.testing.assert_array_equal(got_r.wy8.numpy(), np.asarray(ref_r.wy8).astype(np.int64))

    frames = _frames()
    if unpadded:
        content = tlb.letterbox_content(torch.from_numpy(frames), spec, decimate=True)
    else:
        content = tlb.letterbox_u8(torch.from_numpy(frames), spec)
    got = got_r(content).numpy()
    ref = np.asarray(ref_r(jnp.asarray(content.numpy())))
    assert got.shape == ref.shape == (2, spec.dst_h, spec.dst_w, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # 8-bit outputs: the blended bytes themselves are equal.
    np.testing.assert_array_equal(np.round(got * 255).astype(np.int64),
                                  np.round(ref * 255).astype(np.int64))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("unpadded", [True, False])
def test_packed_remap_from_each_package_own_map(ref_intrinsics, interp, unpadded, monkeypatch):
    """Each package builds its own map from the same calibration (the
    distortion model in float32 on both sides): the maps, the gather indices
    and the packed 8-bit blend weights are equal element for element."""
    monkeypatch.delenv("TTI_REMAP_SKIP_PAD_ROWS", raising=False)
    K, dist, spec, jspec = _geometry(ref_intrinsics)
    m = tremap.build_small_undistort_map(K, dist, spec, unpadded_src=unpadded)
    jm = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=unpadded)
    assert m.dtype == jm.dtype == np.float32
    np.testing.assert_array_equal(m, jm)
    src_hw = (spec.new_h, spec.new_w) if unpadded else (spec.dst_h, spec.dst_w)
    got_r = tremap.PackedRemap(m, src_hw, interp=interp, device="cpu")
    ref_r = jremap.PackedRemap(jm, src_hw, interp=interp)
    assert (got_r.row_start, got_r.row_stop) == (ref_r.row_start, ref_r.row_stop)
    for a, b in zip(got_r.idx, ref_r.idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got_r.wx8.numpy(), np.asarray(ref_r.wx8).astype(np.int64))
    np.testing.assert_array_equal(got_r.wy8.numpy(), np.asarray(ref_r.wy8).astype(np.int64))
    assert int(got_r.wx8.max()) > 128 and int(got_r.wy8.max()) > 128  # real blends, not zeros


def test_pack_decimated_u8_words_equal(ref_intrinsics):
    K, dist, spec, jspec = _geometry(ref_intrinsics)
    m = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=True)
    src_hw = (spec.new_h, spec.new_w)
    got_r = tremap.PackedRemap(m, src_hw, device="cpu")
    ref_r = jremap.PackedRemap(m, src_hw)
    frames = _frames(1)
    got = got_r.pack_decimated_u8(torch.from_numpy(frames), 1, 1, 3)
    ref = np.asarray(ref_r.pack_decimated_u8(jnp.asarray(frames), 1, 1, 3))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref.astype(np.int64))
    out = got_r.apply_packed(got, torch.float32).numpy()
    np.testing.assert_allclose(out, np.asarray(ref_r.apply_packed(jnp.asarray(ref), jnp.float32)),
                               atol=1e-6)
    # The same words as quantizing the decimated content (u8 survives /255 -> *255).
    content = tlb.letterbox_content(torch.from_numpy(frames), spec, decimate=True)
    np.testing.assert_array_equal(got_r(content).numpy(), out)


def test_swar_blend_bits_at_the_extremes():
    """Every field at 0xFF with every weight: the int64 blend keeps the
    reference's uint32 bits (no carry between fields, rounding to nearest)."""
    m = np.zeros((1, 257, 2), np.float32)
    m[0, :, 0] = np.arange(257) / 256.0  # wx8 = 0..256 between pixels 0 and 1
    got_r = tremap.PackedRemap(m, (1, 2), device="cpu")
    ref_r = jremap.PackedRemap(m, (1, 2))
    for left, right in ((0xFFFFFF, 0x000000), (0x000000, 0xFFFFFF), (0xFFFFFF, 0xFFFFFF),
                        (0x80FF01, 0x0100FE)):
        words = np.array([[left, right]], np.int64)
        got = got_r.apply_packed(torch.from_numpy(words.astype(np.int32)), torch.float32).numpy()
        ref = np.asarray(ref_r.apply_packed(jnp.asarray(words.astype(np.uint32)), jnp.float32))
        np.testing.assert_array_equal(np.round(got * 255).astype(np.int64),
                                      np.round(ref * 255).astype(np.int64))
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_remap_bilinear_and_single_pass_match(ref_intrinsics):
    K, dist, spec, jspec = _geometry(ref_intrinsics)
    m = jremap.build_small_undistort_map(K, dist, jspec)
    x = np.random.default_rng(2).random((2, spec.dst_h, spec.dst_w, 3), np.float32)
    got = tremap.remap_bilinear(torch.from_numpy(x), m).numpy()
    ref = np.asarray(jremap.remap_bilinear(jnp.asarray(x), jnp.asarray(m)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    big = jremap.build_undistort_letterbox_map(K, dist, jspec)
    np.testing.assert_array_equal(tremap.build_undistort_letterbox_map(K, dist, spec), big)
    frames = _frames(3, n=1)
    got = tremap.undistort_letterbox_frames(torch.from_numpy(frames), big).numpy()
    ref = np.asarray(jremap.undistort_letterbox_frames(jnp.asarray(frames), jnp.asarray(big)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("kind", ["twopass", "packed", "packed_padded", "map"])
def test_letterbox_then_undistort_matches(ref_intrinsics, kind, monkeypatch):
    monkeypatch.delenv("TTI_REMAP_U8_DECIMATE", raising=False)
    K, dist, spec, jspec = _geometry(ref_intrinsics)
    unpadded = kind in ("twopass", "packed")
    m = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=unpadded)
    src_hw = (spec.new_h, spec.new_w) if unpadded else (spec.dst_h, spec.dst_w)
    if kind == "twopass":
        got_r, ref_r = TwoPassWarp(m, src_hw, device="cpu"), jwarp2.TwoPassWarp(m, src_hw)
    elif kind == "map":
        got_r, ref_r = m, m
    else:
        got_r, ref_r = tremap.PackedRemap(m, src_hw, device="cpu"), jremap.PackedRemap(m, src_hw)
    frames = _frames(4)
    got = tremap.letterbox_then_undistort(torch.from_numpy(frames), spec, got_r).numpy()
    ref = np.asarray(jremap.letterbox_then_undistort(jnp.asarray(frames), jspec, ref_r))
    assert got.shape == ref.shape == (2, spec.dst_h, spec.dst_w, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_bad_interp_is_refused(ref_intrinsics):
    with pytest.raises(ValueError, match="interp"):
        tremap.PackedRemap(np.zeros((4, 4, 2), np.float32), (4, 4), interp="cubic", device="cpu")
    with pytest.raises(ConfigError, match="interp"):
        pipelines("headline", ref_intrinsics, port_kw=dict(undistort_interp="cubic"))
    with pytest.raises(ConfigError, match="remap"):
        pipelines("headline", ref_intrinsics, port_kw=dict(remap="gather"))


@pytest.mark.parametrize("route", ["packed", "nearest", "fallback"])
def test_pipeline_on_the_gather_routes_matches_tti(ref_intrinsics, route, monkeypatch):
    """remap="packed" (tti's TTI_REMAP=packed), the nearest gather, and a
    lens whose vertical map folds back (k1 = -0.6), where both sides fall
    back from the two-pass warp to the gather. The tolerances of the
    whole-slice test."""
    for var in ("TTI_MASKSTATS_LOGITS", "TTI_REMAP", "TTI_REMAP_SKIP_PAD_ROWS", "TTI_REMAP_SWAR",
                "TTI_REMAP_U8_DECIMATE", "TTI_WARP_S2D"):
        monkeypatch.delenv(var, raising=False)
    # Each side builds its own map; they are equal (the test above), so both
    # gather at the same taps with the same weights.
    dist, port_kw, ref_kw = None, {}, {}
    if route == "packed":
        monkeypatch.setenv("TTI_REMAP", "packed")
        port_kw = dict(remap="packed")
    elif route == "nearest":
        port_kw = ref_kw = dict(undistort_interp="nearest")
    else:
        dist = np.array([-0.6, 0.0, 0.0, 0.0, 0.0])
    pipe, ref_pipe, frames = pipelines("headline", ref_intrinsics, dist=dist, port_kw=port_kw,
                                       ref_kw=ref_kw)
    assert isinstance(pipe.warp, tremap.PackedRemap)
    assert isinstance(ref_pipe.remap_xy, jremap.PackedRemap)
    assert pipe.warp.interp == ("nearest" if route == "nearest" else "bilinear")
    x = pipe.preprocess(torch.from_numpy(frames)).numpy()
    ref_x = np.asarray(ref_pipe.preprocess(jnp.asarray(frames)))
    assert x.shape == ref_x.shape == (2, pipe.spec.dst_h // 2, pipe.spec.dst_w // 2, 12)
    np.testing.assert_allclose(x, ref_x, atol=1e-6)
    assert_outputs_match(pipe.process_batch(frames), ref_pipe.process_batch(frames))
