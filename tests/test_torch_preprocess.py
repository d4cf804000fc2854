"""The port's letterbox, remap map, two-pass warp and camera geometry
against tti on the same numpy inputs (float32 on both sides)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.calib import geometry as jgeo
from tti.preprocess.warp2pass import TwoPassWarp as JaxWarp
from tti_torch.calib import geometry as tgeo
from tti_torch.model.yolo import space_to_depth2
from tti_torch.preprocess import letterbox as tlb
from tti_torch.preprocess import remap as tremap
from tti_torch.preprocess.warp2pass import PAD_ROWS, TwoPassWarp, split_exactly

# tti.preprocess re-exports functions under its module names.
jlb = importlib.import_module("tti.preprocess.letterbox")
jremap = importlib.import_module("tti.preprocess.remap")


@pytest.mark.parametrize("args", [(960, 1280, 960, "rect"), (1080, 1920, 640, "rect"),
                                  (240, 320, 240, "square"), (216, 384, 128, "rect"),
                                  (240, 320, 240, "rect")])
def test_letterbox_specs_match(args):
    h, w, t, mode = args
    got = tlb.make_letterbox_spec(h, w, t, mode)
    ref = jlb.make_letterbox_spec(h, w, t, mode)
    assert got.__dict__ == ref.__dict__
    assert tlb.decimation_stride(got) == jlb.decimation_stride(ref)


def test_letterbox_content_bilinear_075_matches_jax_resize():
    """0.75 scale, bilinear with antialias=False against jax.image.resize,
    every output pixel including the borders. 1e-5: float32 lerp order."""
    frames = np.random.default_rng(0).integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
    spec = tlb.letterbox_spec(240, 320, 240)
    assert spec.scale == 0.75 and (spec.new_h, spec.new_w) == (180, 240)
    got = tlb.letterbox_content(torch.from_numpy(frames), spec).numpy()
    ref = np.asarray(jlb.letterbox_content(jnp.asarray(frames), jlb.letterbox_spec(240, 320, 240)))
    assert got.shape == ref.shape == (2, 180, 240, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-5)
    np.testing.assert_allclose(got[:, :, [0, -1]], ref[:, :, [0, -1]], atol=1e-5)


def test_letterbox_content_exact_decimation():
    """x3 decimation: the strided slice equals tti's jitted one bit for bit
    (its division by 255 is XLA's product with the reciprocal), and equals
    the bilinear resize of the same frames."""
    frames = np.random.default_rng(1).integers(0, 256, (2, 216, 384, 3), dtype=np.uint8)
    spec = tlb.make_letterbox_spec(216, 384, 128, "rect")
    jspec = jlb.make_letterbox_spec(216, 384, 128, "rect")
    assert tlb.decimation_stride(spec) == 3
    got = tlb.letterbox_content(torch.from_numpy(frames), spec, decimate=True).numpy()
    ref = np.asarray(jax.jit(lambda x: jlb.letterbox_content(x, jspec, decimate=True))(
        jnp.asarray(frames)))
    np.testing.assert_array_equal(got, ref)
    resized = tlb.letterbox_content(torch.from_numpy(frames), spec, decimate=False).numpy()
    np.testing.assert_allclose(resized, got, atol=1e-6)
    padded = tlb.letterbox_u8(torch.from_numpy(frames), spec).numpy()
    np.testing.assert_array_equal(
        padded, np.asarray(jax.jit(lambda x: jlb.letterbox_u8(x, jspec))(jnp.asarray(frames))))


def test_scale_boxes_to_frame():
    spec = tlb.make_letterbox_spec(960, 1280, 960, "rect")
    jspec = jlb.make_letterbox_spec(960, 1280, 960, "rect")
    boxes = np.random.default_rng(2).uniform(-50, 1000, (3, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(tlb.scale_boxes_to_frame(torch.from_numpy(boxes), spec).numpy(),
                               np.asarray(jlb.scale_boxes_to_frame(jnp.asarray(boxes), jspec)),
                               atol=1e-4)


def test_geometry_matches(ref_intrinsics, ref_extrinsics):
    """float32 on both sides; 1e-4 relative covers the op order."""
    K, dist = ref_intrinsics
    rvec, tvec = ref_extrinsics
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    j = lambda a: jnp.asarray(np.asarray(a), jnp.float32)
    R = tgeo.rodrigues(f(rvec))
    np.testing.assert_allclose(R.numpy(), np.asarray(jgeo.rodrigues(j(rvec))), atol=1e-6)
    np.testing.assert_allclose(tgeo.rodrigues(torch.zeros(3)).numpy(), np.eye(3))
    uv = np.random.default_rng(3).uniform([0, 0], [1280, 960], (2, 9, 2)).astype(np.float32)
    for iters in (0, 5):
        got = tgeo.undistort_points(f(uv), f(K), f(dist), iters=iters).numpy()
        ref = np.asarray(jgeo.undistort_points(j(uv), j(K), j(dist), iters=iters))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        mm, ok = tgeo.pixels_to_plane_mm(f(uv), f(K), f(dist), R, f(tvec), iters=iters)
        rmm, rok = jgeo.pixels_to_plane_mm(j(uv), j(K), j(dist), jgeo.rodrigues(j(rvec)),
                                           j(tvec), iters=iters)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
        np.testing.assert_allclose(mm.numpy(), np.asarray(rmm), rtol=1e-4, atol=1e-3)
    xy = np.random.default_rng(4).uniform(-0.5, 0.5, (11, 2)).astype(np.float32)
    np.testing.assert_allclose(tgeo.distort_points(f(xy), f(K), f(dist)).numpy(),
                               np.asarray(jgeo.distort_points(j(xy), j(K), j(dist))), rtol=1e-5)


def _small_geometry(ref_intrinsics, frame_hw, imgsz):
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= frame_hw[1] / 1280.0
    K[1] *= frame_hw[0] / 960.0
    spec = tlb.make_letterbox_spec(*frame_hw, imgsz, "rect")
    jspec = jlb.make_letterbox_spec(*frame_hw, imgsz, "rect")
    return K, dist, spec, jspec


@pytest.mark.parametrize("frame_hw,imgsz", [((240, 320), 240), ((216, 384), 128)])
def test_small_undistort_map_matches(ref_intrinsics, frame_hw, imgsz):
    K, dist, spec, jspec = _small_geometry(ref_intrinsics, frame_hw, imgsz)
    np.testing.assert_allclose(tremap.scaled_intrinsics(K, spec), jremap.scaled_intrinsics(K, jspec))
    got = tremap.build_small_undistort_map(K, dist, spec, unpadded_src=True)
    ref = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=True)
    # Both evaluate distort_points in float32, in the same order: equal.
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("frame_hw,imgsz", [((240, 320), 240), ((216, 384), 128)])
def test_two_pass_warp_matches(ref_intrinsics, frame_hw, imgsz):
    """Weights from the same map are identical; apply(s2d_out=True) agrees
    to float32 summation order (1e-5)."""
    K, dist, spec, jspec = _small_geometry(ref_intrinsics, frame_hw, imgsz)
    small_map = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=True)
    src_hw = (spec.new_h, spec.new_w)
    warp = TwoPassWarp(small_map, src_hw, s2d_out=True, device="cpu")
    jwarp = JaxWarp(small_map, src_hw, s2d_out=True)
    np.testing.assert_array_equal(warp.w1.numpy(), np.asarray(jwarp.w1))
    # W2 holds the reference's weights, then the pad's terms on every row.
    hs = src_hw[0]
    assert warp.w2.shape[-1] == hs + PAD_ROWS
    np.testing.assert_array_equal(warp.w2[..., :hs].numpy(), np.asarray(jwarp.w2))
    np.testing.assert_array_equal(warp.w2[..., hs:].sum(-1).numpy(),
                                  np.full(warp.w2.shape[:-1], np.float32(warp.pad_value)))
    frames = np.random.default_rng(5).integers(0, 256, (2, *frame_hw, 3), dtype=np.uint8)
    content = tlb.letterbox_content(torch.from_numpy(frames), spec, decimate=True)
    got = warp(content).numpy()
    ref = np.asarray(jwarp(jnp.asarray(content.numpy())))
    assert got.shape == ref.shape == (2, spec.dst_h // 2, spec.dst_w // 2, 12)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    plain = TwoPassWarp(small_map, src_hw, s2d_out=False, device="cpu")
    np.testing.assert_allclose(space_to_depth2(plain(content)).numpy(), got, atol=1e-5)


def _bf16_step(x):
    """One bfloat16 step at the magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -100))) - 7)


def _within_one_bf16_step(got, ref):
    err = np.abs(got - ref)
    return err <= _bf16_step(np.maximum(np.abs(got), np.abs(ref)))


class _JnpWithUpcastDots:
    """jax.numpy, except that einsum upcasts its operands to float32 first.
    XLA's CPU runtime has no bfloat16 x bfloat16 -> float32 dot; the upcast
    computes the same thing (the products are exact in float32, the sum is
    float32 either way), and tti's own roundings stay where they are."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, a, b, preferred_element_type=None):
        return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32),
                          precision="highest", preferred_element_type=preferred_element_type)


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "rows"])
def test_two_pass_warp_bf16_rounds_once(ref_intrinsics, s2d, monkeypatch):
    """bfloat16 weights on both sides, the same map and frames: tti adds the
    pad to the float32 accumulator of pass 2 and rounds once, and the port
    must land within one bfloat16 step of it at the value's own magnitude.
    Dark pixels make the case: the product is near -pad (step 2^-9) and the
    result near 0 (steps far finer), so a product rounded before the pad is
    added misses by hundreds of steps, which the last assertion shows."""
    monkeypatch.setattr(importlib.import_module("tti.preprocess.warp2pass"), "jnp",
                        _JnpWithUpcastDots())
    K, dist, spec, jspec = _small_geometry(ref_intrinsics, (216, 384), 128)
    small_map = jremap.build_small_undistort_map(K, dist, jspec, unpadded_src=True)
    src_hw = (spec.new_h, spec.new_w)
    warp = TwoPassWarp(small_map, src_hw, s2d_out=s2d, device="cpu", weight_dtype=torch.bfloat16)
    jwarp = JaxWarp(small_map, src_hw, s2d_out=s2d, weight_dtype=jnp.bfloat16)
    assert warp.w1.dtype == warp.w2.dtype == torch.bfloat16
    assert sum(split_exactly(warp.pad_value, torch.bfloat16)) == np.float32(warp.pad_value)
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2, 216, 384, 3), dtype=np.uint8)
    frames[:, :, :192] //= 8  # a dark half
    content = tlb.letterbox_content(torch.from_numpy(frames), spec, torch.bfloat16, decimate=True)
    jcontent = jnp.asarray(content.float().numpy(), jnp.bfloat16)
    got = warp(content)
    ref = np.asarray(jwarp(jcontent).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _within_one_bf16_step(got.float().numpy(), ref).all()

    # Pass 2 alone, from an intermediate in the kernel's (y, c, b, o) layout.
    i1 = (rng.integers(-114, 142, (src_hw[0], 3, 2, spec.dst_w)) / 255.0).astype(np.float32)
    i1_t = torch.from_numpy(i1).to(torch.bfloat16)
    got = warp.apply_pass2_ycbo(i1_t).float().numpy()
    ref = np.asarray(jwarp.apply_pass2_ycbo(jnp.asarray(i1_t.float().numpy(), jnp.bfloat16))
                     .astype(jnp.float32))
    assert got.shape == ref.shape and _within_one_bf16_step(got, ref).all()
    # The product rounded to bfloat16 first, the pad added after: not within a step.
    w2 = warp.w2[..., :src_hw[0]]
    if s2d:
        y, c, b, o = i1_t.shape
        twice = torch.einsum("ycbod,odvey->bvoedc", i1_t.reshape(y, c, b, o // 2, 2), w2)
        twice = (twice + torch.tensor(warp.pad_value, dtype=torch.bfloat16)).reshape(ref.shape)
    else:
        twice = torch.einsum("ycbo,ovy->bvoc", i1_t, w2) + torch.tensor(warp.pad_value,
                                                                        dtype=torch.bfloat16)
        twice = torch.nn.functional.pad(twice, (0, 0, 0, 0, warp.row_start,
                                                warp.dst_hw[0] - warp.row_stop),
                                        value=warp.pad_value)
    assert not _within_one_bf16_step(twice.float().numpy(), ref).all()


def test_two_pass_warp_rejects_non_monotonic_map():
    m = np.stack(np.meshgrid(np.arange(8.0), np.arange(6.0)), -1).astype(np.float32)
    m[3, 2, 1] = m[1, 2, 1]  # column 2 folds back
    with pytest.raises(ValueError, match="monotonic"):
        TwoPassWarp(m, (6, 8), device="cpu")
