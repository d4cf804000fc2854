"""``tti``'s public helpers that no step calls, ported, against ``tti`` on
the CPU (float32, ``jax_default_matmul_precision="highest"``, the
conftest's), on the same seeded numpy inputs.

Tolerances:
- the measurement primitives (``tti_torch.measure.ops``): the envelopes,
  the edge mask, ``stitch_stats``' left/right/has_mask,
  ``nearest_edge_candidates`` (its distances an IEEE square root: PyTorch's
  float32 CPU ``sqrt`` lands an ulp low on about one value in six, so the
  port takes it in float64) and ``sample_envelope`` exact; the centroids
  rtol 1e-6 (a moment sum over the mask divided by its area);
- ``letterbox`` (the general bilinear letterbox) within 1e-6 in float32.
  In bf16 it is bit-equal to ``tti``'s at the upscale (480x640 -> 640)
  and at the exact decimation (1080x1920 -> 640). At a non-integer
  downscale the two bf16 resizes round otherwise: ``tti`` rounds its
  weights and the intermediate of its two separable contractions to bf16,
  PyTorch's kernel its own way (3 bf16 steps apart on 1080x1920 -> 416);
  there the port's is held no farther from the float32 resize than
  ``tti``'s;
- ``preprocess_frames`` exact at the exact decimation under
  ``TTI_LETTERBOX_DECIMATE`` and ``TTI_LETTERBOX_ROWSLICE`` (the switches
  the port logs as having no counterpart) at batch 1 and 33 (either side
  of ``tti``'s row-slice crossover, 32), within 1e-6 at an upscale;
  ``frame_points_to_input`` exact;
- ``project_points`` within 1e-4 px, and back through the port's
  ``undistort_points`` (20 iterations: its fixed point in float32; 12 leave
  2.1e-05 at the points farthest out) to the ideal coordinates within 1e-6;
  ``local_mm_per_px`` rtol 1e-5, the validity flags equal, rays parallel
  to the plane included;
- ``masks_at_frame`` exact at shapes where ``tti``'s float32 index map and
  the port's float64 one (cv2's) agree, except where a probability lies
  within 1e-5 of 0.5 (the bilinear upsample's rounding, as in
  ``test_torch_predict.py``); at shapes where they differ the port follows
  cv2's map, a recorded departure
  (``test_torch_predict.py::test_resize_nearest_cv2_follows_masks_to_frame``);
- ``InferenceError`` and ``ServiceError`` are ``tti``'s classes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tti.core as jcore
import tti.core.errors as jerr
from tti.calib import geometry as jgeo
from tti.measure import ops as jops
from tti.postprocess import masks as jmasks
import tti_torch.core as tcore
import tti_torch.core.errors as terr
from tti_torch.calib import geometry as tgeo
from tti_torch.measure import ops as tops
from tti_torch.postprocess import masks as tmasks

jlb = importlib.import_module("tti.preprocess.letterbox")  # the package re-exports names
tlb = importlib.import_module("tti_torch.preprocess.letterbox")

T = torch.from_numpy
J = jnp.asarray


# -- errors ---------------------------------------------------------------------

def test_errors_are_tti_classes():
    for name in ("InferenceError", "ServiceError"):
        port, ref = getattr(terr, name), getattr(jerr, name)
        assert issubclass(port, terr.TtiError) and port.__doc__ == ref.__doc__
    assert set(tcore.__all__) == set(jcore.__all__)
    assert tcore.InferenceError is terr.InferenceError


# -- measurement primitives -----------------------------------------------------

def _fabric(seed, h=40, w=56):
    """Unions of rectangles and noise, with an empty column and a full one."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(h, w)) > 0.85).astype(np.uint8)
    for _ in range(3):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        mask[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = 1
    mask[:, 7] = 0
    mask[:, 9] = 1
    return mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_envelopes_and_edge_mask_match_tti(seed):
    mask = _fabric(seed)
    for name in ("fabric_lower_envelope", "fabric_upper_envelope", "fabric_edge_mask"):
        got = getattr(tops, name)(T(mask))
        want = np.asarray(getattr(jops, name)(J(mask)))
        assert got.dtype == (torch.bool if name == "fabric_edge_mask" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # A float mask, and a batch of frames: each as alone.
    batch = np.stack([_fabric(seed + 10), mask]).astype(np.float32)
    for name in ("fabric_lower_envelope", "fabric_upper_envelope", "fabric_edge_mask"):
        got = getattr(tops, name)(T(batch)).numpy()
        for i in range(2):
            np.testing.assert_array_equal(got[i], np.asarray(getattr(jops, name)(J(batch[i]))))


def test_envelopes_of_an_empty_mask():
    empty = np.zeros((6, 5), np.uint8)
    for name in ("fabric_lower_envelope", "fabric_upper_envelope"):
        np.testing.assert_array_equal(getattr(tops, name)(T(empty)).numpy(), np.full(5, -1))
        np.testing.assert_array_equal(getattr(tops, name)(T(empty)).numpy(),
                                      np.asarray(getattr(jops, name)(J(empty))))
    assert not tops.fabric_edge_mask(T(empty)).any()


def _edge_case(name):
    """(edge mask, cx, cy, k) of each case."""
    rect = np.zeros((30, 40), np.uint8)
    rect[10:20, 5:35] = 1
    edge = np.array(jops.fabric_edge_mask(J(rect)))  # writable, for torch.from_numpy
    if name == "rectangle":
        return edge, 18.0, 3.0, 20
    if name == "ties":  # a centroid on the rectangle's axis: pairs at equal distance
        return edge, 19.5, 15.0, 24
    if name == "integer_ties":  # equal squared distances in integers: exact ties
        return edge, 20.0, 15.0, 40
    if name == "fewer_than_k":
        tiny = np.zeros((8, 8), bool)
        tiny[4, 4] = tiny[1, 6] = True
        return tiny, 0.0, 0.0, 5
    if name == "empty":
        return np.zeros((8, 8), bool), 3.0, 3.0, 4
    if name == "all_pixels":
        return np.ones((4, 5), bool), 1.25, 2.5, 20
    raise KeyError(name)


@pytest.mark.parametrize("name", ["rectangle", "ties", "integer_ties", "fewer_than_k", "empty",
                                  "all_pixels"])
def test_nearest_edge_candidates_matches_tti(name):
    edge, cx, cy, k = _edge_case(name)
    got = tops.nearest_edge_candidates(T(edge), cx, cy, k=k)
    want = jops.nearest_edge_candidates(J(edge), cx, cy, k=k)
    for g, w, field in zip(got, want, ("ys", "xs", "dist", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    ys, xs, dist, valid = (g.numpy() for g in got)
    n = int(edge.sum())
    assert valid.sum() == min(n, k) and valid[:min(n, k)].all()
    assert (ys[~valid] == 0).all() and (xs[~valid] == 0).all() and np.isinf(dist[~valid]).all()
    if name == "integer_ties":  # ties go to the lower row-major index
        d, flat = dist[valid], ys[valid] * edge.shape[1] + xs[valid]
        same = d[1:] == d[:-1]
        assert same.any() and (flat[1:][same] > flat[:-1][same]).all()


def test_nearest_edge_candidates_batch_and_bounds():
    edges = np.stack([_edge_case("rectangle")[0], _edge_case("rectangle")[0][::-1]])
    cx, cy = np.array([18.0, 3.5], np.float32), np.array([3.0, 25.0], np.float32)
    got = tops.nearest_edge_candidates(T(edges), T(cx), T(cy), k=8)
    for i in range(2):
        want = jops.nearest_edge_candidates(J(edges[i]), float(cx[i]), float(cy[i]), k=8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    small = np.ones((3, 4), bool)
    with pytest.raises(ValueError):
        tops.nearest_edge_candidates(T(small), 0.0, 0.0, k=13)
    with pytest.raises(Exception):  # tti: lax.top_k past the operand's size
        jops.nearest_edge_candidates(J(small), 0.0, 0.0, k=13)


def _stitches(seed, n=7, h=24, w=40):
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, h, w), np.float32)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
        hh, ww = rng.integers(2, 6), rng.integers(2, 6)
        masks[i, y:y + hh, x:x + ww] = rng.uniform(size=(hh, ww)) > 0.3
        boxes[i] = [x - 0.5, y - 0.25, x + ww + 0.75, y + hh + 0.5]
    masks[2] = 0  # an empty mask: the box's centre and sides
    valid = np.arange(n) != 4
    return masks, boxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_stitch_stats_matches_tti(seed):
    masks, boxes, valid = _stitches(seed)
    got = [g.numpy() for g in tops.stitch_stats(T(masks), T(boxes), T(valid))]
    want = [np.asarray(w) for w in jops.stitch_stats(J(masks), J(boxes), J(valid))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)  # cx
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)  # cy
    for i, field in ((2, "left"), (3, "right"), (4, "has_mask")):
        np.testing.assert_array_equal(got[i], want[i], err_msg=field)
    assert not got[4][2] and not got[4][4] and got[4].sum() == 5
    # Two frames at once, each as alone.
    m2, b2, v2 = _stitches(seed + 5)
    both = tops.stitch_stats(T(np.stack([masks, m2])), T(np.stack([boxes, b2])),
                             T(np.stack([valid, v2])))
    for g, w in zip(both, tops.stitch_stats(T(m2), T(b2), T(v2))):
        assert torch.equal(g[1], w)


def test_sample_envelope_matches_tti():
    rng = np.random.default_rng(4)
    env = rng.integers(0, 30, 48).astype(np.int32)
    env[rng.uniform(size=48) < 0.3] = -1
    env[20:28] = -1  # a gap wider than the neighbourhood
    cx = np.array([0.0, 0.5, 1.5, 2.5, 23.5, 24.0, 46.7, 47.5, -3.0, 60.0, 10.49],
                  np.float32)  # halves round to even; off the row clips
    nbr = np.arange(-3, 4, dtype=np.int32)
    got = tops.sample_envelope(T(env), T(cx), T(nbr))
    want = jops.sample_envelope(J(env), J(cx), J(nbr))
    for g, w, field in zip(got, want, ("env_y", "has_env")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert not got[1][5] and got[1][0]
    envs = np.stack([env, env[::-1].copy()])
    cxs = np.stack([cx, cx[::-1].copy()])
    both = tops.sample_envelope(T(envs), T(cxs), T(nbr))
    for i in range(2):
        one = jops.sample_envelope(J(envs[i]), J(cxs[i]), J(nbr))
        for g, w in zip(both, one):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


# -- letterbox -------------------------------------------------------------------

LETTERBOX = {  # (frame h, w), target: the upscale, the exact decimation, a non-integer downscale
    "upscale_480x640": ((480, 640), 640),
    "decimate_1080p": ((1080, 1920), 640),
    "downscale_1080p_416": ((1080, 1920), 416),
}


@pytest.mark.parametrize("name", sorted(LETTERBOX))
def test_letterbox_matches_tti(name):
    (h, w), target = LETTERBOX[name]
    frames = np.random.default_rng(h + target).uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    spec, jspec = tlb.letterbox_spec(h, w, target), jlb.letterbox_spec(h, w, target)
    got = tlb.letterbox(T(frames), spec)
    want = np.asarray(jlb.letterbox(J(frames), jspec))
    assert got.shape == want.shape == (1, target, target, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # The border: the first and last content rows and columns, and the pad.
    top, left = spec.pad_top, spec.pad_left
    for sl in (np.s_[:, top], np.s_[:, top + spec.new_h - 1], np.s_[:, :, left],
               np.s_[:, :, left + spec.new_w - 1]):
        np.testing.assert_allclose(got.numpy()[sl], want[sl], atol=1e-6)
    if top:
        assert (got.numpy()[:, :top] == np.float32(114.0 / 255.0)).all()

    got16 = tlb.letterbox(T(frames), spec, torch.bfloat16)
    want16 = np.asarray(jlb.letterbox(J(frames), jspec, jnp.bfloat16))
    assert got16.dtype == torch.bfloat16
    if name.startswith("downscale"):  # see the module's docstring
        err_port = np.abs(got16.float().numpy() - got.numpy()).max()
        err_tti = np.abs(want16.astype(np.float32) - want).max()
        assert err_port <= err_tti, (err_port, err_tti)
    else:
        patterns = lambda a: a.astype(np.int64)
        diff = np.abs(patterns(got16.view(torch.int16).numpy())
                      - patterns(np.asarray(want16).view(np.int16)))
        assert diff.max() <= 1


PREPROCESS = {  # (frame h, w), target: the exact decimation (k = 3) and an upscale
    "decimate": ((96, 192), 64),
    "upscale": ((48, 64), 64),
}
SWITCH_SETTINGS = {"default": {}, "decimate": {"TTI_LETTERBOX_DECIMATE": "1"},
                   "rowslice_on": {"TTI_LETTERBOX_ROWSLICE": "1"},
                   "rowslice_off": {"TTI_LETTERBOX_ROWSLICE": "0"}}


@pytest.mark.parametrize("batch", [1, 33])
@pytest.mark.parametrize("geometry", sorted(PREPROCESS))
@pytest.mark.parametrize("switches", sorted(SWITCH_SETTINGS))
def test_preprocess_frames_matches_tti(switches, geometry, batch, monkeypatch):
    """``tti``'s ``letterbox_u8`` slices the frame (``_integer_decimation``
    under ``TTI_LETTERBOX_DECIMATE=1``; its rows at batch <= 32 or under
    ``TTI_LETTERBOX_ROWSLICE=1``, never under ``=0``) where the port always
    takes the exact decimation (both switches ``NO_COUNTERPART``): the
    values are those of ``tti``'s jitted preprocess, whose division by 255
    is XLA's product with the reciprocal."""
    for var in ("TTI_LETTERBOX_DECIMATE", "TTI_LETTERBOX_ROWSLICE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in SWITCH_SETTINGS[switches].items():
        monkeypatch.setenv(var, value)
    (h, w), target = PREPROCESS[geometry]
    frames = np.random.default_rng(batch).integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    got, spec = tlb.preprocess_frames(T(frames), target)
    jspec = jlb.preprocess_frames(J(frames), target)[1]
    want = jax.jit(lambda x: jlb.preprocess_frames(x, target)[0])(J(frames))
    assert spec == tlb.LetterboxSpec(**vars(jspec))
    assert got.shape == (batch, target, target, 3)
    if geometry == "decimate":
        assert tlb.decimation_stride(spec) == 3
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("geometry", [(960, 1280, 960), (720, 1280, 416)])
def test_frame_points_to_input_matches_tti(geometry):
    h, w, target = geometry
    spec = tlb.letterbox_spec(h, w, target)
    pts = np.random.default_rng(5).uniform(0, [w, h], (3, 7, 2)).astype(np.float32)
    got = tlb.frame_points_to_input(T(pts), spec)
    want = np.asarray(jlb.frame_points_to_input(J(pts), jlb.letterbox_spec(h, w, target)))
    np.testing.assert_array_equal(got.numpy(), want)
    boxes = torch.cat([got, got], -1)  # back through the box transform, as tti's test
    np.testing.assert_allclose(tlb.scale_boxes_to_frame(boxes, spec)[..., :2].numpy(), pts,
                               atol=1e-3)


# -- geometry --------------------------------------------------------------------

def test_project_points_matches_tti_and_round_trips(ref_intrinsics, ref_extrinsics):
    K, dist = ref_intrinsics
    rvec, tvec = ref_extrinsics
    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.03, 0.03, (2, 40, 3))
    pts[..., 2] = rng.uniform(-0.005, 0.005, (2, 40))
    got = tgeo.project_points(T(pts), rvec, tvec, K, dist)
    want = np.asarray(jgeo.project_points(J(pts.astype(np.float32)), J(rvec), J(tvec), J(K),
                                          J(dist)))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    R = tgeo.rodrigues(torch.as_tensor(rvec, dtype=torch.float32))
    pc = T(pts.astype(np.float32)) @ R.T + torch.as_tensor(tvec, dtype=torch.float32)
    ideal = pc[..., :2] / pc[..., 2:3]
    back = tgeo.undistort_points(got, torch.as_tensor(K, dtype=torch.float32),
                                 torch.as_tensor(dist, dtype=torch.float32), iters=20)
    np.testing.assert_allclose(back.numpy(), ideal.numpy(), atol=1e-6)


def test_local_mm_per_px_matches_tti(ref_intrinsics, ref_extrinsics):
    K, dist = ref_intrinsics
    rvec, tvec = ref_extrinsics
    uv = np.random.default_rng(7).uniform([0, 0], [1280, 960], (3, 11, 2)).astype(np.float32)
    R = np.array(jgeo.rodrigues(J(rvec)))
    got, gv = tgeo.local_mm_per_px(T(uv), K, dist, R, tvec)
    want, wv = jgeo.local_mm_per_px(J(uv), K, dist, J(R), J(tvec, jnp.float32))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv.all() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # A plane whose normal is the camera's y axis: the rays of the row v = cy
    # (no distortion, so y = 0 exactly) run parallel to it.
    R_side = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    t_side = np.array([0.0, 0.05, 0.0], np.float32)
    uv_side = np.array([[100.0, K[1, 2]], [700.0, K[1, 2]], [640.0, 200.0], [300.0, 700.0]],
                       np.float32)
    got, gv = tgeo.local_mm_per_px(T(uv_side), K, np.zeros(5), R_side, t_side)
    want, wv = jgeo.local_mm_per_px(J(uv_side), K, np.zeros(5), J(R_side), J(t_side))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gv.numpy(), [False, False, True, True])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# -- masks at the frame ------------------------------------------------------------

def _maps_agree(in_hw, frame_hw) -> bool:
    """``tti``'s float32 nearest index map against cv2's float64 one."""
    f32 = lambda o, i: np.floor(np.arange(o, dtype=np.float32) * np.float32(i / o))
    f64 = lambda o, i: np.floor(np.arange(o) * (i / o))
    return all((f32(o, i) == f64(o, i)).all() for o, i in zip(frame_hw, in_hw))


MASKS_AT_FRAME = {  # (Hm, Wm) proto grid, (H, W) input, frame (h, w)
    "stride4_to_sensor": ((24, 32), (96, 128), (120, 171)),
    "stride2_to_frame": ((36, 48), (72, 96), (216, 384)),
    "maps_differ": ((8, 4), (32, 16), (300, 82)),
}


@pytest.mark.parametrize("name", sorted(MASKS_AT_FRAME))
def test_masks_at_frame_matches_tti(name):
    (hm, wm), hw, frame_hw = MASKS_AT_FRAME[name]
    rng = np.random.default_rng(hm * wm)
    n = 5
    protos = rng.normal(0, 1, (2, hm, wm, 32)).astype(np.float32)
    coefs = rng.normal(0, 0.5, (2, n, 32)).astype(np.float32)
    x1, y1 = rng.uniform(-4, hw[1] * 0.5, (2, n)), rng.uniform(-4, hw[0] * 0.5, (2, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, hw[1] * 0.6, (2, n)),
                      y1 + rng.uniform(4, hw[0] * 0.6, (2, n))], -1).astype(np.float32)
    valid = np.arange(n)[None].repeat(2, 0) < np.array([[n - 1], [n]])
    got = tmasks.masks_at_frame(T(protos), T(coefs), T(boxes), T(valid), hw, frame_hw).numpy()
    assert got.shape == (2, n, *frame_hw) and got.dtype == np.float32
    probs = tmasks.upsample_masks(tmasks.assemble_masks(T(protos), T(coefs), T(boxes), T(valid),
                                                        hw, threshold=None), hw).numpy()
    for b in range(2):
        want = np.asarray(jmasks.masks_at_frame(J(protos[b]), J(coefs[b]), J(boxes[b]),
                                                J(valid[b]), hw, frame_hw))
        near = (np.abs(probs[b] - 0.5) < 1e-5).any((1, 2))  # instances by the threshold
        assert near.sum() <= 1
        if _maps_agree(hw, frame_hw):
            np.testing.assert_array_equal(got[b][~near], want[~near])
        else:  # cv2's map, the port's one (the departure)
            at_input = tmasks.masks_at_input(T(protos[b]), T(coefs[b]), T(boxes[b]),
                                             T(valid[b]), hw)
            np.testing.assert_array_equal(
                got[b], tmasks.resize_nearest_cv2(at_input, frame_hw).numpy())
            assert (got[b][~near] != want[~near]).any()
        assert got[b][valid[b]].sum() > 0 and not got[b][~valid[b]].any()
    assert _maps_agree(*MASKS_AT_FRAME["stride4_to_sensor"][1:])
    assert not _maps_agree(*MASKS_AT_FRAME["maps_differ"][1:])
