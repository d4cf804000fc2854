"""Divisions by a constant fixed when ``tti`` traces its step.

XLA rewrites ``x / c``, ``c`` a constant at trace time, into ``x * (1 / c)``
with the reciprocal taken in float32, and PyTorch's CUDA division by a
Python scalar does the same. ``tti``'s step, dual step, space step,
predictor and frozen step are jitted, so they multiply; the port takes
every such division through ``tti_torch.preprocess.letterbox.jit_divide``,
on the CPU as on the card. Each case holds a port function bit for bit
against ``jax.jit`` of its ``tti`` counterpart, with the divisor a Python
number or an array the jitted function closes over, as the step closes over
its spec and camera:

- ``scale_boxes_to_frame`` on 100,000 seeded boxes at the bench's three
  geometries and 480x640/640, and one box whose centre lands exactly on the
  bench ROI's top bound by ``tti``'s mapping (a true division puts it an ulp
  above the frame's row 300 and the ROI gate drops it);
- ``normalize``, ``letterbox_content`` (decimated and bilinear) and
  ``letterbox_u8`` in float32 and bfloat16, at the exact decimation and at
  scale 1 (at a non-integer scale the resize itself rounds otherwise:
  ``F.interpolate`` against ``jax.image.resize``);
- ``PackedRemap.apply_packed``'s unpacking by 255;
- the mask-grid mappings of the measurement (``/ scale``, ``/ q``; their
  constant terms summed first, as XLA folds ``(a + c1) - c2``);
- ``undistort_points`` with the focal lengths of a closed-over camera
  matrix, as the undistorted step runs it (zero distortion);
- kernel F's plain version, the per-sample scale ``max(absmax, 1e-12) / 127``
  of ``TTI_QUANT=int8``;
- the trainer, whose augment (``make_augment_fn``'s ``batch_fn``) and step
  (``make_train_step``) ``tti`` jits: the hue's ``/ 6`` in ``_rgb_to_hsv``
  (float32 and bfloat16), the GT boxes' ``/ s_px`` at imgsz 640 and 96, the
  EMA ramp's ``/ ema_tau`` over steps 1-20,000, optax's warmup and cosine
  divisions over a run's steps (and XLA's fold of ``pi / decay``), the
  batch mean of the loss terms and the global-batch BatchNorm's division by
  its count.

XLA's CPU backend also contracts ``a * b + c`` into a fused multiply-add
and takes its own ``exp`` and ``cos``; PyTorch and numpy do neither. Where
such an operation follows a division, the case holds the port against
``tti``'s expression with the division from ``jax.jit`` and the rest in
float32 without contraction, so the division itself is compared bit for bit
(ROADMAP Queue 3 records the rest).
"""

from __future__ import annotations

import importlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.calib import geometry as jgeo
from tti.model.layers import quantize_act_per_sample
from tti.train import augment as jaug
from tti.train.step import make_train_step
from tti_torch.model.layers import stats_from_sums
from tti_torch.train import augment as taug
from tti_torch.train import step as tstep
from tti_torch.calib import geometry as tgeo
from tti_torch.kernels import int8conv as ik
from tti_torch.measure import pipeline as tpipe
from tti_torch.preprocess import letterbox as tlb
from tti_torch.preprocess import remap as tremap

jlb = importlib.import_module("tti.preprocess.letterbox")
jremap = importlib.import_module("tti.preprocess.remap")
jpipe = importlib.import_module("tti.measure.pipeline")

# (frame h, w, imgsz): the bench's deploy and headline rows, the bench
# test's small headline geometry, and a geometry at scale 1.
GEOMETRIES = {"headline": (1080, 1920, 640), "deploy": (960, 1280, 960),
              "small": (360, 640, 384), "scale1": (480, 640, 640)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _count_differing(got, want) -> int:
    """Values whose bits differ (both sides as float32, exact for bf16)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    return int(np.count_nonzero(got.astype(np.float32).view(np.uint32) != want.view(np.uint32)))


def _specs(name):
    h, w, t = GEOMETRIES[name]
    return tlb.letterbox_spec(h, w, t), jlb.letterbox_spec(h, w, t)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_scale_boxes_to_frame_equals_tti_jit(name):
    spec, jspec = _specs(name)
    boxes = np.random.default_rng(0).uniform(0, spec.dst_w, (100_000, 4)).astype(np.float32)
    got = tlb.scale_boxes_to_frame(torch.from_numpy(boxes), spec)
    want = jax.jit(lambda b: jlb.scale_boxes_to_frame(b, jspec))(boxes)
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {boxes.size} coordinates differ from tti's jitted mapping"


def _box_on_the_bound(spec, bound: float) -> np.ndarray:
    """An xyxy input box whose centre row lands exactly on ``bound`` by the
    product with the float32 reciprocal, and off it by a true division."""
    s = np.float32(spec.scale)
    inv, pad = np.float32(1.0) / s, np.float32(spec.pad_top)
    centre = lambda to_frame, a, b: np.float32(0.5) * np.float32(to_frame(a) + to_frame(b))
    product = lambda y: np.float32((y - pad) * inv)
    quotient = lambda y: np.float32((y - pad) / s)
    mid = np.float32(spec.pad_top + bound * spec.scale)
    for half in np.arange(1.0, 40.0, 0.37, dtype=np.float32):
        top, bottom = np.float32(mid - half), np.float32(mid + half)
        for _ in range(40):
            bottom = np.nextafter(bottom, np.float32(-np.inf))
        for _ in range(80):
            if (centre(product, top, bottom) == bound
                    and centre(quotient, top, bottom) != bound):
                return np.array([[300.0, top, 340.0, bottom]], np.float32)
            bottom = np.nextafter(bottom, np.float32(np.inf))
    raise AssertionError("no box found on the bound")


def test_roi_gate_on_a_bound():
    """The headline geometry and the bench ROI at 1080x1920 (rows 300-880):
    a box centred on row 300 by ``tti``'s jitted mapping passes both gates;
    the true division would have put it above the ROI."""
    spec, jspec = _specs("headline")
    roi = (10.0, 300.0, 1910.0, 880.0)
    box = _box_on_the_bound(spec, roi[1])
    want = jax.jit(lambda b: jpipe.roi_center_gate(jlb.scale_boxes_to_frame(b, jspec), roi))(box)
    got = tpipe.roi_center_gate(tlb.scale_boxes_to_frame(torch.from_numpy(box), spec), roi)
    assert np.asarray(want).tolist() == got.tolist() == [True]
    divided = torch.from_numpy(box).clone()
    divided[:, 1::2] = (divided[:, 1::2] - spec.pad_top) / spec.scale
    divided[:, 0::2] = (divided[:, 0::2] - spec.pad_left) / spec.scale
    assert tpipe.roi_center_gate(divided, roi).tolist() == [False]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normalize_every_byte_equals_tti_jit(dtype):
    tdt, jdt = DTYPES[dtype]
    u8 = np.arange(256, dtype=np.uint8)
    got = tlb.normalize(torch.from_numpy(u8), tdt)
    assert got.dtype == tdt
    n = _count_differing(got, jax.jit(lambda x: jlb.normalize(x, jdt))(u8))
    assert n == 0, f"{n} of 256 byte values differ from tti's jitted normalize"


@pytest.mark.parametrize("fn", ["content_decimated", "content_bilinear", "u8"])
@pytest.mark.parametrize("geometry", [(1080, 1920, 640), (360, 640, 640)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_letterbox_equals_tti_jit(fn, geometry, dtype, monkeypatch):
    """At the exact decimation (k = 3) and at scale 1, where the resize
    itself is exact; ``tti``'s bilinear content under its default switches
    (its row slice at batch 2)."""
    for var in ("TTI_LETTERBOX_DECIMATE", "TTI_LETTERBOX_ROWSLICE"):
        monkeypatch.delenv(var, raising=False)
    tdt, jdt = DTYPES[dtype]
    h, w, t = geometry
    spec, jspec = tlb.letterbox_spec(h, w, t), jlb.letterbox_spec(h, w, t)
    frames = np.random.default_rng(1).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    if fn == "u8":
        got = tlb.letterbox_u8(torch.from_numpy(frames), spec, tdt)
        want = jax.jit(lambda x: jlb.letterbox_u8(x, jspec, jdt))(frames)
    else:
        decimate = fn == "content_decimated"
        got = tlb.letterbox_content(torch.from_numpy(frames), spec, tdt, decimate=decimate)
        want = jax.jit(lambda x: jlb.letterbox_content(x, jspec, jdt, decimate=decimate))(frames)
    assert got.dtype == tdt
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {got.numel()} values differ from tti's jitted letterbox"


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_packed_remap_unpack_equals_tti_jit(interp, dtype, monkeypatch):
    monkeypatch.delenv("TTI_REMAP_SWAR", raising=False)
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    src_hw = (24, 40)
    map_xy = np.stack([rng.uniform(-2, 42, (30, 36)), rng.uniform(-2, 26, (30, 36))],
                      -1).astype(np.float32)
    words = rng.integers(0, 1 << 24, (2, src_hw[0] * src_hw[1]), dtype=np.int64)
    got_r = tremap.PackedRemap(map_xy, src_hw, interp=interp, device="cpu")
    ref_r = jremap.PackedRemap(map_xy, src_hw, interp=interp)
    got = got_r.apply_packed(torch.from_numpy(words.astype(np.int32)), tdt)
    want = jax.jit(lambda p: ref_r.apply_packed(p, jdt))(words.astype(np.uint32))
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {got.numel()} values differ from tti's jitted unpacking"


@pytest.mark.parametrize("q", [2.0, 4.0])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_mask_grid_mappings_equal_tti_jit(name, q):
    spec, _ = _specs(name)
    cells = np.random.default_rng(4).uniform(0, spec.dst_w / q, 20_000).astype(np.float32)
    frame_x = np.random.default_rng(5).uniform(0, spec.src_w, 20_000).astype(np.float32)
    pairs = [(tpipe.mask_center_to_frame, jpipe._mask_center_to_frame, cells, spec.pad_left),
             (tpipe.mask_center_to_frame, jpipe._mask_center_to_frame, cells, spec.pad_top),
             (tpipe.mask_left_to_frame, jpipe._mask_left_to_frame, cells, spec.pad_left),
             (tpipe.mask_right_to_frame, jpipe._mask_right_to_frame, cells, spec.pad_left),
             (tpipe.mask_bottom_to_frame, jpipe._mask_bottom_to_frame, cells, spec.pad_top),
             (tpipe.frame_x_to_mask_col, jpipe._frame_x_to_mask_col, frame_x, spec.pad_left)]
    for port_fn, tti_fn, x, pad in pairs:
        got = port_fn(torch.from_numpy(x), float(pad), spec.scale, q)
        want = jax.jit(lambda v: tti_fn(v, float(pad), spec.scale, q))(x)
        assert _count_differing(got, want) == 0, port_fn.__name__


@pytest.mark.parametrize("iters", [0, 5])
def test_undistort_points_closed_over_camera_equals_tti_jit(ref_intrinsics, iters):
    """The undistorted step measures with zero distortion and no iterations
    (``tti``'s runtime sets both); its camera matrix is a constant of the
    jitted step, so ``/ fy`` and ``/ fx`` are products with reciprocals."""
    K = np.asarray(ref_intrinsics[0], np.float32)
    uv = np.random.default_rng(6).uniform(0, [1280, 960], (100_000, 2)).astype(np.float32)
    Kj, dj = jnp.asarray(K), jnp.zeros(5, jnp.float32)
    want = jax.jit(lambda u: jgeo.undistort_points(u, Kj, dj, iters=iters))(uv)
    got = tgeo.undistort_points(torch.from_numpy(uv), torch.from_numpy(K), torch.zeros(5),
                                iters=iters)
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {uv.size} coordinates differ from tti's jitted undistort"


def test_act_scale_equals_tti_jit():
    """4096 samples over ten octaves of magnitude, and a zero sample (the
    1e-12 floor); the codes of ``x / s`` (a run-time divisor, a true
    division in both) then agree too."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4096, 3, 3, 8))
         * np.exp(rng.uniform(-5, 5, (4096, 1, 1, 1)))).astype(np.float32)
    x[0] = 0.0
    q_ref, s_ref = jax.jit(quantize_act_per_sample)(x)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    scale = ik.act_scale_per_sample(nchw)
    n = _count_differing(scale, np.asarray(s_ref).reshape(-1))
    assert n == 0, f"{n} of {scale.numel()} scales differ from tti's jitted scale"
    codes = ik.quantize_act_plain(nchw, scale).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(q_ref))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rgb_to_hsv_equals_tti_jit(dtype):
    """A million RGB triples, uniform and on the 8-bit grid: the hue's ``/
    6.0`` (a constant) as the product, the divisions by the chroma and the
    value (run-time) true divisions."""
    tdt, jdt = DTYPES[dtype]
    rgb = np.random.default_rng(8).uniform(0, 1, (1_000_000, 3)).astype(np.float32)
    rgb[::2] = np.round(rgb[::2] * 255.0) / 255.0
    want = jax.jit(jaug._rgb_to_hsv)(jnp.asarray(rgb, jdt))
    got = taug._rgb_to_hsv(torch.from_numpy(rgb).to(tdt))
    assert got.dtype == tdt
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {got.numel()} values differ from tti's jitted _rgb_to_hsv"


@pytest.mark.parametrize("s_px", [640, 96])
def test_canvas_to_out_equals_tti_jit(s_px):
    """The GT boxes' canvas -> output mapping at imgsz ``s_px`` on 100,000
    seeded coordinates, windows, scales and shifts: ``(c - origin) / s_px``
    from ``tti``'s jit, the rest of its ``canvas_to_out`` in float32."""
    rng = np.random.default_rng(9)
    n, f32 = 100_000, np.float32
    c, origin = rng.uniform(0, 2 * s_px, n).astype(f32), rng.uniform(0, s_px, n).astype(f32)
    sc, shift = rng.uniform(0.5, 1.5, n).astype(f32), rng.uniform(-0.1, 0.1, n).astype(f32)
    u = np.asarray(jax.jit(lambda a, b: (a - b) / s_px)(c, origin))
    want = ((u - f32(0.5)) * sc + f32(0.5) + shift) * f32(s_px)
    t = torch.from_numpy
    got = taug.canvas_to_out(t(c), t(origin), t(sc), t(shift), s_px)
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {c.size} coordinates differ from tti's jitted mapping"


def test_ema_decay_equals_tti_jit():
    """Steps 1-20,000 at ``make_train_step``'s defaults: ``-step / ema_tau``
    from ``tti``'s jit, then ``ema_decay * (1 - exp(.))`` in float32."""
    params = inspect.signature(make_train_step).parameters
    decay, tau = params["ema_decay"].default, params["ema_tau"].default
    assert (decay, tau) == (tstep.EMA_DECAY, tstep.EMA_TAU)
    steps = np.arange(1, 20_001, dtype=np.int32)
    f32 = np.float32
    arg = np.asarray(jax.jit(lambda s: -s.astype(jnp.float32) / tau)(steps))
    want = f32(decay) * (f32(1) - np.exp(arg))
    got = np.array([tstep.ema_decay(int(s)) for s in steps], f32)
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {steps.size} EMA weights differ from tti's jitted ramp"


@pytest.mark.parametrize("total", [100, 7777, 20_000])
def test_schedule_equals_tti_jit(total):
    """Every update of a run of ``total`` steps and a few past it: the
    warmup's ``count / warmup`` and the cosine's ``pi * count / decay`` (XLA
    folds ``pi / decay``) from ``tti``'s jit of optax's expressions, the rest
    of ``warmup_cosine_decay_schedule`` in float32."""
    lr, f32 = 1e-3, np.float32
    warmup = max(20, min(1000, total // 20))
    warmup = max(min(warmup, max(total // 5, 1), total - 1), 0)
    decay = total - warmup
    init = end = lr * 1e-2
    alpha = end / lr
    counts = np.arange(0, total + 5, dtype=np.int32)
    frac = np.asarray(jax.jit(lambda c: jnp.clip(c, 0, warmup) / warmup)(counts))
    angle = np.asarray(jax.jit(lambda c: jnp.pi * jnp.minimum(c - warmup, float(decay))
                               / float(decay))(counts))
    ramp = f32(init - lr) * (f32(1) - frac) + f32(lr)
    cosine = f32(0.5) * (f32(1) + np.cos(angle))
    want = np.where(counts < warmup, ramp, f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))
    schedule = tstep.warmup_cosine_schedule(lr, total)
    got = np.array([schedule(int(c)) for c in counts], f32)
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {counts.size} learning rates differ from tti's jitted schedule"


@pytest.mark.parametrize("batch", [3, 6])
def test_batch_mean_equals_tti_jit(batch):
    """The loss terms' mean over a batch that is not a power of two, on
    10,000 seeded batches: ``jnp.mean``'s division by the batch from
    ``tti``'s jit, on the port's sum (XLA sums a row in order, PyTorch's CPU
    sum in lanes: the CPU libraries' own rounding, recorded)."""
    v = torch.from_numpy(np.random.default_rng(10).exponential(size=(10_000, batch)
                                                               ).astype(np.float32))
    want = jax.jit(lambda s: s / batch)(torch.stack([r.sum(0) for r in v]).numpy())
    got = torch.stack([tstep.batch_mean(r) for r in v])
    n = _count_differing(got, want)
    assert n == 0, f"{n} of {v.shape[0]} means differ from tti's jitted mean"


@pytest.mark.parametrize("count", [2 * 40 * 40, 3 * 23 * 30 * 2])
def test_batchnorm_stats_equal_tti_jit(count):
    """The global-batch BatchNorm's statistics from its per-channel sums
    over ``count`` values (flax's ``jnp.mean`` under ``tti``'s jit, a shape
    as divisor): ``sum / count`` from the jit, ``max(mean(x^2) - mean^2,
    0)`` in float32."""
    rng = np.random.default_rng(11)
    c = 4096
    s1 = (rng.normal(size=c) * count).astype(np.float32)
    s2 = (np.abs(rng.normal(size=c)) * count * 4).astype(np.float32)
    mean = np.asarray(jax.jit(lambda s: s / count)(s1))
    mean2 = np.asarray(jax.jit(lambda s: s / count)(s2))
    want_var = np.maximum(mean2 - mean * mean, np.float32(0))
    got_mean, got_var = stats_from_sums(torch.from_numpy(np.concatenate([s1, s2])), count)
    assert _count_differing(got_mean, mean) == 0
    assert _count_differing(got_var, want_var) == 0
