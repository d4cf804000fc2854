"""The port's fused warp pass 1 (tti_torch.kernels.warp_p1) against tti's.

On the CPU the port's wrapper takes its plain version; tti's
``warp_pass1_decimated`` runs as tests/test_warp_p1.py runs it, in Pallas
interpret mode. Both get the same seeded uint8 frames and the same float32
weights. atol 2e-5: float32 products summed in another order, and the
multiply by 1/255 against the chain's division by 255.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.kernels.warp_p1 import warp_pass1_decimated as jax_pass1
from tti.preprocess.letterbox import decimation_stride, letterbox_spec
from tti.preprocess.remap import build_small_undistort_map
from tti.preprocess.warp2pass import TwoPassWarp as JaxWarp
from tti_torch.core.errors import ConfigError
from tti_torch.kernels import warp_p1
from tti_torch.kernels.warp_p1 import (pass1_window, warp_pass1_decimated,
                                       warp_pass1_decimated_plain)
from tti_torch.preprocess import letterbox as tlb
from tti_torch.preprocess.warp2pass import TwoPassWarp
from tests.torch_pair import assert_outputs_match, pipelines

DIST = np.array([0.0799, 0.0476, -0.0401, -0.0052, -0.1334])

# (frame side, imgsz, expected k): 240 px at imgsz 80 decimates by 3, 480 px
# at imgsz 96 by 5.
CASES = {"k3": (240, 80, 3), "k5": (480, 96, 5)}


def _setup(case, seed=7):
    side, imgsz, k = CASES[case]
    spec = letterbox_spec(side, side, imgsz)
    assert decimation_stride(spec) == k
    K = np.array([[937.14 * side / 1280, 0, 636.15 * side / 1280],
                  [0, 884.02 * side / 960, 422.39 * side / 960], [0, 0, 1.0]])
    m = build_small_undistort_map(K, DIST, spec, unpadded_src=True)
    frames = np.random.default_rng(seed).integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    return spec, k, m, frames


def _kw(spec, k, pad_value):
    return dict(k=k, off=(k - 1) // 2, hs=spec.new_h, ws=spec.new_w, pad_value=pad_value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass1_matches_tti_kernel(case):
    spec, k, m, frames = _setup(case)
    jwarp = JaxWarp(m, (spec.new_h, spec.new_w))
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu")
    ref = np.asarray(jax_pass1(jnp.asarray(frames), jwarp.w1, **_kw(spec, k, jwarp.pad_value)))
    warp_p1.reset_launch_counts()
    got = warp_pass1_decimated(torch.from_numpy(frames), warp.w1, warp.pass1_window(),
                               **_kw(spec, k, warp.pad_value))
    assert got.shape == ref.shape == (spec.new_h, 3, 2, warp.w1.shape[2])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert warp_p1.LAUNCHES["warp_pass1_decimated"] == 0  # the plain version is not counted


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pass1_then_pass2_matches_tti_and_the_unfused_chain(case, s2d):
    spec, k, m, frames = _setup(case)
    jwarp = JaxWarp(m, (spec.new_h, spec.new_w), s2d_out=s2d)
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), s2d_out=s2d, device="cpu")
    i1_ref = jax_pass1(jnp.asarray(frames), jwarp.w1, **_kw(spec, k, jwarp.pad_value))
    ref = np.asarray(jwarp.apply_pass2_ycbo(i1_ref, out_dtype=jnp.float32))
    i1 = warp_pass1_decimated(torch.from_numpy(frames), warp.w1, warp.pass1_window(),
                              **_kw(spec, k, warp.pad_value))
    got = warp.apply_pass2_ycbo(i1, torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # The unfused chain of the port: letterbox_content (divides by 255) -> apply.
    tspec = tlb.letterbox_spec(*frames.shape[1:3], CASES[case][1])
    content = tlb.letterbox_content(torch.from_numpy(frames), tspec, decimate=True)
    np.testing.assert_allclose(got, warp.apply(content).numpy(), atol=2e-5)


def test_plain_version_against_numpy_at_a_ragged_size():
    """hs 9 and wo 13 are multiples of nothing: the TPU kernel's hs % 8 rule
    and 128-column block are not the function's. float64 numpy, atol 1e-5."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 31, 63, 3), dtype=np.uint8)
    w1 = rng.normal(size=(9, 21, 13)).astype(np.float32)
    window = pass1_window(torch.from_numpy(w1))
    got = warp_pass1_decimated(torch.from_numpy(frames), torch.from_numpy(w1), window, k=3, off=1,
                               hs=9, ws=21, pad_value=0.25)
    x = frames[:, 1::3, 1::3, ::-1][:, :9, :21].astype(np.float64) / 255.0 - 0.25
    ref = np.einsum("bywc,ywo->ycbo", x, w1.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    keep = warp_pass1_decimated(torch.from_numpy(frames), torch.from_numpy(w1), window, k=3,
                                off=1, hs=9, ws=21, pad_value=0.25, bgr_flip=False)
    np.testing.assert_allclose(keep.numpy()[:, ::-1], ref, atol=1e-5)


def test_bfloat16_steps_multiply_and_do_not_divide():
    """In bfloat16 the three steps round one by one, and bfloat16(1/255) is
    129/32768 (0.39% above 1/255): with identity weights the output is
    exactly bf16(bf16(x * 129/32768) - bf16(pad)), which differs from the
    division x / 255 for some bytes."""
    frames = np.arange(256, dtype=np.uint8).reshape(1, 1, 256, 1).repeat(3, -1)
    w1 = torch.eye(256, dtype=torch.bfloat16)[None]
    got = warp_pass1_decimated_plain(torch.from_numpy(frames), w1, pass1_window(w1), k=1, off=0,
                                     hs=1, ws=256, pad_value=114 / 255)
    x = torch.arange(256, dtype=torch.float32)
    pad = torch.tensor(114 / 255, dtype=torch.bfloat16)
    want = ((x * (129 / 32768)).to(torch.bfloat16) - pad).to(torch.bfloat16)
    assert torch.equal(got[0, 0, 0], want)
    divided = ((x.to(torch.bfloat16) / torch.tensor(255.0, dtype=torch.bfloat16)) - pad)
    assert (divided != want).sum() > 10


@pytest.mark.parametrize("bad", ["channels", "rows", "cols", "width", "w1", "dtype", "window",
                                 "window_dtype"])
def test_geometry_errors(bad):
    frames = torch.zeros((1, 30, 60, 3), dtype=torch.uint8)
    w1 = torch.zeros((10, 20, 20))
    window = torch.zeros((10, 20, 2), dtype=torch.int32)
    kw = dict(k=3, off=1, hs=10, ws=20, pad_value=0.0)
    err = ValueError
    if bad == "channels":
        frames = torch.zeros((1, 30, 60, 4), dtype=torch.uint8)
    elif bad == "rows":
        kw["hs"], w1 = 11, torch.zeros((11, 20, 20))
    elif bad == "cols":
        kw["ws"], w1 = 21, torch.zeros((10, 21, 20))
    elif bad == "width":
        frames = torch.zeros((1, 30, 61, 3), dtype=torch.uint8)
    elif bad == "w1":
        w1 = torch.zeros((10, 19, 20))
    elif bad == "window":
        window = torch.zeros((10, 19, 2), dtype=torch.int32)
    elif bad == "window_dtype":
        window = window.long()
    else:
        frames, err = frames.float(), TypeError
    with pytest.raises(err):
        warp_pass1_decimated(frames, w1, window, **kw)


def test_other_devices_are_refused():
    frames = torch.zeros((1, 30, 60, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        warp_pass1_decimated(frames, torch.zeros((10, 20, 20), device="meta"),
                             torch.zeros((10, 20, 2), dtype=torch.int32, device="meta"), k=3,
                             off=1, hs=10, ws=20, pad_value=0.0)


def test_pipeline_with_the_kernel_route_matches_tti(ref_intrinsics, monkeypatch):
    """warp_pass1="kernel" against tti's pipeline, which runs the unfused
    chain (tti never wired its kernel): the tolerances of the whole-slice
    test. And against the port's own "einsum" route on the model input."""
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    pipe, ref_pipe, frames = pipelines("headline", ref_intrinsics,
                                       port_kw=dict(warp_pass1="kernel"))
    assert_outputs_match(pipe.process_batch(frames), ref_pipe.process_batch(frames))
    x = pipe.preprocess(torch.from_numpy(frames))
    pipe.warp_pass1 = "einsum"
    np.testing.assert_allclose(x.numpy(), pipe.preprocess(torch.from_numpy(frames)).numpy(),
                               atol=2e-5)


def test_kernel_route_needs_a_decimation_and_a_calibration(ref_intrinsics):
    with pytest.raises(ConfigError, match="decimation"):
        pipelines("deploy", ref_intrinsics, port_kw=dict(warp_pass1="kernel"))
    with pytest.raises(ConfigError, match="calibration"):
        pipelines("headline", ref_intrinsics, calibrated=False, port_kw=dict(warp_pass1="kernel"))
    with pytest.raises(ConfigError, match="two-pass"):
        pipelines("headline", ref_intrinsics, port_kw=dict(warp_pass1="kernel", remap="packed"))
    with pytest.raises(ConfigError, match="warp_pass1"):
        pipelines("headline", ref_intrinsics, port_kw=dict(warp_pass1="pallas"))


def _windows_of(w1: np.ndarray) -> np.ndarray:
    """The table by its definition, in numpy: (first, last + 1) of the
    non-zero source columns per (y, o), (0, 0) where there are none."""
    hs, ws, wo = w1.shape
    out = np.zeros((hs, wo, 2), np.int32)
    for y in range(hs):
        for o in range(wo):
            xs = np.nonzero(w1[y, :, o])[0]
            if xs.size:
                out[y, o] = xs[0], xs[-1] + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_is_the_nonzero_windows_of_w1(case, dtype):
    """TwoPassWarp's table equals the non-zero windows of the weights it
    holds, after their rounding to the weight type; it is made once."""
    spec, k, m, frames = _setup(case)
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu", weight_dtype=dtype)
    assert warp.w1_window is None
    table = warp.pass1_window()
    assert warp.pass1_window() is table and table.dtype == torch.int32
    want = _windows_of(warp.w1.float().numpy())
    np.testing.assert_array_equal(table.numpy(), want)
    assert (want[..., 1] - want[..., 0]).max() <= 2  # the bilinear map's two taps
    assert (want[..., 1] == 0).any()  # dead columns (the letterbox's sides) give (0, 0)
    assert warp.w1.shape[0] > 64  # the table is built 64 rows of y at a time: a second step


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_with_the_table_equals_the_dense_product(case):
    """The plain version with the warp's table gives the same output as with
    a table that spans every source column (the dense product), bit for
    bit, and that output is tti's (test_pass1_matches_tti_kernel)."""
    spec, k, m, frames = _setup(case)
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu")
    hs, ws, wo = warp.w1.shape
    full = torch.zeros((hs, wo, 2), dtype=torch.int32)
    full[..., 1] = ws
    f = torch.from_numpy(frames)
    kw = _kw(spec, k, warp.pad_value)
    got = warp_pass1_decimated(f, warp.w1, warp.pass1_window(), **kw)
    assert torch.equal(got, warp_pass1_decimated_plain(f, warp.w1, full, **kw))


@pytest.mark.parametrize("miss", ["first", "last", "dead", "outside"])
def test_a_table_that_misses_a_nonzero_raises(miss):
    """The plain version (the CPU route and the card's oracle) refuses a
    table that leaves out any non-zero weight."""
    spec, k, m, frames = _setup("k3")
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu")
    table = warp.pass1_window().clone()
    lo, hi = table[..., 0], table[..., 1]
    y, o = [int(v) for v in torch.nonzero(hi - lo == 2)[0]]
    if miss == "first":
        table[y, o, 0] += 1
    elif miss == "last":
        table[y, o, 1] -= 1
    elif miss == "dead":
        table[y, o] = 0
    else:
        table[y, o] = torch.tensor([int(hi[y, o]), int(hi[y, o]) + 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        warp_pass1_decimated(torch.from_numpy(frames), warp.w1, table,
                             **_kw(spec, k, warp.pad_value))
    # Widening a window is allowed: it only adds zero products.
    wide = warp.pass1_window().clone()
    wide[..., 0] = 0
    warp_pass1_decimated(torch.from_numpy(frames), warp.w1, wide, **_kw(spec, k, warp.pad_value))


def test_blocked_warp_has_no_table():
    """A blocked warp holds no dense W1: asking it for the table raises a
    clear error."""
    spec, k, m, frames = _setup("k3")
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu", block=32)
    assert warp.w1 is None and warp.w1_window is None
    with pytest.raises(ValueError, match="blocked"):
        warp.pass1_window()


def test_card_geometry_error():
    """What the kernel never takes, at any batch: wo not a multiple of 8
    (TMA rows of whole 16-byte units) and a decimation wider than MAX_K."""
    assert warp_p1.card_geometry_error(3, 640) is None
    assert warp_p1.card_geometry_error(warp_p1.MAX_K, 8) is None
    assert "multiple of 8" in warp_p1.card_geometry_error(3, 100)
    assert "decimation" in warp_p1.card_geometry_error(warp_p1.MAX_K + 2, 640)


def test_kernel_route_refuses_a_geometry_the_kernel_never_takes():
    """A square letterbox at imgsz 100 gives W1 100 output columns: the
    kernel route is refused when the pipeline is built, on every device, and
    the einsum route is not."""
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.model.checkpoint import load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    calib = CalibrationData(K=np.array([[90.0, 0, 150], [0, 90.0, 150], [0, 0, 1]]),
                            dist=np.array([0.05, 0.01, 0, 0, 0.0]),
                            rvec=np.array([-0.86, -0.39, -1.36]),
                            tvec=np.array([0.005, 0.036, 0.094]))
    variables = load_flax_msgpack("checkpoints/yolov8n_textile_cam.msgpack")
    build = lambda route: InspectionPipeline(
        ModelConfig(image_size=100, letterbox="square", dtype="float32", mask_stride=2,
                    proto_head="subpixel"), variables, (300, 300), calib, MeasureConfig(),
        RoiConfig(x_min=1, x_max=299, y_min=1, y_max=299), device="cpu", warp_pass1=route)
    with pytest.raises(ConfigError, match="multiple of 8, got 100"):
        build("kernel")
    assert build("einsum").warp.w1.shape[2] == 100


def test_operator_fake_takes_the_table():
    """The operator's fake implementation, with the table argument, gives
    the CPU implementation's shape, dtype and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec, k, m, frames = _setup("k5")
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device="cpu")
    args = (torch.from_numpy(frames), warp.w1, warp.pass1_window(), k, (k - 1) // 2, spec.new_h,
            spec.new_w, warp.pad_value, True)
    op = torch.ops.tti_torch.warp_pass1_decimated.default
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    assert real.shape == (spec.new_h, 3, 2, warp.w1.shape[2])


def test_kernel_route_pipeline_holds_the_table(ref_intrinsics, monkeypatch):
    """The kernel route builds the table when the pipeline is built (before
    any step or export trace); the einsum route never does."""
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    pipe = pipelines("headline", ref_intrinsics, port_kw=dict(warp_pass1="kernel"))[0]
    assert pipe.warp.w1_window is not None
    np.testing.assert_array_equal(pipe.warp.w1_window.numpy(),
                                  _windows_of(pipe.warp.w1.float().numpy()))
    assert pipelines("headline", ref_intrinsics)[0].warp.w1_window is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """bf16 on the card, the warp's own weights: at most two non-zero
    products per output, so the order of summation cannot matter."""
    spec, k, m, frames = _setup(case)
    warp = TwoPassWarp(m, (spec.new_h, spec.new_w), device=cuda_device)
    f = torch.from_numpy(frames).to(cuda_device)
    warp_p1.reset_launch_counts()
    got = warp_pass1_decimated(f, warp.w1, warp.pass1_window(), **_kw(spec, k, warp.pad_value))
    ref = warp_pass1_decimated_plain(f, warp.w1, warp.pass1_window(),
                                     **_kw(spec, k, warp.pad_value))
    assert warp_p1.LAUNCHES["warp_pass1_decimated"] == 1
    assert torch.equal(got, ref)


def _two_tap_w1(hs, ws, wo, seed, device):
    """A bilinear-like W1: two adjacent non-zero taps (j/64) per (y, o), so
    the kernel and its plain version must agree to the bit."""
    rng = np.random.default_rng(seed)
    w1 = np.zeros((hs, ws, wo), np.float32)
    x0 = rng.integers(0, ws - 1, (hs, wo))
    for y in range(hs):
        for o in range(wo):
            w1[y, x0[y, o]:x0[y, o] + 2, o] = rng.integers(1, 65, 2) / 64
    return torch.from_numpy(w1).to(device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,offset", [(1, 0), (2, 0), (1, 1), (2, 5)])
def test_kernel_takes_frames_that_do_not_start_or_end_on_16_bytes(cuda_device, batch, offset):
    """30x60 frames hold 5400 bytes, 8 past a multiple of 16: batch 1 ends
    off a 16-byte boundary and batch 2 does not; ``offset`` bytes into a
    buffer, the frames also start off one. The kernel takes every case and
    equals its plain version to the bit."""
    rng = np.random.default_rng(batch + 10 * offset)
    n = batch * 30 * 60 * 3
    buf = torch.from_numpy(rng.integers(0, 256, n + offset, dtype=np.uint8)).to(cuda_device)
    frames = buf[offset:].view(batch, 30, 60, 3)
    assert (frames.data_ptr() % 16 == 0) == (offset == 0)
    w1 = _two_tap_w1(10, 20, 16, 3, cuda_device)
    kw = dict(k=3, off=1, hs=10, ws=20, pad_value=114 / 255)
    warp_p1.reset_launch_counts()
    got = warp_pass1_decimated(frames, w1, pass1_window(w1), **kw)
    assert warp_p1.LAUNCHES["warp_pass1_decimated"] == 1
    assert torch.equal(got, warp_pass1_decimated_plain(frames, w1, pass1_window(w1), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 9])
def test_kernel_takes_the_widest_decimation_and_refuses_wider(cuda_device, batch):
    """k = MAX_K fits at every batch (at batch 9 the plan falls back from 16
    frames per item to 2); k = MAX_K + 2 and a wo that is not a multiple of
    8 raise before any launch."""
    k = warp_p1.MAX_K
    hs, ws = 2, 12
    frames = torch.randint(0, 256, (batch, k * hs, k * ws, 3), dtype=torch.uint8,
                           device=cuda_device)
    w1 = _two_tap_w1(hs, ws, 16, 4, cuda_device)
    kw = dict(k=k, off=(k - 1) // 2, hs=hs, ws=ws, pad_value=0.5)
    got = warp_pass1_decimated(frames, w1, pass1_window(w1), **kw)
    assert torch.equal(got, warp_pass1_decimated_plain(frames, w1, pass1_window(w1), **kw))
    wider = torch.zeros((1, (k + 2) * hs, (k + 2) * ws, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="decimation"):
        warp_pass1_decimated(wider, w1, pass1_window(w1), **dict(kw, k=k + 2, off=(k + 1) // 2))
    w12 = _two_tap_w1(hs, ws, 12, 5, cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        warp_pass1_decimated(frames, w12, pass1_window(w12), **kw)
