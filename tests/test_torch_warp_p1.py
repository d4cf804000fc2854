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
from tti_torch.kernels.warp_p1 import warp_pass1_decimated, warp_pass1_decimated_plain
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
    got = warp_pass1_decimated(torch.from_numpy(frames), warp.w1, **_kw(spec, k, warp.pad_value))
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
    i1 = warp_pass1_decimated(torch.from_numpy(frames), warp.w1, **_kw(spec, k, warp.pad_value))
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
    got = warp_pass1_decimated(torch.from_numpy(frames), torch.from_numpy(w1), k=3, off=1,
                               hs=9, ws=21, pad_value=0.25)
    x = frames[:, 1::3, 1::3, ::-1][:, :9, :21].astype(np.float64) / 255.0 - 0.25
    ref = np.einsum("bywc,ywo->ycbo", x, w1.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    keep = warp_pass1_decimated(torch.from_numpy(frames), torch.from_numpy(w1), k=3, off=1,
                                hs=9, ws=21, pad_value=0.25, bgr_flip=False)
    np.testing.assert_allclose(keep.numpy()[:, ::-1], ref, atol=1e-5)


def test_bfloat16_steps_multiply_and_do_not_divide():
    """In bfloat16 the three steps round one by one, and bfloat16(1/255) is
    129/32768 (0.39% above 1/255): with identity weights the output is
    exactly bf16(bf16(x * 129/32768) - bf16(pad)), which differs from the
    division x / 255 for some bytes."""
    frames = np.arange(256, dtype=np.uint8).reshape(1, 1, 256, 1).repeat(3, -1)
    w1 = torch.eye(256, dtype=torch.bfloat16)[None]
    got = warp_pass1_decimated_plain(torch.from_numpy(frames), w1, k=1, off=0, hs=1, ws=256,
                                     pad_value=114 / 255)
    x = torch.arange(256, dtype=torch.float32)
    pad = torch.tensor(114 / 255, dtype=torch.bfloat16)
    want = ((x * (129 / 32768)).to(torch.bfloat16) - pad).to(torch.bfloat16)
    assert torch.equal(got[0, 0, 0], want)
    divided = ((x.to(torch.bfloat16) / torch.tensor(255.0, dtype=torch.bfloat16)) - pad)
    assert (divided != want).sum() > 10


@pytest.mark.parametrize("bad", ["channels", "rows", "cols", "width", "w1", "dtype"])
def test_geometry_errors(bad):
    frames = torch.zeros((1, 30, 60, 3), dtype=torch.uint8)
    w1 = torch.zeros((10, 20, 20))
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
    else:
        frames, err = frames.float(), TypeError
    with pytest.raises(err):
        warp_pass1_decimated(frames, w1, **kw)


def test_other_devices_are_refused():
    frames = torch.zeros((1, 30, 60, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        warp_pass1_decimated(frames, torch.zeros((10, 20, 20), device="meta"), k=3, off=1,
                             hs=10, ws=20, pad_value=0.0)


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
    got = warp_pass1_decimated(f, warp.w1, **_kw(spec, k, warp.pad_value))
    ref = warp_pass1_decimated_plain(f, warp.w1, **_kw(spec, k, warp.pad_value))
    assert warp_p1.LAUNCHES["warp_pass1_decimated"] == 1
    assert torch.equal(got, ref)
