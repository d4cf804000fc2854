"""The card-timing tools of the port with ``--device cpu`` at imgsz 64:
``tools/profile_forward_torch.py``, ``tools/profile_train_torch.py`` and
``tools/host_overhead_torch.py`` (the counterparts of ``tti``'s
``profile_forward``, ``profile_train`` and ``host_overhead``). Their tables
print and add up, ``categorize`` names the hand-written kernels and the
library kernels, ``flop_floors`` counts the forward from the model's shapes,
and the feed loop's smoothing equals ``tti``'s ``smooth_measurement``."""

import json

import numpy as np
import pytest
import torch
import torch.nn as nn

import tools.host_overhead_torch as ho
import tools.profile_forward_torch as pf
import tools.profile_train_torch as pt

SMALL = ["--imgsz", "64", "--device", "cpu", "--top", "5"]


@pytest.mark.parametrize("full", [False, True], ids=["forward", "full"])
def test_profile_forward_tables_add_up(full, capsys):
    got = pf.main(["--batch", "2", "--frame-h", "96", "--frame-w", "128", "--iters", "2",
                   *SMALL, *(["--full"] if full else [])])
    out = capsys.readouterr().out
    assert "-- top 5 ops (ms/step) --" in out and "-- by category (ms/step, device ops" in out
    assert ("full pipeline step" if full else "bare forward") in out
    assert len(got["top"]) == 5 and got["categories"]["cuDNN convolution"] > 0
    assert sum(got["categories"].values()) == pytest.approx(got["total_ms"], rel=1e-9)
    assert got["busy_ms"] == pytest.approx(got["total_ms"]) and got["busy_ms"] > 0
    assert 0.0 <= got["idle_share"] < 1.0
    if full:  # the step's kernels, through their operators' plain versions here
        assert got["categories"]["B mask stats binary"] > 0
        assert got["categories"]["D greedy NMS"] > 0
        ops = got["ops_per_step"]
        assert ops["B mask stats binary"] == ops["D greedy NMS"] == 1
    else:
        assert "D greedy NMS" not in got["ops_per_step"]


@pytest.mark.parametrize("name,category", [
    ("void stats_strips<__nv_bfloat16, true, true>(__nv_bfloat16 const*, float const*)",
     "A mask stats soft"),
    ("void stats_moments<true>(float const*, unsigned char const*, int)", "A mask stats soft"),
    ("void stats_strips<float, false, false>(float const*, float const*)",
     "B mask stats binary"),
    ("void stats_moments<false>(float const*, unsigned char const*, int)",
     "B mask stats binary"),
    ("warp_p1_kernel(CUtensorMap, Args, Plan)", "C warp pass 1"),
    ("greedy_keep_kernel(float const*, int const*, unsigned char const*)", "D greedy NMS"),
    ("void int8_conv_kernel<2>(CUtensorMap, ConvArgs, Geo)", "E int8 conv"),
    ("act_absmax_kernel(void const*, long long, long long)", "F act scale"),
    ("tti_torch::mask_stats_soft", "A mask stats soft"),
    ("tti_torch::act_scale_per_sample", "F act scale"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "cuDNN convolution"),
    ("aten::mkldnn_convolution", "cuDNN convolution"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", "cuBLAS GEMM"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS GEMM"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}", "copy"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel>",
     "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "NCCL"),
    ("void cub::DeviceRadixSortOnesweepKernel<cub::DeviceRadixSortPolicy>", "other"),
])
def test_categorize_names_the_kernels(name, category):
    assert pf.categorize(name) == category


def test_profile_train_prints_programs_beside_floors(capsys):
    got = pt.main(["--batch", "2", "--iters", "1", "--dataset-size", "4", "--max-gt", "4",
                   *SMALL])
    out = capsys.readouterr().out
    assert "-- device ms per program, beside its floor" in out
    assert "-- by category (ms/iter, device ops per iter) --" in out
    assert "-- top 5 ops (ms/iter) --" in out
    assert sum(got["categories"].values()) == pytest.approx(got["total_ms"], rel=1e-9)
    assert got["per_program_ms"]["augment"] > 0 and got["per_program_ms"]["step"] > 0
    assert got["floors"]["backward_ms"] == pytest.approx(2 * got["floors"]["forward_ms"])
    assert "989 TFLOP/s" in out and "197 TFLOP" not in out and "v5e" not in out


class _OneConv(nn.Module):
    """An NHWC model of one convolution and one transposed convolution."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3, 2, 1)
        self.up = nn.ConvTranspose2d(16, 8, 2, 2)

    def forward(self, x):
        return self.up(self.conv(x.permute(0, 3, 1, 2)))


def test_flop_floors_count_the_models_shapes():
    flops, act_bytes = pt.forward_flops(_OneConv(), 64, batch=2)
    conv = 2 * (2 * 16 * 32 * 32) * 3 * 3 * 3  # 2 per MAC: output elements x C_in x kh x kw
    up = 2 * (2 * 16 * 32 * 32) * 8 * 2 * 2  # input elements x C_out x kh x kw
    assert flops == conv + up
    assert act_bytes == 4 * ((2 * 3 * 64 * 64 + 2 * 16 * 32 * 32) + (2 * 16 * 32 * 32
                                                                      + 2 * 8 * 64 * 64))
    small, big = pt.flop_floors(1, 320), pt.flop_floors(1, 640)
    assert big["forward_gflop_per_image"] == pytest.approx(4 * small["forward_gflop_per_image"],
                                                           rel=1e-12)
    assert big["forward_ms"] == pytest.approx(big["forward_gflop_per_image"] / 989)
    assert pt.flop_floors(4, 320)["forward_ms"] == pytest.approx(4 * small["forward_ms"])


def test_host_overhead_line(capsys):
    ho.main(["--streams", "2", "--height", "96", "--width", "128", "--imgsz", "64",
             "--iters", "3", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # tti's snapshot and postproc keys, the measured H2D (none on the CPU)
    # and device step in place of tti's tabulated links and assumed step.
    for key in ("streams", "snapshot_ms", "snapshot_GBps", "batch_MB", "postproc_ms",
                "host_stages_ms", "binding_stage"):
        assert key in line, key
    assert line["batch_MB"] == pytest.approx(2 * 96 * 128 * 3 / 1e6, abs=1e-4)  # 4 places
    assert line["h2d_ms_pinned"] is None and line["device_step"] == "measured"
    assert line["device_step_ms"] > 0 and line["binding_stage"] in ("host(snapshot)", "device")
    assert not any(k.startswith(("h2d_ms_relay", "h2d_ms_pcie", "sustained_fps_"))
                   for k in line)
    ho.main(["--streams", "2", "--height", "96", "--width", "128", "--iters", "2",
             "--device", "cpu", "--device-step-ms", "1000"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device_step"] == "given" and line["binding_stage"] == "device"
    assert line["sustained_fps"] == pytest.approx(2.0)


def test_host_smoothing_equals_tti():
    """N batches of the feed loop's smoothing (``smooth_streams``) against
    ``tti``'s ``smooth_measurement`` per stream on the same readings (NaN
    frames among them): the same windows and the same medians."""
    import dataclasses

    import jax.numpy as jnp

    from tti.measure.pipeline import FrameMeasurement as JaxMeasurement
    from tti.measure.pipeline import init_measure_state as jax_init
    from tti.measure.pipeline import smooth_measurement as jax_smooth
    from tti_torch.measure.pipeline import init_measure_state

    streams, n = 3, 12
    rng = np.random.default_rng(7)
    raw = rng.uniform(2.0, 6.0, (n, 2, streams)).astype(np.float32)
    raw[rng.uniform(size=raw.shape) < 0.3] = np.nan
    states = [init_measure_state(device="cpu") for _ in range(streams)]
    ref_states = [jax_init() for _ in range(streams)]
    meas = ho.synthetic_measurements(streams, "cpu")
    for i in range(n):
        meas = dataclasses.replace(meas, raw_edge_mm=torch.from_numpy(raw[i, 0]),
                                   raw_width_mm=torch.from_numpy(raw[i, 1]))
        states, smoothed = ho.smooth_streams(states, meas)
        for s in range(streams):
            per = JaxMeasurement(jnp.float32(np.nan), jnp.float32(np.nan),
                                 jnp.float32(raw[i, 0, s]), jnp.float32(raw[i, 1, s]),
                                 jnp.int32(5), jnp.int32(5), jnp.int32(7), jnp.bool_(True))
            ref_states[s], want = jax_smooth(ref_states[s], per)
            for f in ("edge_distance_mm", "stitch_width_mm"):
                np.testing.assert_array_equal(getattr(smoothed[s], f).numpy(),
                                              np.asarray(getattr(want, f)), err_msg=f)
    for got, want in zip(states, ref_states):
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)), err_msg=f.name)
