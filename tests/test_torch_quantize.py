"""int8 inference (W8A8) of the port against tti on the CPU, float32, with
``jax_default_matmul_precision="highest"`` (tests/conftest.py).

- The weight transform (``quantize_conv_kernel``, ``quantize_weights``,
  ``skip`` and ``act_scales`` included) is tti's bit for bit on both
  deploy checkpoints, and raises tti's errors.
- The quantized ``Conv`` block's plain path (kernels E and F's plain
  versions) against tti's ``Conv.apply`` within 1e-5 at k 1/2/3, s 1/2,
  pad 0/1, ci 3/12/16/48, and on a strided channel slice. Both take
  SiLU as x * sigmoid(x); they differ only where XLA's exp and PyTorch's
  differ in the last bit; the codes, the integer accumulators and the
  epilogue are equal.
- The plain versions' pieces: F's scale, the codes and the accumulators
  (above 2^24 too) against tti's and an int64 product.
- A quantized tree round-trips through the state dict exactly, and a float
  export is unchanged.
- ``RuntimeSwitches`` reads ``TTI_QUANT`` / ``TTI_QUANT_SCALES``; the
  invalid combinations raise tti's errors; ``run`` and ``eval`` serve int8.
- ``cuda``-marked: kernels E and F against their plain versions on the card.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tti_torch.core.config as tcfg
from tti.model.convert import fold_batchnorm as tti_fold, stem_to_s2d as tti_s2d
from tti.model.layers import Conv as TtiConv, quantize_act_per_sample
from tti.model.quantize import quantize_conv_kernel as tti_qkernel
from tti.model.quantize import quantize_weights as tti_qweights
from tti_torch.core.errors import ConfigError
from tti_torch.kernels import int8conv as ik
from tti_torch.model import checkpoint as ck
from tti_torch.model.layers import Conv
from tti_torch.model.quantize import quantize_conv_kernel, quantize_weights

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = ("yolov8n_textile_cam", "yolov8n_textile")


def _trees(name):
    """(tti's tree, the port's tree) of a checkpoint, each package's loader."""
    path = f"checkpoints/{name}.msgpack"
    with open(path, "rb") as f:
        flax_tree = serialization.msgpack_restore(f.read())
    return flax_tree, ck.load_flax_msgpack(path)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
            continue
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (f"{path}/{key}", a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{path}/{key}")


def _count(tree, leaf="qkernel"):
    return sum(_count(v, leaf) for v in tree.values() if isinstance(v, dict)) + (leaf in tree)


@pytest.mark.parametrize("name", CKPTS)
def test_quantize_weights_bit_equal_to_tti(name):
    """Both checkpoints, as the step quantizes them (s2d stem, folded BN):
    66 blocks, every leaf equal in value and dtype; with ``skip`` and with
    ``act_scales`` too."""
    ref_tree, tree = _trees(name)
    ref_folded, folded = tti_fold(tti_s2d(ref_tree)), ck.fold_batchnorm(ck.stem_to_s2d(tree))
    got = quantize_weights(folded)
    _assert_trees_equal(got, tti_qweights(ref_folded))
    assert _count(got["params"]) == 66
    _assert_trees_equal(quantize_weights(folded, skip=("m22/proto", "m2")),
                        tti_qweights(ref_folded, skip=("m22/proto", "m2")))
    paths = []

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                if "qkernel" in val:
                    paths.append("/".join(path + (key,)))
                walk(val, path + (key,))

    walk(got["params"], ())
    scales = {p: 0.001 * (i + 1) for i, p in enumerate(paths)}
    with_scales = quantize_weights(folded, act_scales=scales)
    _assert_trees_equal(with_scales, tti_qweights(ref_folded, act_scales=scales))
    assert _count(with_scales["params"], "ascale") == 66


def test_quantize_conv_kernel_bit_equal_to_tti():
    """Random kernels, a zero output channel (the 1e-12 floor) and codes at
    .5 (half to even)."""
    rng = np.random.default_rng(1)
    k = (rng.normal(size=(3, 3, 16, 8)) * 0.3).astype(np.float32)
    k[..., 3] = 0.0
    k[..., 5] = 0.0
    k[0, 0, :4, 5] = [127.0, 2.5, -3.5, 0.5]  # scale 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    got, want = quantize_conv_kernel(k), tti_qkernel(k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got[0][0, 0, :4, 5]) == [127, 2, -4, 0]


def test_quantize_errors_as_tti():
    ref_tree, tree = _trees("yolov8n_textile")
    for port, ref in ((lambda: quantize_weights(ck.stem_to_s2d(tree)),
                       lambda: tti_qweights(tti_s2d(ref_tree))),
                      (lambda: quantize_weights({"conv": {}}), lambda: tti_qweights({"conv": {}}))):
        with pytest.raises(ValueError) as got:
            port()
        with pytest.raises(ValueError) as want:
            ref()
        assert str(got.value) == str(want.value)
    folded, ref_folded = ck.fold_batchnorm(tree), tti_fold(ref_tree)
    scales = {"m0": 1.0}
    with pytest.raises(ValueError, match="missing calibrated block") as got:
        quantize_weights(folded, act_scales=scales)
    with pytest.raises(ValueError) as want:
        tti_qweights(ref_folded, act_scales=scales)
    assert str(got.value) == str(want.value)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _blocks(c1, c2, k, s, pad, qmode, x, rng):
    """The port's and tti's quantized block with the same random weights."""
    kernel = (rng.normal(size=(k, k, c1, c2)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(c2,)).astype(np.float32)
    kq, ws = tti_qkernel(kernel)
    params = {"qkernel": kq, "qscale": ws, "bias": bias}
    state = {"qweight": torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 0, 1, 2))),
             "qscale": torch.from_numpy(ws), "bias": torch.from_numpy(bias)}
    if qmode == "int8s":
        params["ascale"] = np.float32(np.abs(x).max() / 100.0)  # clips the largest values
        state["ascale"] = torch.tensor(params["ascale"])
    port = Conv(c1, c2, k, s, pad=pad, qmode=qmode)
    port.load_state_dict(state)
    ref = TtiConv(c2, k, s, dtype=jnp.float32, folded=True, qmode=qmode, pad=pad)
    return port, lambda inp: np.asarray(ref.apply({"params": params}, inp, train=False))


@pytest.mark.parametrize("qmode", ["int8", "int8s"])
@pytest.mark.parametrize("c1,c2,k,s,pad", [
    (3, 16, 3, 2, 1),    # the plain stem eval serves
    (12, 16, 2, 1, 0),   # the s2d stem (the caller pre-pads)
    (16, 32, 3, 2, 1),
    (16, 16, 3, 1, 1),
    (48, 32, 1, 1, 0),
    (16, 24, 3, 1, 0),
    (48, 16, 1, 2, 1),
], ids=["stem_ci3", "s2d_ci12", "k3s2_ci16", "k3s1_ci16", "k1_ci48", "k3_pad0", "k1s2_pad1"])
def test_quantized_conv_matches_tti(c1, c2, k, s, pad, qmode):
    rng = np.random.default_rng(c1 * 100 + k * 10 + s)
    x = (rng.normal(size=(2, 13, 17, c1)) * 3.0).astype(np.float32)
    port, ref = _blocks(c1, c2, k, s, pad, qmode, x, rng)
    got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    want = ref(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qmode", ["int8", "int8s"])
def test_quantized_conv_on_a_channel_slice(qmode):
    """A C2f bottleneck's input: channels 16-31 of a channels_last tensor,
    read in place; the other channels (large) do not enter the scale."""
    rng = np.random.default_rng(5)
    full = (rng.normal(size=(2, 11, 14, 48)) * 2.0).astype(np.float32)
    full[..., :16] *= 1000.0
    x = np.ascontiguousarray(full[..., 16:32])
    port, ref = _blocks(16, 16, 3, 1, 1, qmode, x, rng)
    sl = _nchw(full)[:, 16:32]
    assert sl.stride(1) == 1 and not sl.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(port(sl).permute(0, 2, 3, 1).numpy(), ref(x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ik.act_scale_per_sample(sl).numpy(),
                                  np.asarray(quantize_act_per_sample(x)[1]).reshape(-1))


def test_scale_on_the_deploy_inputs_against_tti_jit():
    """Kernel F's plain version (the CPU route of ``act_scale_per_sample``)
    on every distinct input layout of the deploy int8 forward at batch 2, in
    place (channel slices and padded stem included), bit-equal to ``tti``'s
    jitted ``quantize_act_per_sample`` scale on the same values (NHWC)."""
    from tests.test_torch_int8_plan import block_inputs

    rng = np.random.default_rng(13)
    jitted = jax.jit(lambda v: quantize_act_per_sample(v)[1])
    layouts = {(shape, strides, offset) for _, shape, strides, offset, *_ in
               block_inputs("deploy")}
    for shape, strides, offset in sorted(layouts):
        flat = (rng.normal(size=2 * strides[0] + offset // 2) * 3.0).astype(np.float32)
        x = torch.as_strided(torch.from_numpy(flat), (2, *shape[1:]), strides, offset // 2)
        want = jitted(np.ascontiguousarray(x.permute(0, 2, 3, 1).numpy()))
        np.testing.assert_array_equal(ik.act_scale_per_sample(x).numpy(),
                                      np.asarray(want).reshape(-1), err_msg=str(shape))


def test_plain_pieces_against_tti_and_int64():
    """F's scale and the codes equal tti's ``quantize_act_per_sample``
    (zeros give the 1e-12 floor); the accumulators equal an int64 product,
    above 2^24 too; ``pack_qweight`` is (co, Kp), K in (kh, kw, ci) order,
    zero-padded to a multiple of 32."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 9, 10, 12)) * 4.0).astype(np.float32)
    x[2] = 0.0
    q_ref, s_ref = quantize_act_per_sample(x)
    scale = ik.act_scale_per_sample(_nchw(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(s_ref).reshape(-1))
    assert scale[2] == np.float32(1e-12) / np.float32(127.0)
    codes = ik.quantize_act_plain(_nchw(x), scale)
    np.testing.assert_array_equal(codes.permute(0, 2, 3, 1).numpy(), np.asarray(q_ref))

    qw = rng.integers(100, 128, size=(8, 3, 3, 256)).astype(np.int8)
    packed = ik.pack_qweight(torch.from_numpy(qw))
    assert packed.shape == (8, 2304) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), qw.reshape(8, -1))
    odd = ik.pack_qweight(torch.from_numpy(qw[:, :, :, :3]))
    assert odd.shape == (8, 32) and not odd[:, 27:].any()
    q = torch.full((1, 256, 5, 6), 127.0)
    q[0, :, 2, 3] = 126.0
    acc = ik.int8_accumulate_plain(q, packed, 3, 1, 1)
    xi = np.pad(q.numpy().astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((1, 8, 5, 6), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("bchw,oc->bohw", xi[:, :, dy:dy + 5, dx:dx + 6],
                              qw[:, dy, dx, :].astype(np.int64))
    assert want.max() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)


def test_quantized_state_dict_round_trip():
    """quantize_weights -> from_flax_variables -> the int8s model -> its
    state dict -> to_flax_variables gives the same tree (int8 stays int8,
    the 0-d ascale stays 0-d); a float model's export is float32 as before."""
    _, tree = _trees("yolov8n_textile_cam")
    folded = ck.fold_batchnorm(ck.stem_to_s2d(tree))
    paths = []

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                if "conv" in val:
                    paths.append("/".join(path + (key,)))
                walk(val, path + (key,))

    walk(folded["params"], ())
    q = quantize_weights(folded, act_scales={p: 0.01 for p in paths})
    state = ck.from_flax_variables(q)
    assert state["m1.qweight"].dtype == np.int8 and state["m1.ascale"].shape == ()
    from tti_torch.model.yolo import create_model

    model = create_model("n", mask_stride=2, proto_head="subpixel", qmode="int8s")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    assert model.m1.qpacked.shape == (32, 160)  # K = 3*3*16 = 144, padded to 160
    _assert_trees_equal(ck.to_flax_variables(model.state_dict()), q)
    fstate = ck.from_flax_variables(folded)
    assert all(v.dtype == np.float32 for v in fstate.values())
    _assert_trees_equal(ck.to_flax_variables({n: torch.from_numpy(a) for n, a in fstate.items()}),
                        folded)


def test_runtime_switches_read_quant(tmp_path):
    env = {"TTI_QUANT": "int8s", "TTI_QUANT_SCALES": str(tmp_path / "s.json")}
    sw = tcfg.RuntimeSwitches.from_env(env)
    assert sw.quant == "int8s" and sw.quant_scales == env["TTI_QUANT_SCALES"]
    kw = sw.pipeline_kwargs()
    assert kw["quant"] == "int8s" and kw["quant_scales"] == env["TTI_QUANT_SCALES"]
    (tmp_path / ".env").write_text("TTI_QUANT=int8\n")
    assert tcfg.load_config(dotenv_path=str(tmp_path / ".env"), env={},
                            validate=False).switches.quant == "int8"
    assert tcfg.RuntimeSwitches.from_env({"TTI_QUANT_SCALES": ""}).quant_scales is None


def _small_pipeline(**kw):
    from tti_torch.parallel.runtime import InspectionPipeline

    _, tree = _trees("yolov8n_textile")
    return InspectionPipeline(tcfg.ModelConfig(image_size=64, dtype="float32"), tree, (48, 64),
                              device="cpu", **kw)


@pytest.mark.parametrize("kw,said", [
    (dict(quant="int4"), "TTI_QUANT must be '', 'int8' or 'int8s', got 'int4'"),
    (dict(quant="int8", fold_bn=False), "TTI_QUANT=int8 requires folded BN (TTI_FOLDED_BN=1)"),
    (dict(quant="int8s", fused_head=True), "TTI_QUANT=int8s + TTI_FUSED_HEAD=1 is unsupported"),
    (dict(quant="int8s"), "TTI_QUANT=int8s needs TTI_QUANT_SCALES"),
    (dict(quant="int8s", quant_scales="no/such.json"), "TTI_QUANT=int8s needs TTI_QUANT_SCALES"),
], ids=["other_value", "unfolded", "fused_head", "no_scales", "missing_file"])
def test_invalid_quant_raises_tti_errors(kw, said):
    with pytest.raises(ConfigError) as e:
        _small_pipeline(**kw)
    assert said in str(e.value)


def test_quantized_step_on_the_cpu_runs_the_plain_versions(tmp_path):
    """The int8 and int8s steps on the CPU: 66 quantized blocks, no kernel
    launch, a stem scale file written on the plain-stem model (``m0``) is
    served by the s2d stem (``m0s2d``)."""
    import json

    from tti_torch.model.layers import Conv as PortConv

    ik.reset_launch_counts()
    frames = np.random.default_rng(0).integers(0, 255, size=(1, 48, 64, 3), dtype=np.uint8)
    pipe = _small_pipeline(quant="int8")
    assert sum(isinstance(m, PortConv) and m.qmode == "int8" for m in pipe.model.modules()) == 66
    assert pipe.model.m1.qscale.dtype == torch.float32
    out = pipe.process_batch(frames)
    assert np.isfinite(out.scores).all()
    paths = [n.replace(".", "/") for n, m in pipe.model.named_modules()
             if isinstance(m, PortConv)]
    scales = {("m0" if p == "m0s2d" else p): 0.02 for p in paths}
    (tmp_path / "s.json").write_text(json.dumps({"scales": scales}))
    pipe_s = _small_pipeline(quant="int8s", quant_scales=str(tmp_path / "s.json"))
    assert float(pipe_s.model.m0s2d.ascale) == pytest.approx(0.02)
    assert np.isfinite(pipe_s.process_batch(frames).scores).all()
    assert ik.LAUNCHES == {"int8_conv2d": 0, "act_scale_per_sample": 0}


def test_eval_serves_int8_with_the_plain_stem(tmp_path, monkeypatch, capsys):
    """``eval`` under TTI_QUANT=int8 (as tti's: the plain k3/s2 stem, ci 3,
    folded and quantized) runs, says so and prints its metrics."""
    cv2 = pytest.importorskip("cv2")
    from tests.torch_scenes import textile_scene
    from tti_torch.app import predict
    from tti_torch.cli.__main__ import main as port_main

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img, polys, classes = textile_scene(64, rng)
        cv2.imwrite(str(images / f"s_{i}.png"), img[..., ::-1])
        (images / f"s_{i}.txt").write_text("".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel()) + "\n"
            for p, c in zip(polys, classes)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TTI_QUANT", "int8")
    built = []
    real = predict.Predictor

    def spy(*args, **kw):
        built.append(real(*args, **kw))
        return built[-1]

    monkeypatch.setattr(predict, "Predictor", spy)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger("tti_torch.cli").addHandler(handler)
    try:
        rc = port_main(["eval", "--images", str(images), "--imgsz", "64", "--weights",
                        os.path.join(REPO, "checkpoints", "yolov8n_textile.msgpack"),
                        "--device", "cpu"])
    finally:
        logging.getLogger("tti_torch.cli").removeHandler(handler)
    assert rc == 0
    assert "evaluating with TTI_QUANT=int8 (W8A8 PTQ)" in records
    model = built[0].model
    assert hasattr(model, "m0") and not hasattr(model, "m0s2d") and model.m0.qmode == "int8"
    assert "box:" in capsys.readouterr().out


@pytest.mark.parametrize("config", ["deploy", "headline"])
def test_kernel_e_routes_every_block(config):
    """Kernel E's route for each of the 66 blocks at the main path's layouts
    (bf16, channels_last, the C2f slices in place): the s2d stem (24-byte
    pixels) the ``cp.async`` ring, the other 65 TMA, each with a tile and
    ring that fit shared memory and a grid no larger than its tiles; the
    plain stem ``eval`` serves and an input 8 bytes off alignment take the
    ring too."""
    from tests.test_torch_int8_plan import block_inputs, plan_block

    routes = {}
    for name, shape, strides, offset, co, k, s, p in block_inputs(config):
        pl = plan_block(shape, strides, offset, co, k, s, p)
        assert pl.smem + ik.SMEM_SLACK <= ik.SMEM_LIMIT and 1 <= pl.grid <= pl.items
        routes[name] = pl.route
    assert len(routes) == 66
    assert [n for n, r in routes.items() if r != ik.ROUTE_TMA] == ["m0s2d"]
    (_, shape, strides, offset, co, k, s, p), *_ = block_inputs(config, plain_stem=True)
    assert plan_block(shape, strides, offset, co, k, s, p).route == ik.ROUTE_RING
    assert ik.input_route(64, 2, (64 * 20 * 24, 1, 64 * 24, 64), 8) == (ik.ROUTE_RING, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels E and F run on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    """E bit-equal to its plain version before SiLU and within 1 ulp after,
    F bit-equal, on a 3x3 block and a channel slice."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    full = (torch.randn(2, 48, 20, 24, generator=g) * 3).to(dt).to(cuda_device).contiguous(
        memory_format=torch.channels_last)
    qw = torch.randint(-127, 128, (32, 3, 3, 16), generator=g).to(torch.int8)
    qp = ik.pack_qweight(qw).to(cuda_device)
    ws = (torch.rand(32, generator=g) * 0.01 + 1e-3).to(cuda_device)
    b = torch.randn(32, generator=g).to(cuda_device)
    for x in (full[:, :16].contiguous(memory_format=torch.channels_last), full[:, 16:32]):
        s = ik.act_scale_per_sample(x)
        assert torch.equal(s, ik.act_scale_per_sample_plain(x))
        args = (x, qp, ws, b, s, 3, 1, 1)
        assert torch.equal(ik.int8_conv2d(*args, act=False),
                           ik.int8_conv2d_plain(*args, act=False))
        got, want = ik.int8_conv2d(*args), ik.int8_conv2d_plain(*args)
        torch.testing.assert_close(got, want, rtol=2 ** -7 if dtype == "bfloat16" else 2e-7,
                                   atol=0)
