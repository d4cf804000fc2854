"""Kernel G (``tti_torch.kernels.conv_epilogue.bias_act``): the bias and
SiLU after the float convolutions in one pass.

- CPU: the operator's plain version is ``F.silu(y + b)`` / ``y + b`` bit for
  bit in y's layout; the fake implementation's shape, dtype and strides; the
  routes of the deploy step's shapes; a model of the kernel's index walk;
  the modules' CPU route unchanged; every biased convolution reaches the
  epilogue once a forward (76 in the float deploy model, 70 with the fused
  head, 10 in the quantized and unfolded ones); the operator in a
  ``torch.export`` graph.
- ``cuda``-marked: bit-equal to cuDNN's bias add and ``F.silu`` on every
  route, every bf16 value and every epilogue of the deploy step at batch 2;
  the deploy forward bit-equal to the parent route's; 76 launches per deploy
  step, 10 per int8 step (its exit convs and deconv; kernel E carries its
  blocks' epilogue). This file imports no JAX: on the card, run
  ``python3 -m pytest tests/test_torch_conv_epilogue.py -m cuda`` with a
  stand-in ``jax`` package on ``PYTHONPATH`` (``tests/conftest.py`` imports
  it).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import tti_torch.model.layers as layers
from tti_torch.kernels import conv_epilogue as ce
from tti_torch.model.layers import Conv, Conv2d, ConvTranspose2d
from tti_torch.model.yolo import create_model

CKPT = "checkpoints/yolov8n_textile_cam.msgpack"
DEPLOY_HW, DEPLOY_IMGSZ = (960, 1280), 960
CHANNELS = (2, 16, 32, 64, 128, 160)
DTYPES = ("bfloat16", "float32")


def conv_output(shape, dtype, channels_last, seed=0, scale=4.0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=g) * scale).to(getattr(torch, dtype))
    b = (torch.randn(shape[1], generator=g) * scale).to(getattr(torch, dtype))
    return (y.contiguous(memory_format=torch.channels_last) if channels_last else y), b


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


SHAPES = [(2, c, 5, 6) for c in CHANNELS] + [(3, 5, 7, 9)]  # the last one ragged


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels_last", [True, False], ids=["cl", "nchw"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_is_add_then_silu(shape, channels_last, dtype):
    y, b = conv_output(shape, dtype, channels_last)
    for act in (True, False):
        got = ce.bias_act(y, b, act)
        want = y + b.view(1, -1, 1, 1)
        want = F.silu(want) if act else want
        assert torch.equal(bits(got), bits(want)), act
        assert got.stride() == y.stride() and got.dtype == y.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels_last", [True, False], ids=["cl", "nchw"])
def test_fake_gives_shape_dtype_strides(channels_last, dtype):
    y, b = conv_output((2, 160, 3, 5), dtype, channels_last)
    with FakeTensorMode() as mode:
        fake = ce.bias_act(mode.from_tensor(y), mode.from_tensor(b), True)
    assert (fake.shape, fake.dtype, fake.stride()) == (y.shape, y.dtype, y.stride())


def test_refuses_other_layouts_dtypes_and_devices():
    y, b = conv_output((2, 16, 4, 6), "float32", True)
    with pytest.raises(ValueError, match="contiguous or channels_last"):
        ce.bias_act(y[:, ::2], b[::2].contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.bias_act(y.half(), b.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.bias_act(y, b.bfloat16())
    with pytest.raises(ValueError, match=r"\(C,\)"):
        ce.bias_act(y, b[:8])
    with pytest.raises(ValueError, match="cpu or cuda"):
        ce.bias_act(y.to("meta"), b.to("meta"))


def deploy_epilogue_shapes(batch: int = 2, imgsz=(736, 960)) -> list:
    """(shape, act) of every epilogue of the deploy model's forward, from a
    meta-device run of the float model at ``imgsz``."""
    model = create_model("n", 2, 32, 2, "subpixel").to("meta").eval()
    shapes = []

    def hook(m, args, out):
        if isinstance(m, Conv):
            shapes.append((tuple(out.shape), m.act))
        elif isinstance(m, (Conv2d, ConvTranspose2d)) and not isinstance(parent.get(m), Conv):
            shapes.append((tuple(out.shape), False))

    parent = {child: m for m in model.modules() for child in m.children()}
    for m in model.modules():
        if isinstance(m, (Conv, Conv2d, ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty((batch, imgsz[0] // 2, imgsz[1] // 2, 12), device="meta"))
    return shapes


def test_deploy_step_has_76_epilogues_and_their_routes():
    """66 Conv blocks with SiLU, 9 exit convs and 1 deconv; channels_last
    bf16 outputs take the 16-byte channel route but for the class exit
    conv (C = 2), which wraps."""
    shapes = deploy_epilogue_shapes(batch=128)
    assert len(shapes) == 76 and sum(act for _, act in shapes) == 66
    routes = [ce.plan(s, True, 2, True).route for s, _ in shapes]
    assert routes.count(ce.WRAPPED) == 3 and routes.count(ce.CHANNELS) == 73
    elems = sum(np.prod(s) for s, _ in shapes)
    assert elems == 128 * 37_852_020  # 37.9 M activations a frame
    assert ce.plan((1, 2, 23, 30), True, 2, True).route == ce.SCALAR  # 1380 elements
    assert ce.plan((2, 32, 23, 30), False, 2, True).route == ce.SCALAR  # an odd plane
    assert ce.plan((2, 32, 46, 60), False, 2, True) == ce.Plan(ce.PLANE, 8, 2 * 32 * 46 * 60 // 8,
                                                               46 * 60)
    assert ce.plan((2, 64, 5, 6), True, 4, False).route == ce.SCALAR  # unaligned
    assert ce.blocks(10, 8, 132) == 1 and ce.blocks(10 ** 9, 8, 132) == 1056


def walk(pl: ce.Plan, c: int, grid: int, threads: int) -> np.ndarray:
    """The channel kernel G gives each element: a model of the walk in
    ``csrc/conv_epilogue.cu`` (two vectors an iteration, each thread's
    offset and channel moved by the loop's step, no division in the loop);
    -1 where no thread wrote."""
    out = np.full(pl.units * pl.vec, -1)
    stride = grid * threads
    e2 = 2 * stride * pl.vec
    step = (e2 % pl.inner, (e2 // pl.inner) % c)

    def advance(p):
        o, ch = p[0] + step[0], p[1] + step[1]
        if o >= pl.inner:
            o, ch = o - pl.inner, ch + 1
        return (o, ch - c if ch >= c else ch)

    def apply(v, p):
        for j in range(pl.vec):
            assert out[v * pl.vec + j] == -1, "written twice"
            if pl.route == ce.WRAPPED:
                out[v * pl.vec + j] = (p[1] + j) % c
            elif pl.route == ce.CHANNELS:
                out[v * pl.vec + j] = p[1] + j
            else:
                out[v * pl.vec + j] = p[1]

    locate = lambda e: (e % pl.inner, (e // pl.inner) % c)
    for t in range(stride):
        v = t
        if v >= pl.units:
            continue
        p0, p1 = locate(v * pl.vec), locate((v + stride) * pl.vec)
        while v + stride < pl.units:
            apply(v, p0)
            apply(v + stride, p1)
            p0, p1 = advance(p0), advance(p1)
            v += 2 * stride
        if v < pl.units:
            apply(v, p0)
    return out


@pytest.mark.parametrize("shape,channels_last,esize", [
    ((3, 16, 5, 7), True, 2), ((2, 160, 3, 3), True, 2), ((2, 12, 5, 5), True, 4),
    ((5, 2, 7, 8), True, 2), ((3, 5, 4, 8), True, 4), ((2, 7, 6, 8), False, 2),
    ((3, 3, 5, 7), False, 4), ((2, 5, 3, 3), True, 2)])
@pytest.mark.parametrize("grid,threads", [(1, 4), (3, 8), (2, 5), (100, 32)])
def test_walk_gives_every_element_its_channel(shape, channels_last, esize, grid, threads):
    pl = ce.plan(shape, channels_last, esize, True)
    n, c, h, w = shape
    i = np.arange(n * c * h * w)
    assert np.array_equal(walk(pl, c, grid, threads), (i // pl.inner) % c)


def parent_conv_outputs(model, x):
    """Every Conv, Conv2d and ConvTranspose2d output of ``model(x)`` beside
    the parent's formula on the same input: the convolution with its bias,
    then ``F.silu`` in a Conv block."""
    pairs = []

    def hook(m, args, out):
        inp = args[0]
        dt = inp.dtype
        if isinstance(m, Conv):
            want = F.silu(F.conv2d(inp, m.conv.weight.to(dt), m.conv.bias.to(dt), m.conv.stride,
                                   m.conv.padding))
        elif isinstance(m, Conv2d):  # a block's own conv is called with its SiLU
            want = F.conv2d(inp, m.weight.to(dt), m.bias.to(dt), m.stride, m.padding)
            want = F.silu(want) if len(args) > 2 and args[2] else want
        else:
            want = F.conv_transpose2d(inp, m.weight.to(dt), m.bias.to(dt), m.stride)
        pairs.append((out, want))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Conv2d, ConvTranspose2d))]
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    return pairs


@pytest.mark.parametrize("dtype", DTYPES)
def test_modules_on_the_cpu_are_unchanged(dtype):
    """On the CPU the convolutions take their biases and F.silu follows:
    every module's output equals that formula bit for bit."""
    torch.manual_seed(0)
    model = create_model("n", 2, 32, 2, "subpixel").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    model = model.to(getattr(torch, dtype)).to(memory_format=torch.channels_last)
    x = torch.randn(2, 32, 48, 12, generator=torch.Generator().manual_seed(1))
    pairs = parent_conv_outputs(model, x.to(getattr(torch, dtype)))
    assert len(pairs) == 66 + 66 + 9 + 1  # blocks, their Conv2d, exit convs, deconv
    for got, want in pairs:
        assert torch.equal(bits(got), bits(want.contiguous(memory_format=torch.channels_last)))


def biased_convs(model) -> int:
    """The float convolutions with a bias: kernel G's launches per forward
    on the card."""
    return sum(isinstance(m, (Conv2d, ConvTranspose2d)) and m.bias is not None
               for m in model.modules())


def test_fused_epilogue_is_not_taken_on_the_cpu_or_in_a_quantized_model():
    """Not on the CPU, and not by a quantized model's ``Conv`` blocks
    (kernel E carries their bias and SiLU): their only float convolutions
    are the exit convs and the deconv."""
    float_model = create_model("n", 2, 32, 2, "subpixel")
    q_model = create_model("n", 2, 32, 2, "subpixel", qmode="int8")
    x = torch.zeros(1, 64, 4, 4)
    assert not layers.fused_epilogue(x, float_model.m22.cv2_0_2)
    assert not any(hasattr(m, "conv") for m in q_model.modules() if isinstance(m, Conv))
    assert biased_convs(float_model) == 76 and biased_convs(q_model) == 10


@pytest.mark.parametrize("kw, want", [
    (dict(), 76), (dict(qmode="int8"), 10), (dict(qmode="int8s"), 10),
    (dict(folded_bn=False), 10), (dict(fused_head=True), 70),
    (dict(fused_head=True, qmode="int8"), 10)],
    ids=["float", "int8", "int8s", "unfolded", "fused_head", "fused_head_int8"])
def test_every_biased_conv_takes_the_epilogue_once(monkeypatch, kw, want):
    """With the route open on the CPU (as on the card), each biased float
    convolution reaches kernel G's operator once a forward and nothing
    else does; the outputs equal the CPU route's."""
    model = create_model("n", 2, 32, 2, "subpixel", **kw).eval()
    x = torch.randn(2, 32, 48, 12, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want_out = model(x)
    calls = []

    def counted(y, b, act=True):
        calls.append(act)
        return ce.bias_act(y, b, act)

    monkeypatch.setattr(layers, "fused_epilogue", lambda x, conv: conv.bias is not None)
    monkeypatch.setattr(layers, "bias_act", counted)
    with torch.inference_mode():
        got = model(x)
    assert len(calls) == biased_convs(model) == want
    assert sum(calls) == want - 10  # SiLU in every Conv block's epilogue
    for name in ("box", "cls", "mcoef"):
        for a, b in zip(getattr(got, name), getattr(want_out, name)):
            assert torch.equal(a, b), name
    assert torch.equal(got.protos, want_out.protos)


def test_the_operator_exports():
    """``torch.export`` records kernel G as the one operator
    ``tti_torch.bias_act``."""

    class Epilogue(torch.nn.Module):
        def forward(self, y, b):
            return ce.bias_act(y, b, True)

    y, b = conv_output((2, 16, 3, 4), "float32", True)
    ep = torch.export.export(Epilogue(), (y, b))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets == ["tti_torch.bias_act.default"]
    assert torch.equal(ep.module()(y, b), ce.bias_act(y, b, True))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python -m pytest tests/test_torch_conv_epilogue.py "
                    "-m cuda)")
    return torch.device("cuda")


def parent_route(y: torch.Tensor, b: torch.Tensor, act: bool) -> torch.Tensor:
    """cuDNN's bias add after the convolution, then ``F.silu``, on ``y``."""
    out = y.clone().add_(b.view(1, -1, 1, 1))
    return F.silu(out) if act else out


def assert_bit_equal(got, want, what):
    diff = (bits(got) != bits(want)).sum().item()
    assert diff == 0, f"{what}: {diff} of {got.numel()} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_route_equals_the_parent_route_on_card(cuda_device, dtype):
    dt = getattr(torch, dtype)
    cases = [(s, cl) for s in SHAPES + [(4, 64, 46, 60), (4, 2, 23, 30), (1, 2, 23, 30)]
             for cl in (True, False)]
    for shape, cl in cases:
        y, b = conv_output(shape, dtype, cl, seed=len(shape) + shape[1])
        y, b = y.to(cuda_device), b.to(cuda_device)
        for act in (True, False):
            assert_bit_equal(ce.bias_act(y, b, act), parent_route(y, b, act), (shape, cl, act))
    # An address off the 16-byte grid takes the element route.
    flat = torch.randn(2 * 16 * 5 * 6 + 1, device=cuda_device).to(dt)
    y, b = flat[1:].view(2, 16, 5, 6), torch.randn(16, device=cuda_device).to(dt)
    assert ce.plan(tuple(y.shape), False, y.element_size(), False).route == ce.SCALAR
    assert_bit_equal(ce.bias_act(y, b, True), parent_route(y, b, True), "unaligned")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_every_bf16_value_on_card(cuda_device):
    """Every bf16 pattern as the convolution's output, under biases of
    every sign and size: the sum, its rounding and SiLU bit-equal."""
    y = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda_device).to(torch.int16)
    y = y.view(torch.bfloat16).view(1, 8, 64, 128).contiguous(memory_format=torch.channels_last)
    for b in ([0.0] * 8, [1.0, -1.0, 0.5, -3.0, 1e-3, -40.0, 96.0, 1e30]):
        bias = torch.tensor(b, dtype=torch.bfloat16, device=cuda_device)
        for act in (True, False):
            assert_bit_equal(ce.bias_act(y, bias, act), parent_route(y, bias, act), (b, act))


def deploy_pipeline(device, **kw):
    from tti_torch.core.config import MeasureConfig, ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    from bench_torch import bench_calibration, bench_roi

    meta = checkpoint_metadata(CKPT)
    cfg = ModelConfig(image_size=DEPLOY_IMGSZ, dtype="bfloat16",
                      mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return InspectionPipeline(cfg, load_flax_msgpack(CKPT), DEPLOY_HW,
                              calibration=bench_calibration(DEPLOY_HW),
                              measure_cfg=MeasureConfig().with_subcell_from(meta),
                              roi=bench_roi(DEPLOY_HW), device=device, **kw)


def deploy_frames(batch: int):
    """Synthetic textile scenes, from ``tests/torch_synth.py`` loaded by its
    path (on the card a site-packages ``tests`` package shadows this one)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_synth.py")
    spec = importlib.util.spec_from_file_location("torch_synth_frames", path)
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth.textile_frames(batch, *DEPLOY_HW, seed=5)


@pytest.fixture(scope="module")
def deploy_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pipe = deploy_pipeline("cuda")
    with torch.inference_mode():
        x = pipe.preprocess(torch.from_numpy(deploy_frames(2)).to("cuda"))
    return pipe, x


@pytest.mark.cuda
def test_deploy_epilogues_equal_the_parent_route_on_card(deploy_on_card, monkeypatch):
    """Each of the deploy forward's 76 epilogues at batch 2 against cuDNN's
    bias add and F.silu on the same convolution output; then the whole
    forward against the same model with every module on the parent route."""
    pipe, x = deploy_on_card
    seen = []

    def checked(y, b, act=True):
        got = ce.bias_act(y, b, act)
        assert_bit_equal(got, parent_route(y, b, act), (tuple(y.shape), act))
        seen.append((tuple(y.shape), act))
        return got

    monkeypatch.setattr(layers, "bias_act", checked)
    with torch.inference_mode():
        got = pipe.model(x)
    monkeypatch.undo()
    assert [(s[1:], a) for s, a in seen] == [(s[1:], a) for s, a in deploy_epilogue_shapes()]
    monkeypatch.setattr(layers, "fused_epilogue", lambda x, conv: False)
    with torch.inference_mode():
        want = pipe.model(x)
    for name in ("box", "cls", "mcoef"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert_bit_equal(a, b, name)
    assert_bit_equal(got.protos, want.protos, "protos")


@pytest.mark.cuda
def test_launches_per_step_on_card(deploy_on_card):
    """76 launches per deploy step; 10 per int8 step, its exit convs and
    deconv (kernel E carries its blocks' epilogue)."""
    pipe, _ = deploy_on_card
    frames = deploy_frames(2)
    for p, want in ((pipe, 76), (deploy_pipeline("cuda", quant="int8"), 10)):
        ce.reset_launch_counts()
        p.process_batch(frames)
        assert ce.LAUNCHES["bias_act"] == want
