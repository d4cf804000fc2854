"""The six kernel operators of ``tti_torch.kernels`` (``torch.ops.tti_torch.*``):
``torch.library.opcheck`` on CPU inputs (schema, fake implementation against
the CPU one, the dispatcher's traces), and the fake outputs' shapes, dtypes
and strides held to the CPU implementation's, kernel E's channels_last
output and F's (B,) scale among them. On the CPU each operator runs its
kernel's plain version; the wrappers call the operators."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tti_torch.kernels.int8conv as ik
import tti_torch.kernels.maskstats as ms
import tti_torch.kernels.nms as knms
import tti_torch.kernels.warp_p1 as wp

OPS = torch.ops.tti_torch


def _mask_args(logits_dtype):
    rng = np.random.default_rng(1)
    b, d, hm, wm, nm = 2, 5, 12, 40, 32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    protos = t(rng.normal(size=(b, hm, wm, nm)).astype(np.float32))
    coefs = t(rng.normal(size=(b, d, nm)).astype(np.float32))
    lo = rng.uniform(0, 8, size=(b, d, 2))
    boxes = t(np.concatenate([lo[..., :1], lo[..., 1:], lo[..., :1] + rng.uniform(2, 30, (b, d, 1)),
                              lo[..., 1:] + rng.uniform(2, 6, (b, d, 1))], -1).astype(np.float32))
    valid = t(rng.uniform(size=(b, d)) < 0.8)
    return (protos, coefs, boxes, valid, logits_dtype)


def _warp_args():
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 255, size=(2, 30, 60, 3), dtype=np.uint8))
    w1 = torch.from_numpy(rng.uniform(size=(10, 20, 8)).astype(np.float32))
    return (frames, w1, wp.pass1_window(w1), 3, 1, 10, 20, 114.0 / 255.0, True)


def _nms_args():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, size=(2, 16, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 20, size=(2, 16, 2))],
                                            -1).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 2, size=(2, 16)).astype(np.int32))
    return (boxes, classes, torch.from_numpy(rng.uniform(size=(2, 16)) < 0.9), 0.3, True)


def _conv_args(dtype, channels_last, hw=(9, 11), stride=2, xscale_per_sample=True):
    g = torch.Generator().manual_seed(4)
    b, ci, co, k = 2, 16, 32, 3
    x = torch.randn((b, ci, *hw), generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    qw = ik.pack_qweight(torch.randint(-127, 128, (co, k, k, ci), generator=g, dtype=torch.int8))
    wscale = torch.rand(co, generator=g) / 100
    bias = torch.randn(co, generator=g)
    xscale = (ik.act_scale_per_sample_plain(x) if xscale_per_sample
              else torch.tensor(0.02, dtype=torch.float32))
    return (x, qw, wscale, bias, xscale, k, stride, 1, True)


def _scale_args(dtype, channels_last):
    x = torch.randn((3, 16, 7, 5), generator=torch.Generator().manual_seed(5)).to(dtype)
    return (x.contiguous(memory_format=torch.channels_last) if channels_last else x,)


CASES = {
    "mask_stats_soft": (OPS.mask_stats_soft.default, lambda: _mask_args(torch.bfloat16)),
    "mask_stats_soft_f32": (OPS.mask_stats_soft.default, lambda: _mask_args(torch.float32)),
    "mask_stats_binary": (OPS.mask_stats_binary.default, lambda: _mask_args(torch.float32)),
    "warp_pass1_decimated": (OPS.warp_pass1_decimated.default, _warp_args),
    "greedy_keep": (OPS.greedy_keep.default, _nms_args),
    "int8_conv2d": (OPS.int8_conv2d.default, lambda: _conv_args(torch.float32, True)),
    "int8_conv2d_nchw_bf16": (OPS.int8_conv2d.default, lambda: _conv_args(torch.bfloat16, False)),
    "int8_conv2d_1x1_out_static": (OPS.int8_conv2d.default, lambda: _conv_args(
        torch.float32, True, hw=(3, 3), stride=2, xscale_per_sample=False)),
    "act_scale_per_sample": (OPS.act_scale_per_sample.default,
                             lambda: _scale_args(torch.float32, False)),
    "act_scale_per_sample_cl_bf16": (OPS.act_scale_per_sample.default,
                                     lambda: _scale_args(torch.bfloat16, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    op, make = CASES[case]
    torch.library.opcheck(op, make())


def _meta(t):
    return (tuple(t.shape), t.dtype, t.stride(), t.device)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_matches_cpu_outputs(case):
    """The fake implementation gives the CPU implementation's shapes, dtypes
    and strides, touching no data."""
    op, make = CASES[case]
    args = make()
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [_meta(t) for t in fake] == [_meta(t) for t in real]


@pytest.mark.parametrize("shape", [(2, 16, 9, 11), (2, 16, 3, 3), (1, 16, 2, 2)])
def test_int8_conv2d_output_is_channels_last(shape):
    """E's output as the card's launch makes it: ``torch.empty(...,
    channels_last)``'s strides, size-1 axes included, on the CPU too."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    args = _conv_args(torch.float32, True)[1:]
    out = ik.int8_conv2d(x, *args[:3], ik.act_scale_per_sample(x), *args[4:])
    want = torch.empty(out.shape, memory_format=torch.channels_last).stride()
    assert out.stride() == want and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, ik.int8_conv2d_plain(x, *args[:3], ik.act_scale_per_sample(x),
                                                 *args[4:]))


def test_act_scale_is_one_float_per_sample():
    (x,) = _scale_args(torch.bfloat16, True)
    s = ik.act_scale_per_sample(x)
    assert s.shape == (3,) and s.dtype == torch.float32
    assert torch.equal(s, ik.act_scale_per_sample_plain(x))


def test_wrappers_call_the_operators(monkeypatch):
    """Each public function reaches its operator (one route): a stand-in
    operator sees every call."""
    seen = []

    def spy(module, attr):
        op = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a: seen.append(attr) or op(*a))

    spy(knms, "_OP")
    spy(wp, "_OP")
    spy(ik, "_CONV_OP")
    spy(ik, "_SCALE_OP")
    monkeypatch.setitem(ms._OPS, True, (lambda op: lambda *a: seen.append("soft") or op(*a))(
        ms._OPS[True]))
    monkeypatch.setitem(ms._OPS, False, (lambda op: lambda *a: seen.append("binary") or op(*a))(
        ms._OPS[False]))
    knms.greedy_keep(*_nms_args())
    frames, w1, window, k, off, hs, ws, pad, flip = _warp_args()
    wp.warp_pass1_decimated(frames, w1, window, k=k, off=off, hs=hs, ws=ws, pad_value=pad)
    ik.int8_conv2d(*_conv_args(torch.float32, True))
    ik.act_scale_per_sample(*_scale_args(torch.float32, False))
    ms.mask_stats_soft(*_mask_args(torch.bfloat16))
    ms.mask_stats_binary(*_mask_args(torch.float32))
    assert seen == ["_OP", "_OP", "_CONV_OP", "_SCALE_OP", "soft", "binary"]


def test_mask_stats_dict_is_rebuilt_from_the_operator():
    args = _mask_args(torch.bfloat16)
    got = ms.mask_stats_soft(*args)
    ref = ms.mask_stats_soft_plain(*args)
    assert list(got) == [*ms.MOMENTS["mask_stats_soft"], *ms.COLUMN_FIELDS["mask_stats_soft"]]
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


def test_other_devices_are_refused_before_the_dispatcher():
    with pytest.raises(ValueError, match="cpu or cuda"):
        ik.act_scale_per_sample(torch.zeros((1, 16, 2, 2), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ik.int8_conv2d(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                         for a in _conv_args(torch.float32, True)))
    with pytest.raises(ValueError, match="logits_dtype"):
        ms.mask_stats_soft(*_mask_args(torch.float16))
