"""YOLOv8-seg as an ``nn.Module`` (port of ``tti.model.yolo``).

The public boundary is NHWC like the reference: the input is (B, H, W, 3),
or (B, H/2, W/2, 12) already space-to-depth blocked when ``s2d_input``, and
every field of :class:`RawPredictions` is NHWC. Inside, the network runs
NCHW tensors in channels_last memory, which is cuDNN's fast layout; the
NHWC outputs are then views, not copies.

Two forms: the inference form the runtime serves (folded BatchNorm and the
exact space-to-depth stem ``m0s2d``, the defaults) and the training form
(``folded_bn=False``: BatchNorm with running statistics; ``s2d_stem=False``:
the plain k3/s2 stem ``m0``). :func:`init_model` gives the training form
flax's fresh initialisation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tti_torch.core.logging import span
from tti_torch.model.layers import C2f, Conv, Conv2d, Proto, SPPF, make_divisible

SCALES: dict[str, tuple[float, float, int]] = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.0, 512),
    "x": (1.0, 1.25, 512),
}

STRIDES = (8, 16, 32)
REG_MAX = 16  # DFL bins per box side
BLOCK_SPANS = {name: f"forward.{name}" for name in (
    "m0", "m0s2d", "m1", "m2", "m3", "m4", "m5", "m6", "m7", "m8", "m9", "m12", "m15", "m16",
    "m18", "m19", "m21", "m22")}  # YOLOv8Seg's top-level blocks


def model_channels(variant: str) -> dict[str, int]:
    """Resolved channel counts for a variant."""
    d, w, maxc = SCALES[variant]
    ch = {c: make_divisible(min(c, maxc) * w, 8) for c in (64, 128, 256, 512, 1024)}
    return {
        "p3": ch[256],
        "p4": ch[512],
        "p5": ch[1024],
        "npr": make_divisible(256 * w, 8),
        "depth3": max(round(3 * d), 1),
        "depth6": max(round(6 * d), 1),
        **{f"c{c}": ch[c] for c in (64, 128, 256, 512, 1024)},
    }


@dataclass
class RawPredictions:
    """Per-level raw head outputs, NHWC.

    box:   3 x (B, Hl, Wl, 4*REG_MAX)  DFL distribution logits
    cls:   3 x (B, Hl, Wl, nc)         class logits
    mcoef: 3 x (B, Hl, Wl, nm)         mask coefficients
    protos:    (B, H/ms, W/ms, nm)     mask prototypes (ms = mask stride)
    """

    box: tuple[torch.Tensor, ...]
    cls: tuple[torch.Tensor, ...]
    mcoef: tuple[torch.Tensor, ...]
    protos: torch.Tensor


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Segment(nn.Module):
    """Decoupled Detect + mask-coefficient branches + shared Proto (m22).

    ``fused_entry``: the three branches' first 3x3 convs, which read the
    same level map, run as one conv ``cvh_{level}`` with their output
    channels stacked (weights from
    :func:`tti_torch.model.checkpoint.fuse_head_entries`), whose output is
    sliced into the box, class and coefficient groups. Exact. ``qmode``
    quantizes every ``Conv`` block; the exit 1x1 convs ``*_{level}_2`` and
    the proto head's upsamples stay float, as in the reference. With
    ``space`` (see :class:`tti_torch.model.layers.Conv`) a level's three
    entry convs share one halo exchange."""

    space = None

    def __init__(self, nc: int = 2, nm: int = 32, npr: int = 64,
                 ch: tuple[int, int, int] = (64, 128, 256), mask_stride: int = 4,
                 proto_head: str = "deconv", folded: bool = True,
                 fused_entry: bool = False, qmode: str = "") -> None:
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.split = (c2, c3, c4)
        self.fused_entry = fused_entry
        q = dict(folded=folded, qmode=qmode)
        self.proto = Proto(ch[0], npr, nm, ups={4: 1, 2: 2}[mask_stride],
                           subpixel=proto_head == "subpixel", **q)
        for level, c in enumerate(ch):
            if fused_entry:
                setattr(self, f"cvh_{level}", Conv(c, c2 + c3 + c4, 3, **q))
            for name, width, out in (("cv2", c2, 4 * REG_MAX), ("cv3", c3, nc), ("cv4", c4, nm)):
                if not fused_entry:
                    setattr(self, f"{name}_{level}_0", Conv(c, width, 3, **q))
                setattr(self, f"{name}_{level}_1", Conv(width, width, 3, **q))
                setattr(self, f"{name}_{level}_2", Conv2d(width, out, 1))

    def _branch(self, name: str, level: int, x: torch.Tensor) -> torch.Tensor:
        for j in (1, 2):
            x = getattr(self, f"{name}_{level}_{j}")(x)
        return _nhwc(x)

    def forward(self, feats: tuple[torch.Tensor, ...]) -> RawPredictions:
        box, cls, coef = [], [], []
        for level, x in enumerate(feats):
            if self.fused_entry:  # channel slices of one conv (strided views)
                entries = getattr(self, f"cvh_{level}")(x).split(self.split, dim=1)
            else:
                convs = [getattr(self, f"{name}_{level}_0") for name in ("cv2", "cv3", "cv4")]
                xh = (None if self.space is None
                      else self.space.halo(x, *convs[0].halo_rows(), wpad=convs[0].p))
                entries = [conv(x, xh) for conv in convs]
            box.append(self._branch("cv2", level, entries[0]))
            cls.append(self._branch("cv3", level, entries[1]))
            coef.append(self._branch("cv4", level, entries[2]))
        return RawPredictions(box=tuple(box), cls=tuple(cls), mcoef=tuple(coef),
                              protos=_nhwc(self.proto(feats[0])))


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H/2, W/2, 4C), channel order (a, b, c) for
    spatial phase (a, b)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`space_to_depth2`: (B, H/2, W/2, 4C) ->
    (B, H, W, C), a pure permutation."""
    b, h2, w2, c4 = x.shape
    x = x.reshape(b, h2, w2, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 * 2, w2 * 2, c4 // 4)


class YOLOv8Seg(nn.Module):
    """Backbone + PAN neck + Segment head.

    ``s2d_stem``: the exact space-to-depth stem ``m0s2d`` (inference);
    otherwise the k3/s2 stem ``m0`` on (B, H, W, 3) (training).
    ``s2d_input``: with the s2d stem, the input is already (B, H/2, W/2, 12)
    blocked (the two-pass warp emits it that way); otherwise the model blocks
    it. ``folded_bn``: folded BatchNorm (inference) or BatchNorm with running
    statistics (training). ``fused_head``: :class:`Segment`'s fused entry
    convs. ``dtype``: the compute dtype the input is cast to
    (None: the parameters' dtype). ``qmode``: "" (float) | "int8" | "int8s",
    the W8A8 ``Conv`` blocks of :mod:`tti_torch.model.quantize` (folded BN
    only). ``space`` (see :class:`tti_torch.model.layers.Conv`): the input
    is this rank's slab of rows, and the s2d stem's top padding row comes
    from the slab above.
    """

    space = None

    def __init__(self, variant: str = "n", nc: int = 2, nm: int = 32,
                 mask_stride: int = 4, proto_head: str = "deconv",
                 s2d_input: bool = True, s2d_stem: bool = True, folded_bn: bool = True,
                 dtype: torch.dtype | None = None, fused_head: bool = False,
                 qmode: str = "") -> None:
        super().__init__()
        cc = model_channels(variant)
        n3, n6 = cc["depth3"], cc["depth6"]
        q = dict(folded=folded_bn, qmode=qmode)
        self.s2d_stem = s2d_stem
        self.s2d_input = s2d_input and s2d_stem
        self.dtype = dtype
        if s2d_stem:
            self.m0s2d = Conv(12, cc["c64"], 2, 1, pad=0, **q)
        else:
            self.m0 = Conv(3, cc["c64"], 3, 2, **q)
        self.m1 = Conv(cc["c64"], cc["c128"], 3, 2, **q)
        self.m2 = C2f(cc["c128"], cc["c128"], n3, True, **q)
        self.m3 = Conv(cc["c128"], cc["c256"], 3, 2, **q)
        self.m4 = C2f(cc["c256"], cc["c256"], n6, True, **q)
        self.m5 = Conv(cc["c256"], cc["c512"], 3, 2, **q)
        self.m6 = C2f(cc["c512"], cc["c512"], n6, True, **q)
        self.m7 = Conv(cc["c512"], cc["c1024"], 3, 2, **q)
        self.m8 = C2f(cc["c1024"], cc["c1024"], n3, True, **q)
        self.m9 = SPPF(cc["c1024"], cc["c1024"], 5, **q)
        self.m12 = C2f(cc["c1024"] + cc["c512"], cc["c512"], n3, False, **q)
        self.m15 = C2f(cc["c512"] + cc["c256"], cc["c256"], n3, False, **q)
        self.m16 = Conv(cc["c256"], cc["c256"], 3, 2, **q)
        self.m18 = C2f(cc["c256"] + cc["c512"], cc["c512"], n3, False, **q)
        self.m19 = Conv(cc["c512"], cc["c512"], 3, 2, **q)
        self.m21 = C2f(cc["c512"] + cc["c1024"], cc["c1024"], n3, False, **q)
        self.m22 = Segment(nc, nm, cc["npr"], (cc["p3"], cc["p4"], cc["p5"]),
                           mask_stride, proto_head, fused_entry=fused_head, **q)

    def forward(self, x: torch.Tensor) -> RawPredictions:
        """The span ``forward``, over one ``forward.<block>`` per top-level
        block; its self time is the input's cast and layout change, the
        upsamples and the concatenations."""
        with span("forward", x):
            return self._forward(x)

    def _block(self, name: str, x, device: torch.device):
        with span(BLOCK_SPANS[name], device):
            return getattr(self, name)(x)

    def _forward(self, x: torch.Tensor) -> RawPredictions:
        dtype = self.dtype or next(self.parameters()).dtype
        if self.s2d_stem and not self.s2d_input:
            x = space_to_depth2(x)
        z = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        d = x.device
        b = self._block
        if not self.s2d_stem:
            x0 = b("m0", z, d)
        elif self.space is None:
            x0 = b("m0s2d", F.pad(z, (1, 0, 1, 0)), d)
        else:
            x0 = b("m0s2d", F.pad(self.space.halo(z, 1, 0), (1, 0, 0, 0)), d)
        x2 = b("m2", b("m1", x0, d), d)
        x4 = b("m4", b("m3", x2, d), d)  # P3
        x6 = b("m6", b("m5", x4, d), d)  # P4
        x9 = b("m9", b("m8", b("m7", x6, d), d), d)  # P5
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x12 = b("m12", torch.cat([up(x9), x6], dim=1), d)
        x15 = b("m15", torch.cat([up(x12), x4], dim=1), d)
        x18 = b("m18", torch.cat([b("m16", x15, d), x12], dim=1), d)
        x21 = b("m21", torch.cat([b("m19", x18, d), x9], dim=1), d)
        return b("m22", (x15, x18, x21), d)


def create_model(variant: str = "n", nc: int = 2, nm: int = 32, mask_stride: int = 4,
                 proto_head: str = "deconv", s2d_input: bool = True, s2d_stem: bool = True,
                 folded_bn: bool = True, dtype: torch.dtype | None = None,
                 fused_head: bool = False, qmode: str = "") -> YOLOv8Seg:
    if variant not in SCALES:
        raise ValueError(f"unknown variant {variant!r}; choose from {sorted(SCALES)}")
    if mask_stride not in (2, 4):
        raise ValueError(f"mask_stride must be 2 or 4, got {mask_stride}")
    if proto_head not in ("deconv", "subpixel"):
        raise ValueError(f"proto_head must be 'deconv' or 'subpixel', got {proto_head!r}")
    return YOLOv8Seg(variant, nc, nm, mask_stride, proto_head, s2d_input, s2d_stem, folded_bn,
                     dtype, fused_head, qmode)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: variance 1/fan_in, normal truncated at two
    standard deviations (jax's truncated_normal rescaled to unit variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape, dtype=torch.float32), 0.0, 1.0,
                                            -2.0, 2.0, generator=generator) * std)


def init_model(variant: str = "n", nc: int = 2, mask_stride: int = 4,
               proto_head: str = "deconv", generator: torch.Generator | None = None,
               nm: int = 32, dtype: torch.dtype | None = None) -> YOLOv8Seg:
    """A fresh training-form model (k3/s2 stem, BatchNorm with running
    statistics), float32 on the CPU, initialised with the distributions
    ``tti.model.yolo.init_variables`` uses: lecun-normal (truncated) conv
    and transposed-conv kernels, zero biases, BN scale 1 / bias 0 / mean 0 /
    var 1, the class-bias prior ``log(5 / nc / (640 / stride)^2)`` on the
    class heads and 1.0 on the DFL heads' biases. The draws come from
    ``generator`` in module order; the values are not flax's."""
    model = create_model(variant, nc, nm, mask_stride, proto_head, s2d_stem=False,
                         folded_bn=False, dtype=dtype)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ConvTranspose2d):  # kernel (I, O, kh, kw); flax fan_in = kh*kw*I
            _lecun_normal_(mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel(), gen)
        elif isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
        else:
            continue
        if mod.bias is not None:
            nn.init.zeros_(mod.bias)
    head = model.m22
    for level, stride in enumerate(STRIDES):
        nn.init.ones_(getattr(head, f"cv2_{level}_2").bias)
        nn.init.constant_(getattr(head, f"cv3_{level}_2").bias,
                          math.log(5 / nc / (640 / stride) ** 2))
    return model
