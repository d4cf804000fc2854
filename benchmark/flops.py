"""Forward operations of YOLOv8-seg, counted from its convolutions' shapes.

The count is the work of the published architecture whatever implements
it: 2 x the multiply-accumulates of every convolution and transposed
convolution (the k3/s2 stem on RGB, not a rewrite of it), of the 1x1
exits of the head and of the DFL's fixed 1x1 convolution. Biases,
BatchNorm, pooling, upsampling, concatenation, activations and the decode
are not counted. Ultralytics' published figures (``get_flops``, through
``thop``) count the same, except that ``thop`` charges a transposed
convolution its output elements x input channels x kernel taps, four
times its multiply-accumulates at stride 2 and kernel 2:
:func:`thop_deconv_excess` is that difference.
"""

from __future__ import annotations

import math

SCALES = {"n": (1 / 3, 0.25, 1024), "s": (1 / 3, 0.50, 1024), "m": (2 / 3, 0.75, 768)}
REG_MAX = 16


def _div8(x: float) -> int:
    return int(math.ceil(x / 8) * 8)


class _Counter:
    def __init__(self) -> None:
        self.flops = 0.0

    def conv(self, h: int, w: int, ci: int, co: int, k: int, s: int = 1) -> tuple[int, int]:
        """A 'same'-padded convolution on an (h, w) map; returns the output
        map's size."""
        ho, wo = -(-h // s), -(-w // s)
        self.flops += 2.0 * ho * wo * co * ci * k * k
        return ho, wo

    def deconv2(self, h: int, w: int, ci: int, co: int) -> tuple[int, int]:
        """A transposed convolution of kernel 2 and stride 2: each output
        element takes one tap of each input channel."""
        self.flops += 2.0 * (2 * h) * (2 * w) * co * ci
        return 2 * h, 2 * w

    def c2f(self, h: int, w: int, c1: int, c2: int, n: int) -> None:
        c = c2 // 2
        self.conv(h, w, c1, 2 * c, 1)
        for _ in range(n):
            self.conv(h, w, c, c, 3)
            self.conv(h, w, c, c, 3)
        self.conv(h, w, (2 + n) * c, c2, 1)


def forward_flops(h: int, w: int, nc: int, variant: str = "n", nm: int = 32,
                  mask_stride: int = 4, proto_head: str = "deconv") -> float:
    """Operations of one forward pass on an (h, w) input (multiples of 32)."""
    d, wm, maxc = SCALES[variant]
    ch = {c: _div8(min(c, maxc) * wm) for c in (64, 128, 256, 512, 1024)}
    n3, n6 = max(round(3 * d), 1), max(round(6 * d), 1)
    t = _Counter()
    s2 = t.conv(h, w, 3, ch[64], 3, 2)
    s4 = t.conv(*s2, ch[64], ch[128], 3, 2)
    t.c2f(*s4, ch[128], ch[128], n3)
    s8 = t.conv(*s4, ch[128], ch[256], 3, 2)
    t.c2f(*s8, ch[256], ch[256], n6)
    s16 = t.conv(*s8, ch[256], ch[512], 3, 2)
    t.c2f(*s16, ch[512], ch[512], n6)
    s32 = t.conv(*s16, ch[512], ch[1024], 3, 2)
    t.c2f(*s32, ch[1024], ch[1024], n3)
    t.conv(*s32, ch[1024], ch[1024] // 2, 1)  # SPPF
    t.conv(*s32, ch[1024] // 2 * 4, ch[1024], 1)
    t.c2f(*s16, ch[1024] + ch[512], ch[512], n3)  # m12
    t.c2f(*s8, ch[512] + ch[256], ch[256], n3)  # m15 (P3)
    t.conv(*s8, ch[256], ch[256], 3, 2)  # m16
    t.c2f(*s16, ch[256] + ch[512], ch[512], n3)  # m18 (P4)
    t.conv(*s16, ch[512], ch[512], 3, 2)  # m19
    t.c2f(*s32, ch[512] + ch[1024], ch[1024], n3)  # m21 (P5)
    levels = ((s8, ch[256]), (s16, ch[512]), (s32, ch[1024]))
    c2 = max(16, ch[256] // 4, REG_MAX * 4)
    c3 = max(ch[256], min(nc, 100))
    c4 = max(ch[256] // 4, nm)
    anchors = 0
    for (hw, c) in levels:
        for width, out in ((c2, 4 * REG_MAX), (c3, nc), (c4, nm)):
            t.conv(*hw, c, width, 3)
            t.conv(*hw, width, width, 3)
            t.conv(*hw, width, out, 1)
        anchors += hw[0] * hw[1]
    t.flops += 2 * REG_MAX * 4 * anchors  # DFL: a fixed 1x1 conv of 16 -> 1 on each side
    npr = _div8(256 * wm)
    t.conv(*s8, ch[256], npr, 3)  # proto
    up = t.deconv2(*s8, npr, npr)
    t.conv(*up, npr, npr, 3)
    if mask_stride == 4:
        t.conv(*up, npr, nm, 1)
    elif proto_head == "subpixel":
        t.conv(*up, npr, 4 * nm, 1)
    else:
        up2 = t.deconv2(*up, npr, npr)
        t.conv(*up2, npr, npr, 3)
        t.conv(*up2, npr, nm, 1)
    return t.flops


def config_flops(config: dict) -> float:
    """Operations per frame of a configuration file's model at its
    letterboxed input (Ultralytics' minimal rect of the frame at imgsz)."""
    m = config["model"]
    h, w = config["run"]["frame_hw"]
    t = -(-m["imgsz"] // 32) * 32
    r = min(t / h, t / w)
    nh, nw = round(h * r), round(w * r)
    dh, dw = nh + (t - nh) % 32, nw + (t - nw) % 32
    return forward_flops(dh, dw, m["nc"], m["variant"], m["nm"], m["mask_stride"],
                         m["proto_head"])


def thop_deconv_excess(h: int, w: int, variant: str = "n", mask_stride: int = 4,
                       proto_head: str = "deconv") -> float:
    """What ``thop`` adds to :func:`forward_flops` on an (h, w) input: three
    more multiply-accumulates per output element and input channel of each
    kernel-2, stride-2 transposed convolution in the proto head."""
    npr = _div8(256 * SCALES[variant][1])
    out = (h // 4) * (w // 4) * npr  # the first deconv's output elements
    if mask_stride == 2 and proto_head == "deconv":
        out += (h // 2) * (w // 2) * npr
    return 2.0 * 3 * out * npr
