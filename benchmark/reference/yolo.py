"""YOLOv8-seg in plain PyTorch float32, straight from a flax checkpoint tree.

The published architecture (Ultralytics ``ultralytics/cfg/models/v8/
yolov8-seg.yaml``): the k3/s2 stem on RGB, the C2f backbone with SPPF, the
PAN neck, the decoupled Segment head and the mask prototype head. Every
Conv block is convolution, BatchNorm in eval mode with its running
statistics (epsilon 1e-3), then SiLU: nothing is folded, blocked or cast.
The proto head is either the published one (conv, 2x transposed conv,
conv, 1x1 conv: protos at stride 4) or the sub-pixel variant (the same,
then a 1x1 conv to four phases' protos and a depth-to-space: stride 2).

A flax kernel is (kh, kw, in, out); a flax ConvTranspose of stride 2 and
kernel 2 writes output pixel (2i + a, 2j + b) from input (i, j) through
kernel tap (1 - a, 1 - b), which is written out below as an einsum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
REG_MAX = 16
STRIDES = (8, 16, 32)
# depth, width, max channels of the published scales
SCALES = {"n": (1 / 3, 0.25, 1024), "s": (1 / 3, 0.50, 1024), "m": (2 / 3, 0.75, 768)}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def channels(variant: str) -> dict[str, int]:
    d, w, maxc = SCALES[variant]
    ch = {c: make_divisible(min(c, maxc) * w) for c in (64, 128, 256, 512, 1024)}
    return {**ch, "n3": max(round(3 * d), 1), "n6": max(round(6 * d), 1),
            "npr": make_divisible(256 * w)}


class ReferenceYOLOv8Seg:
    """Forward of YOLOv8-seg from ``tree`` (``{"params", "batch_stats"}``
    of numpy arrays) on ``device`` in float32. Input (B, 3, H, W) RGB in
    [0, 1]; output (box (B, A, 64), cls (B, A, nc), coef (B, A, nm), protos
    (B, Hp, Wp, nm), level shapes)."""

    def __init__(self, tree: dict, device, variant: str = "n", mask_stride: int = 4,
                 proto_head: str = "deconv") -> None:
        self.device = torch.device(device)
        self.p, self.s = tree["params"], tree.get("batch_stats", {})
        self.ch = channels(variant)
        self.mask_stride = mask_stride
        self.subpixel = proto_head == "subpixel"
        self._cache: dict[str, torch.Tensor] = {}

    def _t(self, key: str, arr) -> torch.Tensor:
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(np.asarray(arr, np.float32), device=self.device)
        return self._cache[key]

    def _node(self, path: str, tree: dict) -> dict:
        node = tree
        for part in path.split("/"):
            node = node[part]
        return node

    def conv_block(self, path: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """Conv (no bias) -> BatchNorm (running statistics) -> SiLU."""
        node, stats = self._node(path, self.p), self._node(path, self.s)
        k = self._t(path + "/k", np.transpose(node["conv"]["kernel"], (3, 2, 0, 1)))
        y = F.conv2d(x, k, None, stride, k.shape[-1] // 2)
        mean = self._t(path + "/m", stats["bn"]["mean"])
        var = self._t(path + "/v", stats["bn"]["var"])
        gamma = self._t(path + "/g", node["bn"]["scale"])
        beta = self._t(path + "/b", node["bn"]["bias"])
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
        return F.silu(y * gamma[:, None, None] + beta[:, None, None])

    def conv_plain(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 convolution with bias (the head's exits)."""
        node = self._node(path, self.p)
        k = self._t(path + "/k", np.transpose(node["kernel"], (3, 2, 0, 1)))
        return F.conv2d(x, k, self._t(path + "/b", node["bias"]))

    def deconv2(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """flax ConvTranspose, kernel 2, stride 2, VALID."""
        node = self._node(path, self.p)
        k = self._t(path + "/k", np.ascontiguousarray(node["kernel"][::-1, ::-1]))
        b, _, h, w = x.shape
        y = torch.einsum("nchw,pqco->nohpwq", x, k).reshape(b, -1, 2 * h, 2 * w)
        return y + self._t(path + "/b", node["bias"])[:, None, None]

    def c2f(self, path: str, x: torch.Tensor, n: int, shortcut: bool) -> torch.Tensor:
        y = self.conv_block(path + "/cv1", x)
        outs = list(y.chunk(2, 1))
        for i in range(n):
            z = self.conv_block(f"{path}/m{i}/cv2", self.conv_block(f"{path}/m{i}/cv1", outs[-1]))
            outs.append(outs[-1] + z if shortcut else z)
        return self.conv_block(path + "/cv2", torch.cat(outs, 1))

    def sppf(self, path: str, x: torch.Tensor) -> torch.Tensor:
        pools = [self.conv_block(path + "/cv1", x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.conv_block(path + "/cv2", torch.cat(pools, 1))

    def proto(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_block("m22/proto/cv2", self.deconv2("m22/proto/upsample",
                                                          self.conv_block("m22/proto/cv1", x)))
        if self.mask_stride == 4:
            return self.conv_block("m22/proto/cv3", x)
        if not self.subpixel:
            x = self.conv_block("m22/proto/cv2b", self.deconv2("m22/proto/upsample2", x))
            return self.conv_block("m22/proto/cv3", x)
        y = self.conv_block("m22/proto/cv3sp", x)  # (B, 4 nm, H, W), channel (2a + b) nm + c
        b, c4, h, w = y.shape
        y = y.reshape(b, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(b, c4 // 4, 2 * h, 2 * w)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor):
        n3, n6 = self.ch["n3"], self.ch["n6"]
        x0 = self.conv_block("m0", x, 2)
        x2 = self.c2f("m2", self.conv_block("m1", x0, 2), n3, True)
        x4 = self.c2f("m4", self.conv_block("m3", x2, 2), n6, True)
        x6 = self.c2f("m6", self.conv_block("m5", x4, 2), n6, True)
        x9 = self.sppf("m9", self.c2f("m8", self.conv_block("m7", x6, 2), n3, True))
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x12 = self.c2f("m12", torch.cat([up(x9), x6], 1), n3, False)
        x15 = self.c2f("m15", torch.cat([up(x12), x4], 1), n3, False)
        x18 = self.c2f("m18", torch.cat([self.conv_block("m16", x15, 2), x12], 1), n3, False)
        x21 = self.c2f("m21", torch.cat([self.conv_block("m19", x18, 2), x9], 1), n3, False)
        outs = {"box": [], "cls": [], "coef": []}
        levels = []
        for level, f in enumerate((x15, x18, x21)):
            levels.append((f.shape[2], f.shape[3]))
            for name, key in (("cv2", "box"), ("cv3", "cls"), ("cv4", "coef")):
                y = self.conv_block(f"m22/{name}_{level}_1",
                                    self.conv_block(f"m22/{name}_{level}_0", f))
                y = self.conv_plain(f"m22/{name}_{level}_2", y)
                outs[key].append(y.flatten(2).transpose(1, 2))  # (B, H*W, C)
        protos = self.proto(x15).permute(0, 2, 3, 1)
        return (torch.cat(outs["box"], 1), torch.cat(outs["cls"], 1),
                torch.cat(outs["coef"], 1), protos, levels)
