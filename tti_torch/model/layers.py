"""YOLOv8 building blocks as ``nn.Module``s (port of ``tti.model.layers``).

Two forms of every block. ``folded=True`` (inference): BatchNorm is folded
into each conv's weights and bias
(:func:`tti_torch.model.checkpoint.fold_batchnorm`), so ``Conv`` is
Conv2d(bias=True) + SiLU. ``folded=False`` (training): Conv2d without bias,
then :class:`BatchNorm`, then SiLU, as flax's ``Conv`` block with
``nn.BatchNorm``. Modules run NCHW inside; attribute names mirror the flax
tree so the weight map is a rename.

Every convolution computes in its input's dtype: parameters are cast to it
(a no-op when they already have it), so a float32 model fed bfloat16
activations trains in mixed precision with float32 parameters and float32
gradients, as flax's ``dtype=bf16, param_dtype=f32`` does.

A biased float convolution of a CUDA input that needs no gradient runs
without its bias, and kernel G (:func:`tti_torch.kernels.conv_epilogue.bias_act`)
adds the bias and, in a ``Conv`` block, applies SiLU in one pass, bit-equal
to cuDNN's bias add and ``F.silu`` (:func:`fused_epilogue`). Elsewhere, on
the CPU and in training, the convolution takes its bias and ``F.silu``
follows.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tti_torch.kernels.conv_epilogue import bias_act
from tti_torch.kernels.int8conv import act_scale_per_sample, int8_conv2d, pack_qweight
from tti_torch.parallel.mesh import all_reduce_sum
from tti_torch.preprocess.letterbox import jit_divide


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def autopad(k: int, d: int = 1) -> int:
    return (d * (k - 1) + 1) // 2


def fused_epilogue(x: torch.Tensor, conv: nn.Module) -> bool:
    """Whether ``conv``'s bias (and its block's SiLU) go to kernel G: a
    convolution with a bias, on a CUDA input, with no gradient to record."""
    return (conv.bias is not None and x.is_cuda
            and not (torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad)))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype; ``padding``
    overrides the module's own; ``act``: SiLU after the bias. The bias and
    SiLU go to kernel G where :func:`fused_epilogue` allows."""

    def forward(self, x: torch.Tensor, padding: int | None = None,
                act: bool = False) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        pad = self.padding if padding is None else padding
        if fused_epilogue(x, self):
            y = F.conv2d(x, w, None, self.stride, pad, self.dilation, self.groups)
            return bias_act(y, self.bias.to(x.dtype), act)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, w, bias, self.stride, pad, self.dilation, self.groups)
        return F.silu(y) if act else y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (stride = kernel, no padding) that computes in
    its input's dtype; the bias goes to kernel G as :class:`Conv2d`'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if fused_epilogue(x, self):
            return bias_act(F.conv_transpose2d(x, w, None, self.stride), self.bias.to(x.dtype),
                            False)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, w, bias, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.97, epsilon=1e-3)`` over NCHW channels.

    Training normalises with the batch mean and the *biased* batch variance,
    computed in float32 whatever the input dtype, and moves the running
    statistics by ``r = 0.97 r + 0.03 s`` with that same biased variance.
    ``torch.nn.BatchNorm2d`` would update ``running_var`` with the unbiased
    variance (n/(n-1) larger), so ``F.batch_norm`` gets a zeroed scratch
    buffer for the variance and the biased value is recovered from it. In
    eval mode the running statistics normalise. The output has the input's
    dtype; weight and bias stay float32.

    ``group`` (a process group; None by default, set by
    :func:`set_batchnorm_group`): training normalises with the statistics
    of the global batch, every rank's rows, as ``tti``'s BatchNorm does
    under a ``"data"`` sharding. Each rank sums ``x`` and ``x * x`` per
    channel in float32, one differentiable all-reduce adds the ranks' sums
    (its backward adds the ranks' gradients), and flax's formula follows:
    ``mean``, ``var = max(mean(x^2) - mean^2, 0)``, ``(x - mean) *
    rsqrt(var + eps) * weight + bias``; the running statistics move with
    those. Every rank holds the same number of rows (the mesh's split).
    """

    momentum = 0.03  # torch convention: flax's 0.97 is the weight of the old value
    eps = 1e-3
    group = None

    def __init__(self, c: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.group is not None:
            return self._global_batch(x)
        scratch = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, self.running_mean, scratch, self.weight, self.bias, True,
                         self.momentum, self.eps)
        # scratch = momentum * n/(n-1) * biased variance.
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(scratch * ((n - 1) / n))
        return y

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.float()
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]),
                              self.group)
        mean, var = stats_from_sums(sums, (x.numel() // c) * dist.get_world_size(self.group))
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var * self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def stats_from_sums(sums: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's batch statistics from the per-channel sums of ``x`` and ``x *
    x`` (``sums``, (2C,) float32) over ``count`` values: ``mean``, ``var =
    max(mean(x^2) - mean^2, 0)``. The count is a shape, fixed when ``tti``
    traces its step, so ``jnp.mean``'s division is the product with its
    float32 reciprocal (:func:`jit_divide`)."""
    c = sums.shape[0] // 2
    mean = jit_divide(sums[:c], count)
    return mean, (jit_divide(sums[c:], count) - mean * mean).clamp(min=0.0)


def set_batchnorm_group(model: nn.Module, group) -> None:
    """Every :class:`BatchNorm` of ``model`` normalises in training with the
    global batch's statistics over ``group`` (None: its own rows)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


QMODES = ("", "int8", "int8s")


class Conv(nn.Module):
    """Conv2d + BN + SiLU. ``folded``: BN folded into the conv's weights and
    bias; otherwise Conv2d without bias, then :class:`BatchNorm`. ``pad=None``
    is 'same' padding for odd kernels; 0 is VALID (the caller pre-pads, as
    the s2d stem does).

    ``qmode`` "int8" / "int8s" (requires ``folded``): the W8A8 block of
    :mod:`tti_torch.model.quantize`, one launch of kernel E
    (:func:`tti_torch.kernels.int8conv.int8_conv2d`). Buffers: ``qweight``
    (co, kh, kw, ci) int8 as the checkpoint holds it, ``qscale`` (co,) and
    ``bias`` (co,) float32, for "int8s" ``ascale`` (0-d float32, the
    calibrated input scale; "int8" takes each sample's scale from kernel F),
    and ``qpacked``, the (co, Kp) layout kernel E reads, packed once when
    the state dict is loaded (not saved). The float32 buffers stay float32
    when the model is cast (:func:`tti_torch.parallel.runtime.inference_model`).

    ``space`` (None unless :func:`tti_torch.parallel.spatial.set_space`
    gives one): the input is this rank's slab of the frame's rows. A
    'same'-padded conv then takes its :meth:`halo_rows` from the
    neighbouring slabs and runs unpadded on them; under "int8" each
    sample's scale is the maximum over the group (the whole sample's).
    """

    space = None

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 pad: int | None = None, act: bool = True, folded: bool = True,
                 qmode: str = "") -> None:
        super().__init__()
        if qmode not in QMODES:
            raise ValueError(f"qmode must be one of {QMODES}, got {qmode!r}")
        self.act = act
        self.qmode = qmode
        p = autopad(k) if pad is None else pad
        self.k, self.s, self.p = k, s, p
        if qmode:
            if not folded:
                raise ValueError(f"qmode={qmode!r} requires folded BatchNorm")
            self.register_buffer("qweight", torch.zeros(c2, k, k, c1, dtype=torch.int8))
            self.register_buffer("qscale", torch.ones(c2))
            self.register_buffer("bias", torch.zeros(c2))
            if qmode == "int8s":
                self.register_buffer("ascale", torch.ones(()))
            self.register_buffer("qpacked", pack_qweight(self.qweight), persistent=False)
            return
        self.conv = Conv2d(c1, c2, k, s, p, bias=folded)
        if not folded:
            self.bn = BatchNorm(c2)

    def _load_from_state_dict(self, *args, **kwargs) -> None:
        super()._load_from_state_dict(*args, **kwargs)
        if self.qmode:
            self.qpacked = pack_qweight(self.qweight)

    def halo_rows(self) -> tuple[int, int]:
        """Rows a slab needs from above and below: ``p`` and ``k - s - p``
        for 'same' padding ``p`` (1, 1 at k3/s1; 1, 0 at k3/s2 on an
        even-aligned slab); none unpadded (a caller that pads, as the s2d
        stem's, gives the halo itself)."""
        return (self.p, self.k - self.s - self.p) if self.p else (0, 0)

    def forward(self, x: torch.Tensor, xh: torch.Tensor | None = None) -> torch.Tensor:
        """``xh`` (with ``space``): ``x`` with its halo rows and zero
        columns, when the caller exchanged once for several convs that
        read ``x``."""
        pad, xin = self.p, x
        if self.space is not None and pad:
            xin = xh if xh is not None else self.space.halo(x, *self.halo_rows(), wpad=pad)
            pad = 0
        if self.qmode:
            xscale = self.ascale if self.qmode == "int8s" else act_scale_per_sample(x)
            if self.space is not None and self.qmode == "int8":
                xscale = self.space.max(xscale)
            return int8_conv2d(xin, self.qpacked, self.qscale, self.bias, xscale, self.k,
                               self.s, pad, self.act)
        padding = None if pad == self.p else pad
        if hasattr(self, "bn"):
            x = self.bn(self.conv(xin, padding))
            return F.silu(x) if self.act else x
        return self.conv(xin, padding, self.act)


class Bottleneck(nn.Module):
    """Two 3x3 Convs with optional residual (C2f inner block, e=1.0).
    ``qmode`` here and in the blocks below goes to every :class:`Conv`."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, folded: bool = True,
                 qmode: str = "") -> None:
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, folded=folded, qmode=qmode)
        self.cv2 = Conv(c2, c2, 3, folded=folded, qmode=qmode)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks and dense skip concat.
    Bottlenecks are attributes m0, m1, ... as in the flax tree."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 e: float = 0.5, folded: bool = True, qmode: str = "") -> None:
        super().__init__()
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * self.c, 1, folded=folded, qmode=qmode)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, self.c, shortcut, folded, qmode))
        self.cv2 = Conv((2 + n) * self.c, c2, 1, folded=folded, qmode=qmode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = list(self.cv1(x).split(self.c, dim=1))
        for i in range(self.n):
            outs.append(getattr(self, f"m{i}")(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained k-pools, concat, project.
    With ``space`` (see :class:`Conv`) each pool takes ``k // 2`` rows each
    way from the neighbouring slabs, -inf beyond the frame as its padding."""

    space = None

    def __init__(self, c1: int, c2: int, k: int = 5, folded: bool = True,
                 qmode: str = "") -> None:
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2, 1, folded=folded, qmode=qmode)
        self.cv2 = Conv(c1 // 2 * 4, c2, 1, folded=folded, qmode=qmode)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        r = self.k // 2
        for _ in range(3):
            if self.space is None:
                pools.append(F.max_pool2d(pools[-1], self.k, 1, r))
            else:
                xh = self.space.halo(pools[-1], r, r, float("-inf"))
                pools.append(F.max_pool2d(xh, self.k, 1, (0, r)))
        return self.cv2(torch.cat(pools, dim=1))


def depth_to_space2(x: torch.Tensor, c: int) -> torch.Tensor:
    """NCHW (B, 4C, H, W) -> (B, C, 2H, 2W); channel (a*2 + b)*C + c feeds
    output pixel (2i + a, 2j + b), the reference's NHWC reshape order."""
    b, _, h, w = x.shape
    x = x.view(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


class Proto(nn.Module):
    """Mask prototype head: conv -> learned 2x deconv -> conv -> 1x1 to nm.

    ups=2 emits protos at input/2: ``subpixel=True`` is a 1x1 conv to the 4
    spatial phases' protos + depth-to-space; ``subpixel=False`` a second
    deconv + 3x3 conv stage (upsample2/cv2b) before the 1x1.
    """

    def __init__(self, c1: int, c_hidden: int, nm: int = 32, ups: int = 1,
                 subpixel: bool = False, folded: bool = True, qmode: str = "") -> None:
        super().__init__()
        self.nm = nm
        self.ups = ups
        self.subpixel = subpixel
        q = dict(folded=folded, qmode=qmode)
        self.cv1 = Conv(c1, c_hidden, 3, **q)
        self.upsample = ConvTranspose2d(c_hidden, c_hidden, 2, 2, bias=True)
        self.cv2 = Conv(c_hidden, c_hidden, 3, **q)
        if ups == 2 and subpixel:
            self.cv3sp = Conv(c_hidden, 4 * nm, 1, **q)
            return
        if ups == 2:
            self.upsample2 = ConvTranspose2d(c_hidden, c_hidden, 2, 2, bias=True)
            self.cv2b = Conv(c_hidden, c_hidden, 3, **q)
        self.cv3 = Conv(c_hidden, nm, 1, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv2(self.upsample(self.cv1(x)))
        if self.ups == 2 and self.subpixel:
            # SiLU is elementwise, so applying it before the permutation
            # equals applying it after.
            return depth_to_space2(self.cv3sp(x), self.nm)
        if self.ups == 2:
            x = self.cv2b(self.upsample2(x))
        return self.cv3(x)
