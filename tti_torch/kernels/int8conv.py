"""int8 inference on the card: the quantized convolution (kernel E) and the
per-sample activation scale (kernel F), hand-written CUDA kernels with their
plain PyTorch versions.

:func:`int8_conv2d` (kernel E) computes ``tti``'s ``Conv`` block in
``qmode="int8"`` / ``"int8s"`` (``tti.model.layers.Conv``, whose
convolution is XLA's int8 ``conv_general_dilated``, not a ``pallas_call``):
the input quantized by its scale, ``clamp(rint(x / s), -127, 127)``, an
int8 x int8 -> int32 convolution with the packed weights, then ``acc *
(xscale * wscale) + bias`` in float32, rounded to the input's dtype, then
SiLU. :func:`act_scale_per_sample` (kernel F) is ``tti``'s
``quantize_act_per_sample`` scale: ``max(absmax, 1e-12) / 127`` per sample.

Tensors are NCHW-indexed (the port's modules), any strides: a channel slice
of a channels_last tensor is read in place. The output is channels_last.
Weights are packed once at load by :func:`pack_qweight`: ``(co, kh, kw,
ci)`` int8 -> ``(co, Kp)``, K in (kh, kw, ci) order zero-padded to a
multiple of 32.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises. The plain version quantizes in float32, convolves the
integer values in float64 (exact) and runs the same float32 epilogue in the
same order, so the kernel equals it bit for bit (SiLU's ``expf`` aside, see
``csrc/int8conv.cu``, where what bounds the kernels and their design are
written).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tti_torch.kernels.build import load_library

Tensor = torch.Tensor

K_ALIGN = 32  # the kernel's K step (one mma.m16n8k32)

# Kernel launches (plain-version calls are not counted).
LAUNCHES = {"int8_conv2d": 0, "act_scale_per_sample": 0}

_lib: ctypes.CDLL | None = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132  # H100 SXM: F spreads each batch over about two blocks per SM
HALO_SMEM = 100 * 1024  # E's halo route: two blocks per SM


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("int8conv")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tti_int8_conv2d.argtypes = [p, ll, ll, ll, ll, i, i, i, i, p, i, i, i, i, i, p, p,
                                        p, i, p, i, i, i, i, i, i, i, p]
        lib.tti_int8_conv2d.restype = i
        lib.tti_act_scale_per_sample.argtypes = [p, ll, ll, ll, ll, i, i, i, i, i, i, i, i, p,
                                                 p, p]
        lib.tti_act_scale_per_sample.restype = i
        _lib = lib
    return _lib


def pack_qweight(qweight: Tensor) -> Tensor:
    """``(co, kh, kw, ci)`` int8 -> ``(co, Kp)`` int8, K = kh*kw*ci in that
    order, zero-padded to a multiple of :data:`K_ALIGN`."""
    co = qweight.shape[0]
    flat = qweight.reshape(co, -1)
    k = flat.shape[1]
    return F.pad(flat, (0, (-k) % K_ALIGN)).contiguous()


def _out_hw(h: int, w: int, k: int, stride: int, pad: int) -> tuple[int, int]:
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


# ---------------------------------------------------------------------------
# Plain versions (CPU path and test oracle)
# ---------------------------------------------------------------------------


def act_scale_per_sample_plain(x: Tensor) -> Tensor:
    """(B, C, H, W) -> (B,) float32 ``max(max |x|, 1e-12) / 127``. The
    divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently from IEEE
    division (the reference's and the kernel's)."""
    absmax = torch.clamp(x.float().abs().amax(dim=(1, 2, 3)), min=1e-12)
    return absmax / torch.full_like(absmax, 127.0)


def quantize_act_plain(x: Tensor, xscale: Tensor) -> Tensor:
    """The int8 codes of ``x`` (as float32): ``clamp(round(x / s), -127,
    127)``, ``s`` per sample ((B,)) or one scale (0-d)."""
    s = xscale.view(-1, 1, 1, 1) if xscale.dim() == 1 else xscale
    return torch.clamp(torch.round(x.float() / s), -127.0, 127.0)


def int8_accumulate_plain(q: Tensor, qweight: Tensor, k: int, stride: int, pad: int) -> Tensor:
    """The exact int32 accumulators of codes ``q`` (B, ci, H, W) with the
    packed weights, as float64 (B, co, Ho, Wo)."""
    co, ci = qweight.shape[0], q.shape[1]
    w = qweight[:, :k * k * ci].reshape(co, k, k, ci).permute(0, 3, 1, 2)
    # float64 products and sums of integers below 2^53 are exact in any
    # order; cuDNN is kept out so that no transform-based algorithm is used.
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(q.double(), w.double(), stride=stride, padding=pad)


def int8_conv2d_plain(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                      k: int, stride: int = 1, pad: int = 0, act: bool = True) -> Tensor:
    """Kernel E's function in plain PyTorch (see :func:`int8_conv2d`)."""
    acc = int8_accumulate_plain(quantize_act_plain(x, xscale), qweight, k, stride, pad)
    xs = xscale.view(-1, 1, 1, 1) if xscale.dim() == 1 else xscale
    y = acc.float() * (xs * wscale.view(1, -1, 1, 1)) + bias.view(1, -1, 1, 1)
    y = y.to(x.dtype)
    if act:
        y = F.silu(y)
    return y.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def halo_pixel_bytes(c: int, stride: int) -> int:
    """Bytes per pixel of the halo route's quantized window in shared memory:
    ``c`` padded so that the 8 rows of an mma fragment, ``stride`` pixels
    apart, fall in distinct shared-memory banks."""
    if stride == 1:
        return c if c % 32 == 16 else c + 16
    return c + 8


def halo_route(c: int, k: int, stride: int, load_bytes: int, bn: int) -> int:
    """Kernel E's route for a block: the halo route's bytes per window pixel
    (:func:`halo_pixel_bytes`), or 0 for the direct route. The halo route
    takes 16-byte loads of whole 16-channel groups and a window (an 8 x 16
    output tile's input, plus the two weight buffers) within
    :data:`HALO_SMEM`; the stems (ci 3 and 12) go the direct route."""
    cp = halo_pixel_bytes(c, stride)
    hh, hw = 7 * stride + k, 15 * stride + k
    smem = (hh * hw * cp + 15) // 16 * 16 + 2 * bn * 48
    return cp if c % 16 == 0 and load_bytes == 16 and smem <= HALO_SMEM else 0


def _vec_width(x: Tensor, c: int) -> int:
    """Elements per load: 8, 4 or 1, as channels, strides and alignment allow."""
    if x.stride(1) != 1:
        return 1
    for v in (8, 4):
        if (c % v == 0 and x.data_ptr() % (v * x.element_size()) == 0
                and all(s % v == 0 for s in (x.stride(0), x.stride(2), x.stride(3)))):
            return v
    return 1


def _check_input(x: Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: input must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: input must be float32 or bfloat16, got {x.dtype}")
    if x[0].numel() >= 2 ** 31 or x.shape[0] > 65535:
        raise ValueError(f"{what}: input {tuple(x.shape)} too large for one launch")


def _launch_scale(x: Tensor) -> Tensor:
    _check_input(x, "act_scale_per_sample")
    b, c, h, w = x.shape
    vec = _vec_width(x, c)
    cpp = c // vec
    fast = int(x.stride(2) == w * x.stride(3) and 256 % cpp == 0)
    chunks = h * w * cpp
    splits = max(1, min(-(-2 * _SMS // b), chunks // 1024))
    lib = build()
    buf = torch.empty(b + b * splits + b, dtype=torch.float32, device=x.device)
    scale, scratch = buf[:b], buf[b:]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_act_scale_per_sample(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), x.stride(3), b, c, h, w,
            _DTYPES[x.dtype], vec, splits, fast, scale.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"activation-scale kernel launch failed: cudaError {err}")
    LAUNCHES["act_scale_per_sample"] += 1
    return scale


def act_scale_per_sample(x: Tensor) -> Tensor:
    """Kernel F: (B, C, H, W) float32 or bfloat16, any strides -> (B,)
    float32 ``max(absmax, 1e-12) / 127`` per sample."""
    if x.device.type == "cpu":
        return act_scale_per_sample_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"the activation scale runs on cpu or cuda tensors, got {x.device}")
    return _launch_scale(x)


def _launch_conv(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                 k: int, stride: int, pad: int, act: bool) -> Tensor:
    _check_input(x, "int8_conv2d")
    b, c, h, w = x.shape
    co, kp = qweight.shape
    for name, t, dtype in (("qweight", qweight, torch.int8), ("wscale", wscale, torch.float32),
                           ("bias", bias, torch.float32), ("xscale", xscale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the input on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wscale.shape != (co,) or bias.shape != (co,) or xscale.shape not in ((), (b,)):
        raise ValueError(f"wscale {tuple(wscale.shape)}, bias {tuple(bias.shape)}, xscale "
                         f"{tuple(xscale.shape)} against co={co}, B={b}")
    bn = next((n for n in (64, 32, 16) if co % n == 0), None)
    if bn is None or kp % K_ALIGN or kp < k * k * c:
        raise ValueError(f"qweight {tuple(qweight.shape)} does not fit k={k}, ci={c}: co must "
                         f"be a multiple of 16, Kp a multiple of {K_ALIGN} >= {k * k * c}")
    ho, wo = _out_hw(h, w, k, stride, pad)
    out = torch.empty((b, co, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31 or (b * ho * wo + 127) // 128 >= 2 ** 31:
        raise ValueError(f"output {tuple(out.shape)} too large for one launch")
    vec = _vec_width(x, c)
    cp = halo_route(c, k, stride, vec * x.element_size(), bn)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_int8_conv2d(
            x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), x.stride(3), b, c, h, w,
            qweight.data_ptr(), kp, co, k, stride, pad, wscale.data_ptr(), bias.data_ptr(),
            xscale.data_ptr(), int(xscale.dim() == 1), out.data_ptr(), ho, wo, int(act),
            _DTYPES[x.dtype], vec, bn, cp, stream)
    if err != 0:
        raise RuntimeError(f"int8 convolution kernel launch failed: cudaError {err}")
    LAUNCHES["int8_conv2d"] += 1
    return out


def int8_conv2d(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                k: int, stride: int = 1, pad: int = 0, act: bool = True) -> Tensor:
    """Kernel E: the quantized ``Conv`` block.

    ``x`` (B, ci, H, W) float32 or bfloat16, any strides; ``qweight`` the
    packed (co, Kp) int8 weights (:func:`pack_qweight`); ``wscale`` and
    ``bias`` (co,) float32; ``xscale`` float32, (B,) per sample
    (``TTI_QUANT=int8``, :func:`act_scale_per_sample`) or 0-d (``int8s``).
    Square kernel ``k``, symmetric zero padding ``pad``. Returns (B, co,
    Ho, Wo) in ``x``'s dtype, channels_last."""
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, qweight, wscale, bias, xscale, k, stride, pad, act)
    if x.device.type != "cuda":
        raise ValueError(f"the int8 convolution runs on cpu or cuda tensors, got {x.device}")
    return _launch_conv(x, qweight, wscale, bias, xscale, k, stride, pad, act)
