"""The epilogue of the port's float convolutions on the card: the bias and
SiLU in one pass (kernel G), a hand-written CUDA kernel and its plain
PyTorch version.

:func:`bias_act` computes what cuDNN's route through ``F.conv2d`` /
``F.conv_transpose2d`` with a bias, then ``F.silu``, computes after the
convolution proper: ``silu(round(y + bias))``, or ``round(y + bias)``
without the activation, in that route's arithmetic (the sum in float,
rounded to ``y``'s dtype, then ``x / (1 + exp(-x))`` in float, rounded
again), so the kernel's output is that route's, bit for bit. ``tti`` has no
``pallas_call`` here: XLA fuses its bias and SiLU into the convolution.

The kernel is the operator ``torch.ops.tti_torch.bias_act``
(:func:`tti_torch.kernels.build.register_op`): on a CPU tensor it runs the
plain version; on a CUDA tensor it launches the kernel or raises. Its route
(:func:`plan`) follows the output's layout, channel count, size and address.
What bounds the kernel and what its design does about it is written in
``csrc/conv_epilogue.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tti_torch.kernels.build import load_library, register_op

Tensor = torch.Tensor

# Kernel launches (plain-version calls are not counted).
LAUNCHES = {"bias_act": 0}
THREADS = 256  # a block of the kernel (csrc/conv_epilogue.cu kThreads)
UNROLL = 2  # vectors a thread holds in flight per iteration
VECTOR_BYTES = 16
CHANNELS, WRAPPED, PLANE, SCALAR = 0, 1, 2, 3  # the kernel's routes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("conv_epilogue")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tti_bias_act.argtypes = [p, p, p, q, q, i, i, i, i, i, p]
        lib.tti_bias_act.restype = i
        lib.tti_bias_act_blocks_per_sm.argtypes = [i, i, i, i]
        lib.tti_bias_act_blocks_per_sm.restype = i
        lib.tti_bias_act_max_channels.argtypes = [i]
        lib.tti_bias_act_max_channels.restype = i
        _lib = lib
    return _lib


class Plan(NamedTuple):
    """One launch: the route, its vector (elements), the units it walks
    (vectors, or elements on :data:`SCALAR`) and ``inner``, the elements
    between one channel and the next (1 channels_last, H * W NCHW)."""

    route: int
    vec: int
    units: int
    inner: int


def plan(shape: tuple, channels_last: bool, esize: int, aligned: bool) -> Plan:
    """Kernel G's route for a dense (N, C, H, W) output of ``esize``-byte
    elements: 16-byte vectors where they cover whole runs of channels
    (channels_last, C a multiple of the vector), wrap through the channels
    (channels_last, the count a multiple of the vector) or lie in one
    channel's plane (NCHW, H * W a multiple), the addresses ``aligned`` to
    16 bytes; else element by element."""
    n, c, h, w = shape
    count, inner, vec = n * c * h * w, 1 if channels_last else h * w, VECTOR_BYTES // esize
    if aligned and channels_last and c % vec == 0:
        return Plan(CHANNELS, vec, count // vec, inner)
    if aligned and channels_last and count % vec == 0:
        return Plan(WRAPPED, vec, count // vec, inner)
    if aligned and not channels_last and inner % vec == 0:
        return Plan(PLANE, vec, count // vec, inner)
    return Plan(SCALAR, 1, count, inner)


def blocks(units: int, blocks_per_sm: int, sms: int) -> int:
    """The grid: one wave of what the card's ``sms`` hold, or fewer blocks
    when each thread's :data:`UNROLL` vectors cover the units sooner."""
    return max(1, min(-(-units // (THREADS * UNROLL)), blocks_per_sm * sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(c: int, dtype: int, route: int, act: bool) -> int:
    n = build().tti_bias_act_blocks_per_sm(c, dtype, route, int(act))
    if n < 1:
        raise RuntimeError(f"bias-act kernel occupancy query failed: cudaError {-n}")
    return n


@functools.lru_cache(maxsize=1024)
def _launch_args(shape: tuple, channels_last: bool, dtype: torch.dtype, esize: int,
                 aligned: bool, act: bool, index: int) -> tuple:
    """The launch's arguments after the three pointers and before the stream."""
    pl = plan(shape, channels_last, esize, aligned)
    c = shape[1]
    if c > build().tti_bias_act_max_channels(esize):
        raise ValueError(f"{c} channels: the bias-act kernel takes at most "
                         f"{build().tti_bias_act_max_channels(esize)} in {dtype}")
    grid = blocks(pl.units, _blocks_per_sm(c, _DTYPES[dtype], pl.route, act), _sm_count(index))
    return (pl.units, pl.inner, c, _DTYPES[dtype], pl.route, int(act), grid)


# ---------------------------------------------------------------------------
# Plain version (CPU path and test oracle)
# ---------------------------------------------------------------------------


def bias_act_plain(y: Tensor, bias: Tensor, act: bool = True) -> Tensor:
    """The parent route's epilogue in plain PyTorch: ``y + bias`` broadcast
    over the channels, then ``F.silu`` when ``act``."""
    out = y + bias.view(1, -1, 1, 1)
    return F.silu(out) if act else out


def _plain_op(y: Tensor, bias: Tensor, act: bool) -> Tensor:
    return torch.empty_like(y).copy_(bias_act_plain(y, bias, act))  # y's strides, as on the card


def _launch(y: Tensor, bias: Tensor, act: bool) -> Tensor:
    """The CUDA implementation: one launch of kernel G."""
    if bias.device != y.device:
        raise ValueError(f"bias is on {bias.device}, the output on {y.device}")
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    channels_last = not y.is_contiguous()
    aligned = y.data_ptr() % VECTOR_BYTES == 0 and out.data_ptr() % VECTOR_BYTES == 0
    index = y.device.index if y.device.index is not None else torch.cuda.current_device()
    args = _launch_args(tuple(y.shape), channels_last, y.dtype, y.element_size(), aligned,
                        bool(act), index)
    lib = build()
    with torch.cuda.device(index):
        err = lib.tti_bias_act(y.data_ptr(), bias.data_ptr(), out.data_ptr(), *args,
                               torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"bias-act kernel launch failed: cudaError {err}")
    LAUNCHES["bias_act"] += 1
    return out


_OP = register_op("bias_act(Tensor y, Tensor bias, bool act) -> Tensor", _plain_op, _launch,
                  lambda y, bias, act: torch.empty_like(y))


def _check(y: Tensor, bias: Tensor) -> None:
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the bias-act epilogue runs on cpu or cuda tensors, got {y.device}")
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"y must be (N, C, H, W) and bias (C,), got {tuple(y.shape)} and "
                         f"{tuple(bias.shape)}")
    if y.dtype not in _DTYPES or bias.dtype != y.dtype:
        raise TypeError(f"y and bias must both be float32 or bfloat16, got {y.dtype} and "
                        f"{bias.dtype}")
    if not (y.is_contiguous() or y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"y must be contiguous or channels_last, got strides {y.stride()}")
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")


def bias_act(y: Tensor, bias: Tensor, act: bool = True) -> Tensor:
    """Kernel G: a convolution's output ``y`` (N, C, H, W), contiguous or
    channels_last, float32 or bfloat16, and its ``bias`` (C,) of ``y``'s
    dtype -> ``silu(y + bias)`` (``act``) or ``y + bias``, each step rounded
    to ``y``'s dtype, in ``y``'s layout."""
    _check(y, bias)
    return _OP(y, bias, bool(act))
