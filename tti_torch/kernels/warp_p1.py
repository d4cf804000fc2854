"""Fused warp pass 1: a hand-written CUDA kernel and its plain PyTorch
version (port of ``tti.kernels.warp_p1``).

:func:`warp_pass1_decimated` (kernel C) replaces the TPU's ``_p1_kernel``:
uint8 BGR frames -> the exact k-strided decimation -> BGR->RGB ->
``x * (1/255) - pad`` in the weight type -> per source row the product
``(3B, ws) @ W1[y] (ws, wo)`` with float32 accumulation -> the pass-1
intermediate ``(hs, 3, B, wo)`` that
:meth:`tti_torch.preprocess.warp2pass.TwoPassWarp.apply_pass2_ycbo` consumes.
It is ``letterbox_content(decimate=True)`` followed by the pass-1 einsum of
``TwoPassWarp.apply``, without the pad shift-back, in one pass over the
frames.

Rounding follows the TPU kernel: every step rounds to the weight type
(bfloat16 on the card, float32 on the CPU), and the normalisation
*multiplies* by ``1/255`` rounded to that type. The unfused chain *divides*
by 255: in float32 the two agree to 2e-5, in bfloat16 they differ by up to
one step of the content (``bfloat16(1/255)`` is ``129/32768``, 0.39% above
``1/255``).

Both take the table :func:`pass1_window` of ``w1`` (for each source row y
and output column o, the first source column with a non-zero weight and one
past the last): the kernel reads only those rows of ``w1`` and trusts the
table (it does not check it), and the plain version checks that the table
covers every non-zero weight, then runs the dense product.
``TwoPassWarp.pass1_window`` computes it once from the weights it holds.

The kernel is the operator ``torch.ops.tti_torch.warp_pass1_decimated``
(:func:`tti_torch.kernels.build.register_op`): on CPU tensors it runs the
plain version; on CUDA tensors it launches the kernel or raises (:func:`card_geometry_error`
says which geometries it never takes). What bounds
the kernel and what its design does about it is written in
``csrc/warp_p1.cu``. The TPU kernel's ``hs % 8`` rule and its
128-column block were Mosaic's tiling and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from tti_torch.kernels.build import load_library, register_op

Tensor = torch.Tensor

# Kernel launches (plain-version calls are not counted).
LAUNCHES = {"warp_pass1_decimated": 0}

_lib: ctypes.CDLL | None = None

# The widest decimation the kernel takes: its smallest plan (2 frames per
# item, 16 source columns per chunk, two stages; plan() in csrc/warp_p1.cu)
# must fit in shared memory.
MAX_K = 283
# Rows of y per step of :func:`pass1_window` (bounds its temporaries).
_WINDOW_ROWS = 64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("warp_p1")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tti_warp_pass1_decimated.argtypes = [
            p, ctypes.c_longlong, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.tti_warp_pass1_decimated.restype = i
        _lib = lib
    return _lib


def pass1_window(w1: Tensor) -> Tensor:
    """(hs, wo, 2) int32 on ``w1``'s device: for each (y, o) the first source
    column x with ``w1[y, x, o] != 0`` and one past the last; (0, 0) for a
    column without any. Taken from the weights as they are held (after any
    rounding to their dtype)."""
    hs, ws, wo = w1.shape
    out = torch.zeros((hs, wo, 2), dtype=torch.int32, device=w1.device)
    x = torch.arange(ws, dtype=torch.int32, device=w1.device).view(1, ws, 1)
    for y0 in range(0, hs, _WINDOW_ROWS):
        rows = slice(y0, y0 + _WINDOW_ROWS)
        nz = w1[rows] != 0
        live = nz.any(1)
        out[rows, :, 0] = torch.where(live, torch.where(nz, x, ws).amin(1), 0)
        out[rows, :, 1] = torch.where(live, torch.where(nz, x + 1, 0).amax(1), 0)
    return out


def card_geometry_error(k: int, wo: int) -> str | None:
    """Why the kernel never takes the decimation ``k`` with ``wo`` output
    columns, at any batch (the TMA copy of W1 needs rows of whole 16-byte
    units; the spans of a wider k do not fit in shared memory); None when
    it does."""
    if wo % 8:
        return f"the kernel needs wo, W1's output columns, a multiple of 8, got {wo}"
    if k > MAX_K:
        return f"the kernel takes a decimation up to k={MAX_K}, got k={k}"
    return None


def check_window(w1: Tensor, window: Tensor) -> None:
    """Raise ValueError unless ``window`` covers every non-zero of ``w1``."""
    x = torch.arange(w1.shape[1], device=w1.device).view(1, -1, 1)
    lo, hi = window[..., 0].unsqueeze(1), window[..., 1].unsqueeze(1)
    if bool(((w1 != 0) & ((x < lo) | (x >= hi))).any()):
        raise ValueError("the pass-1 window misses a non-zero weight of w1")


def _check_geometry(frames_u8: Tensor, w1: Tensor, window: Tensor, k: int, off: int, hs: int,
                    ws: int) -> None:
    if frames_u8.dim() != 4 or frames_u8.shape[3] != 3:
        raise ValueError("expected 3-channel frames (B, H, W, 3)")
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"frames must be uint8, got {frames_u8.dtype}")
    _, h, w, _ = frames_u8.shape
    if k < 1 or off < 0 or hs < 1 or ws < 1:
        raise ValueError(f"bad decimation k={k}, off={off}, hs={hs}, ws={ws}")
    if off + k * (hs - 1) >= h or off + k * (ws - 1) >= w:
        raise ValueError("decimation geometry exceeds the frame")
    if w % k:
        raise ValueError("frame width must be a multiple of k")
    if w1.dim() != 3 or w1.shape[0] != hs or w1.shape[1] != ws:
        raise ValueError(f"w1 must be (hs, ws, wo) = ({hs}, {ws}, wo), got {tuple(w1.shape)}")
    if window.shape != (hs, w1.shape[2], 2) or window.dtype != torch.int32:
        raise ValueError(f"window must be (hs, wo, 2) = ({hs}, {w1.shape[2]}, 2) int32, got "
                         f"{tuple(window.shape)} {window.dtype}")


def warp_pass1_decimated_plain(frames_u8: Tensor, w1: Tensor, window: Tensor, *, k: int,
                               off: int, hs: int, ws: int, pad_value: float,
                               bgr_flip: bool = True) -> Tensor:
    """The same function in plain PyTorch: the strided slice, the flip, the
    three steps rounded to ``w1.dtype``, then the dense einsum with float32
    accumulation, rounded once to ``w1.dtype``. Returns (hs, 3, B, wo).
    Raises ValueError when ``window`` misses a non-zero of ``w1``."""
    _check_geometry(frames_u8, w1, window, k, off, hs, ws)
    check_window(w1, window)
    wdt = w1.dtype
    small = frames_u8[:, off::k, off::k, :][:, :hs, :ws, :]
    if bgr_flip:
        small = small.flip(-1)
    x = small.to(wdt) * torch.tensor(1.0 / 255.0, dtype=wdt) - torch.tensor(pad_value, dtype=wdt)
    return torch.einsum("bywc,ywo->ycbo", x.float(), w1.float()).to(wdt)


def _launch(frames_u8: Tensor, w1: Tensor, window: Tensor, k: int, off: int, hs: int, ws: int,
            pad_value: float, bgr_flip: bool) -> Tensor:
    if w1.dtype != torch.bfloat16:
        raise TypeError(f"on the card w1 must be bfloat16, got {w1.dtype}")
    for name, t in (("w1", w1), ("window", window)):
        if t.device != frames_u8.device:
            raise ValueError(f"{name} is on {t.device}, frames on {frames_u8.device}")
    for name, t in (("frames", frames_u8), ("w1", w1), ("window", window)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, w, _ = frames_u8.shape
    wo = w1.shape[2]
    why = card_geometry_error(k, wo)
    if why is not None:
        raise ValueError(why)
    if w1.data_ptr() % 16:  # what TMA can describe
        raise ValueError("the kernel needs a 16-byte aligned w1")
    if max(h, w, wo, b) >= 2 ** 31 // 8:
        raise ValueError(f"shape too large for one launch: B={b}, H={h}, W={w}, wo={wo}")
    lib = build()
    out = torch.empty((hs, 3, b, wo), dtype=torch.bfloat16, device=frames_u8.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_warp_pass1_decimated(
            frames_u8.data_ptr(), frames_u8.numel(), w1.data_ptr(), window.data_ptr(),
            out.data_ptr(), b, h, w, k, off, hs, ws, wo, float(pad_value), int(bgr_flip),
            stream)
    if err != 0:
        raise RuntimeError(f"warp pass-1 kernel launch failed: error {err}")
    LAUNCHES["warp_pass1_decimated"] += 1
    return out


def _plain_op(frames_u8: Tensor, w1: Tensor, window: Tensor, k: int, off: int, hs: int, ws: int,
              pad_value: float, bgr_flip: bool) -> Tensor:
    return warp_pass1_decimated_plain(frames_u8, w1, window, k=k, off=off, hs=hs, ws=ws,
                                      pad_value=pad_value, bgr_flip=bgr_flip)


_OP = register_op(
    "warp_pass1_decimated(Tensor frames_u8, Tensor w1, Tensor window, int k, int off, int hs, "
    "int ws, float pad_value, bool bgr_flip) -> Tensor",
    _plain_op, _launch, lambda frames_u8, w1, window, k, off, hs, ws, pad_value, bgr_flip:
    torch.empty((hs, 3, frames_u8.shape[0], w1.shape[2]), dtype=w1.dtype,
                device=frames_u8.device))


def warp_pass1_decimated(frames_u8: Tensor, w1: Tensor, window: Tensor, *, k: int, off: int,
                         hs: int, ws: int, pad_value: float, bgr_flip: bool = True) -> Tensor:
    """Kernel C: uint8 BGR frames (B, H, W, 3), dense pass-1 weights (hs,
    ws, wo) and their :func:`pass1_window` -> the pass-1 intermediate (hs, 3,
    B, wo) in ``w1.dtype``. On CPU tensors the plain version checks the
    table; on CUDA tensors the kernel trusts it, and leaves out the products
    of any non-zero weight outside it.

    ``k`` is the odd decimation stride, ``off`` its offset ``(k - 1) // 2``,
    ``hs`` x ``ws`` the decimated content that pass 1 consumes."""
    if frames_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp pass 1 runs on cpu or cuda tensors, got {frames_u8.device}")
    _check_geometry(frames_u8, w1, window, k, off, hs, ws)
    return _OP(frames_u8, w1, window, k, off, hs, ws, float(pad_value), bool(bgr_flip))
