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

The kernel is the operator ``torch.ops.tti_torch.warp_pass1_decimated``
(:func:`tti_torch.kernels.build.register_op`): on CPU tensors it runs the
plain version; on CUDA tensors it launches the kernel or raises. What bounds
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
            p, ctypes.c_longlong, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
        lib.tti_warp_pass1_decimated.restype = i
        _lib = lib
    return _lib


def _check_geometry(frames_u8: Tensor, w1: Tensor, k: int, off: int, hs: int, ws: int) -> None:
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


def warp_pass1_decimated_plain(frames_u8: Tensor, w1: Tensor, *, k: int, off: int, hs: int,
                               ws: int, pad_value: float, bgr_flip: bool = True) -> Tensor:
    """The same function in plain PyTorch: the strided slice, the flip, the
    three steps rounded to ``w1.dtype``, then the einsum with float32
    accumulation, rounded once to ``w1.dtype``. Returns (hs, 3, B, wo)."""
    _check_geometry(frames_u8, w1, k, off, hs, ws)
    wdt = w1.dtype
    small = frames_u8[:, off::k, off::k, :][:, :hs, :ws, :]
    if bgr_flip:
        small = small.flip(-1)
    x = small.to(wdt) * torch.tensor(1.0 / 255.0, dtype=wdt) - torch.tensor(pad_value, dtype=wdt)
    return torch.einsum("bywc,ywo->ycbo", x.float(), w1.float()).to(wdt)


def _launch(frames_u8: Tensor, w1: Tensor, k: int, off: int, hs: int, ws: int,
            pad_value: float, bgr_flip: bool) -> Tensor:
    if w1.dtype != torch.bfloat16:
        raise TypeError(f"on the card w1 must be bfloat16, got {w1.dtype}")
    if w1.device != frames_u8.device:
        raise ValueError(f"w1 is on {w1.device}, frames on {frames_u8.device}")
    for name, t in (("frames", frames_u8), ("w1", w1)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, w, _ = frames_u8.shape
    wo = w1.shape[2]
    if hs > 65535 or (b + 31) // 32 > 65535 or max(h, w, wo) >= 2 ** 31 // 8:
        raise ValueError(f"shape too large for one launch: B={b}, H={h}, W={w}, hs={hs}, wo={wo}")
    lib = build()
    out = torch.empty((hs, 3, b, wo), dtype=torch.bfloat16, device=frames_u8.device)
    if out.numel() == 0:
        return out
    vec_frames = int(frames_u8.data_ptr() % 16 == 0)
    vec_w1 = int(w1.data_ptr() % 16 == 0 and wo % 8 == 0)
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_warp_pass1_decimated(
            frames_u8.data_ptr(), frames_u8.numel(), w1.data_ptr(), out.data_ptr(), b, h, w, k,
            off, hs, ws, wo, float(pad_value), int(bgr_flip), vec_frames, vec_w1, stream)
    if err == 1:  # cudaErrorInvalidValue: the launcher found no tiling that fits
        raise ValueError(f"ws={ws} at k={k} is too wide for the kernel's shared-memory operand")
    if err != 0:
        raise RuntimeError(f"warp pass-1 kernel launch failed: cudaError {err}")
    LAUNCHES["warp_pass1_decimated"] += 1
    return out


def _plain_op(frames_u8: Tensor, w1: Tensor, k: int, off: int, hs: int, ws: int,
              pad_value: float, bgr_flip: bool) -> Tensor:
    return warp_pass1_decimated_plain(frames_u8, w1, k=k, off=off, hs=hs, ws=ws,
                                      pad_value=pad_value, bgr_flip=bgr_flip)


_OP = register_op(
    "warp_pass1_decimated(Tensor frames_u8, Tensor w1, int k, int off, int hs, int ws, "
    "float pad_value, bool bgr_flip) -> Tensor",
    _plain_op, _launch, lambda frames_u8, w1, k, off, hs, ws, pad_value, bgr_flip:
    torch.empty((hs, 3, frames_u8.shape[0], w1.shape[2]), dtype=w1.dtype,
                device=frames_u8.device))


def warp_pass1_decimated(frames_u8: Tensor, w1: Tensor, *, k: int, off: int, hs: int, ws: int,
                         pad_value: float, bgr_flip: bool = True) -> Tensor:
    """Kernel C: uint8 BGR frames (B, H, W, 3) and dense pass-1 weights
    (hs, ws, wo) -> the pass-1 intermediate (hs, 3, B, wo) in ``w1.dtype``.

    ``k`` is the odd decimation stride, ``off`` its offset ``(k - 1) // 2``,
    ``hs`` x ``ws`` the decimated content that pass 1 consumes."""
    if frames_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp pass 1 runs on cpu or cuda tensors, got {frames_u8.device}")
    _check_geometry(frames_u8, w1, k, off, hs, ws)
    return _OP(frames_u8, w1, k, off, hs, ws, float(pad_value), bool(bgr_flip))
