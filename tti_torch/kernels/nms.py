"""Greedy NMS suppression on the card: a hand-written CUDA kernel and its
plain PyTorch version.

:func:`greedy_keep` (kernel D) computes what the reference's device
``while_loop`` reaches (``tti.postprocess.nms._greedy_suppress``): over
score-sorted candidates, ``keep_i = ok_i and no j < i with keep_j and
overlaps(i, j)``, where ``overlaps`` is the class-masked IoU above the
threshold. That keep-set is the unique fixed point of the reference's sweep,
so the kernel walks the ranks once instead of sweeping, and the step reads
nothing back to the host.

The kernel is the operator ``torch.ops.tti_torch.greedy_keep``
(:func:`tti_torch.kernels.build.register_op`): on a CPU tensor it runs the
plain version, the reference's sweep to its fixed point; on a CUDA tensor it
launches the kernel or raises. What bounds the kernel and what its design
does about it is written in ``csrc/nms.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from tti_torch.kernels.build import load_library, register_op

Tensor = torch.Tensor

# Kernel launches (plain-version calls are not counted).
LAUNCHES = {"greedy_keep": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("nms")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tti_greedy_keep.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
        lib.tti_greedy_keep.restype = i
        lib.tti_greedy_keep_scratch_words.argtypes = [i]
        lib.tti_greedy_keep_scratch_words.restype = i
        lib.tti_greedy_keep_max_k.restype = i
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain version (CPU path and test oracle)
# ---------------------------------------------------------------------------


def box_iou_matrix(boxes: Tensor) -> Tensor:
    """Pairwise IoU of (..., K, 4) xyxy boxes -> (..., K, K)."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def suppression_matrix(cand_boxes: Tensor, cand_classes: Tensor, iou_thresh: float,
                       class_aware: bool = True) -> Tensor:
    """(B, K, K) bool: [b, i, j] when candidate j outranks i and overlaps it."""
    k = cand_boxes.shape[1]
    iou = box_iou_matrix(cand_boxes)
    if class_aware:
        iou = torch.where(cand_classes[:, :, None] == cand_classes[:, None, :], iou, 0.0)
    tri = torch.ones(k, k, dtype=torch.bool, device=iou.device).tril(-1)  # j < i
    return (iou > iou_thresh) & tri


def sweep(blocked_by: Tensor, cand_ok: Tensor, keep: Tensor) -> Tensor:
    """keep_i <- ok_i & no kept higher-ranked box overlaps i."""
    return cand_ok & ~(blocked_by & keep[:, None, :]).any(-1)


def greedy_keep_plain(cand_boxes: Tensor, cand_classes: Tensor, cand_ok: Tensor,
                      iou_thresh: float, class_aware: bool = True) -> Tensor:
    """The same keep-set in plain PyTorch: the reference's sweep from
    ``keep = ok`` to its fixed point, at most K sweeps (position i is final
    after i + 1), with a host check after each. It is the operator's CPU
    implementation: a trace records the operator and never enters this
    data-dependent loop."""
    blocked_by = suppression_matrix(cand_boxes, cand_classes, iou_thresh, class_aware)
    keep = cand_ok
    for _ in range(cand_boxes.shape[1]):
        new = sweep(blocked_by, cand_ok, keep)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _check(cand_boxes: Tensor, cand_classes: Tensor, cand_ok: Tensor) -> None:
    if cand_boxes.dim() != 3 or cand_boxes.shape[2] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(cand_boxes.shape)}")
    if cand_classes.shape != cand_boxes.shape[:2] or cand_ok.shape != cand_boxes.shape[:2]:
        raise ValueError(f"classes {tuple(cand_classes.shape)} and ok {tuple(cand_ok.shape)} "
                         f"must be (B, K) = {tuple(cand_boxes.shape[:2])}")
    if cand_ok.dtype != torch.bool:
        raise TypeError(f"ok must be bool, got {cand_ok.dtype}")


def _launch(cand_boxes: Tensor, cand_classes: Tensor, cand_ok: Tensor, iou_thresh: float,
            class_aware: bool) -> Tensor:
    if cand_boxes.dtype != torch.float32:
        raise TypeError(f"on the card boxes must be float32, got {cand_boxes.dtype}")
    if cand_classes.dtype != torch.int32:
        raise TypeError(f"on the card classes must be int32, got {cand_classes.dtype}")
    for name, t in (("boxes", cand_boxes), ("classes", cand_classes), ("ok", cand_ok)):
        if t.device != cand_boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {cand_boxes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, k = cand_ok.shape
    lib = build()
    keep = torch.empty((b, k), dtype=torch.bool, device=cand_boxes.device)
    if keep.numel() == 0:
        return keep
    if b > 2 ** 31 - 1 or k > lib.tti_greedy_keep_max_k():
        raise ValueError(f"shape too large for one launch: B={b}, K={k} "
                         f"(at most {lib.tti_greedy_keep_max_k()} candidates)")
    words = lib.tti_greedy_keep_scratch_words(k)
    scratch = (torch.empty((b, words), dtype=torch.int32, device=cand_boxes.device)
               if words else None)
    with torch.cuda.device(cand_boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_greedy_keep(
            cand_boxes.data_ptr(), cand_classes.data_ptr(), cand_ok.data_ptr(), keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, k, float(iou_thresh),
            int(class_aware), stream)
    if err != 0:
        raise RuntimeError(f"greedy-keep kernel launch failed: cudaError {err}")
    LAUNCHES["greedy_keep"] += 1
    return keep


def _plain_op(cand_boxes: Tensor, cand_classes: Tensor, cand_ok: Tensor, iou_thresh: float,
              class_aware: bool) -> Tensor:
    keep = greedy_keep_plain(cand_boxes, cand_classes, cand_ok, iou_thresh, class_aware)
    return keep.clone() if keep is cand_ok else keep  # an operator's output is its own


_OP = register_op(
    "greedy_keep(Tensor cand_boxes, Tensor cand_classes, Tensor cand_ok, float iou_thresh, "
    "bool class_aware) -> Tensor",
    _plain_op, _launch, lambda cand_boxes, cand_classes, cand_ok, iou_thresh, class_aware:
    torch.empty(cand_ok.shape, dtype=torch.bool, device=cand_ok.device))


def greedy_keep(cand_boxes: Tensor, cand_classes: Tensor, cand_ok: Tensor,
                iou_thresh: float, class_aware: bool = True) -> Tensor:
    """Kernel D: score-sorted candidate boxes (B, K, 4) float32 xyxy, their
    classes (B, K) int32 and validity (B, K) bool -> the greedy keep-set
    (B, K) bool. ``class_aware``: only boxes of one class suppress each
    other."""
    _check(cand_boxes, cand_classes, cand_ok)
    if cand_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy keep runs on cpu or cuda tensors, got {cand_boxes.device}")
    return _OP(cand_boxes, cand_classes, cand_ok, float(iou_thresh), bool(class_aware))
