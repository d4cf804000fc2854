"""Mask assembly: prototypes x coefficients -> instance masks (port of
``tti.postprocess.masks``).

Measurement never materialises masks (see ``tti_torch.kernels.maskstats``);
these are for rendering, parity checks, ``return_masks`` and the predict
chain (``tti_torch.app.predict``), which upsamples them to the model input
as Ultralytics' ``process_mask(upsample=True)`` does and resizes them to
the frame as cv2's INTER_NEAREST does. Boxes arrive in
model-input pixels; proto space is input / stride, so crop bounds scale by
(Hm / inp_h, Wm / inp_w). The functions take a leading batch dimension or
none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tti_torch.preprocess.letterbox import map_xyxy

Tensor = torch.Tensor


def crop_masks(masks: Tensor, boxes: Tensor) -> Tensor:
    """Zero mask values outside each instance's box. masks (..., N, H, W);
    boxes (..., N, 4) xyxy in mask pixel coordinates."""
    h, w = masks.shape[-2], masks.shape[-1]
    rows = torch.arange(h, dtype=boxes.dtype, device=boxes.device).view(1, h, 1)
    cols = torch.arange(w, dtype=boxes.dtype, device=boxes.device).view(1, 1, w)
    x1, y1, x2, y2 = (boxes[..., i:i + 1, None] for i in range(4))
    inside = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return masks * inside


def _frame_probs(protos: Tensor, coefs: Tensor) -> Tensor:
    """``sigmoid(coefs . protos)`` in float32: protos (..., Hm, Wm, nm),
    coefs (..., N, nm) -> (..., N, Hm, Wm). One product and one sigmoid per
    frame, so that a frame's values are the same bits in any batch: a
    batched product lets the library block each frame's sum by the batch's
    shape (on the CPU, MKL splits a batch of two over its threads and sums
    otherwise than for one frame), and PyTorch's CPU loop takes a tensor's
    last few elements through the scalar ``exp``, the rest through the
    vector one."""
    hm, wm, nm = protos.shape[-3:]
    c = coefs.float().reshape(-1, coefs.shape[-2], nm)
    p = protos.float().reshape(-1, hm * wm, nm)
    probs = torch.stack([torch.sigmoid(ci @ pi.T) for ci, pi in zip(c, p)])
    return probs.reshape(*coefs.shape[:-1], hm, wm)


def assemble_masks(protos: Tensor, coefs: Tensor, boxes_input_px: Tensor, valid: Tensor,
                   input_hw: tuple[int, int], threshold: float | None = 0.5) -> Tensor:
    """Instance masks at proto resolution. protos (..., Hm, Wm, nm); coefs
    (..., N, nm); boxes_input_px (..., N, 4) xyxy in model-input pixels;
    valid (..., N). Returns (..., N, Hm, Wm) float32: sigmoid probabilities,
    or binarized when ``threshold`` is given. Invalid rows are zero."""
    hm, wm = protos.shape[-3], protos.shape[-2]
    probs = _frame_probs(protos, coefs)
    sx, sy = wm / input_hw[1], hm / input_hw[0]
    probs = crop_masks(probs, map_xyxy(boxes_input_px.float(), lambda x: x * sx,
                                       lambda y: y * sy))
    if threshold is not None:
        probs = (probs > threshold).to(probs.dtype)
    return probs * valid[..., None, None].to(probs.dtype)


def upsample_masks(masks: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """(..., Hm, Wm) -> (..., out_h, out_w) bilinear with half-pixel centres,
    as ``jax.image.resize`` does (an upsample reads the edge cell past the
    border, as jax's renormalised dropped taps do)."""
    lead, (h, w) = masks.shape[:-2], masks.shape[-2:]
    y = F.interpolate(masks.reshape(-1, 1, h, w), size=out_hw, mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, *out_hw)


def masks_at_input(protos: Tensor, coefs: Tensor, boxes_input_px: Tensor, valid: Tensor,
                   input_hw: tuple[int, int]) -> Tensor:
    """Instance masks at model-input resolution with Ultralytics
    ``process_mask(..., upsample=True)`` semantics: sigmoid(coef . proto),
    crop at proto resolution with the boxes scaled by (Wm/W, Hm/H), bilinear
    upsample of the probabilities to the input size, then > 0.5. Returns
    (..., N, H, W) float32 binary masks."""
    probs = assemble_masks(protos, coefs, boxes_input_px, valid, input_hw, threshold=None)
    return (upsample_masks(probs, input_hw) > 0.5).float()


def resize_nearest_cv2(masks: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """cv2.resize(..., INTER_NEAREST) on (..., H, W) masks: source index
    floor(dst * src/dst) in float64, as cv2 and ``tti``'s
    ``Predictor.masks_to_frame`` compute it (not the half-pixel rounding of
    ``upsample_masks``)."""
    h, w = masks.shape[-2], masks.shape[-1]
    oh, ow = out_hw

    def index(n_out: int, n_in: int) -> Tensor:
        pos = torch.arange(n_out, dtype=torch.float64) * (n_in / n_out)
        return torch.clamp(torch.floor(pos).long(), 0, n_in - 1).to(masks.device)

    return masks[..., index(oh, h)[:, None], index(ow, w)[None, :]]


def masks_at_frame(protos: Tensor, coefs: Tensor, boxes_input_px: Tensor, valid: Tensor,
                   input_hw: tuple[int, int], frame_hw: tuple[int, int]) -> Tensor:
    """The reference's mask chain at frame resolution: :func:`masks_at_input`,
    then cv2's INTER_NEAREST resize to the frame (:func:`resize_nearest_cv2`,
    its float64 index map). Returns (..., N, frame_h, frame_w) float32 binary
    masks."""
    return resize_nearest_cv2(masks_at_input(protos, coefs, boxes_input_px, valid, input_hw),
                              frame_hw)


def mask_iou(a: Tensor, b: Tensor, eps: float = 1e-9) -> Tensor:
    """IoU between two binary masks of equal shape."""
    a, b = a > 0.5, b > 0.5
    return (a & b).sum() / torch.clamp((a | b).sum().float(), min=eps)
