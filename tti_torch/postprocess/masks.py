"""Mask assembly: prototypes x coefficients -> instance masks at proto
resolution (port of ``assemble_masks``, ``crop_masks`` and ``mask_iou`` of
``tti.postprocess.masks``).

Measurement never materialises masks (see ``tti_torch.kernels.maskstats``);
these are for rendering, parity checks and ``return_masks``. Boxes arrive in
model-input pixels; proto space is input / stride, so crop bounds scale by
(Hm / inp_h, Wm / inp_w). The functions take a leading batch dimension or
none.
"""

from __future__ import annotations

import torch

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


def assemble_masks(protos: Tensor, coefs: Tensor, boxes_input_px: Tensor, valid: Tensor,
                   input_hw: tuple[int, int], threshold: float | None = 0.5) -> Tensor:
    """Instance masks at proto resolution. protos (..., Hm, Wm, nm); coefs
    (..., N, nm); boxes_input_px (..., N, 4) xyxy in model-input pixels;
    valid (..., N). Returns (..., N, Hm, Wm) float32: sigmoid probabilities,
    or binarized when ``threshold`` is given. Invalid rows are zero."""
    hm, wm = protos.shape[-3], protos.shape[-2]
    probs = torch.sigmoid(torch.einsum("...nc,...hwc->...nhw", coefs.float(), protos.float()))
    scale = probs.new_tensor([wm / input_hw[1], hm / input_hw[0],
                              wm / input_hw[1], hm / input_hw[0]])
    probs = crop_masks(probs, boxes_input_px.float() * scale)
    if threshold is not None:
        probs = (probs > threshold).to(probs.dtype)
    return probs * valid[..., None, None].to(probs.dtype)


def mask_iou(a: Tensor, b: Tensor, eps: float = 1e-9) -> Tensor:
    """IoU between two binary masks of equal shape."""
    a, b = a > 0.5, b > 0.5
    return (a & b).sum() / torch.clamp((a | b).sum().float(), min=eps)
