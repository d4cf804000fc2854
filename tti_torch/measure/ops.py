"""Masked, fixed-shape measurement primitives (port of ``tti.measure.ops``).

Each reduces over the last axis (a mask's last two), so leading axes are a
batch of frames. The dense-mask primitives (the envelopes, the edge mask,
the nearest edge pixels, the stitch statistics and the envelope sampling)
are ``tti``'s public helpers, which no step calls: the step reads the
envelope and the stitches from the mask statistics kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

ENVELOPE_EMPTY = -1  # a column without fabric


def _first_true(x: Tensor, dim: int) -> Tensor:
    """Index of the first True along ``dim`` (0 where none): ``argmax``
    takes no bool and returns the first of equal maxima."""
    return torch.argmax(x.to(torch.uint8), dim=dim)


def fabric_lower_envelope(fabric_mask: Tensor) -> Tensor:
    """Bottom-most fabric row per column, -1 where the column is empty.
    fabric_mask (..., H, W) bool or float; returns (..., W) int32."""
    h = fabric_mask.shape[-2]
    m = fabric_mask > 0
    env = h - 1 - _first_true(m.flip(-2), -2)
    return torch.where(m.any(-2), env, ENVELOPE_EMPTY).to(torch.int32)


def fabric_upper_envelope(fabric_mask: Tensor) -> Tensor:
    """Top-most fabric row per column, -1 where empty; (..., H, W) ->
    (..., W) int32."""
    m = fabric_mask > 0
    return torch.where(m.any(-2), _first_true(m, -2), ENVELOPE_EMPTY).to(torch.int32)


def fabric_edge_mask(fabric_mask: Tensor) -> Tensor:
    """Fabric pixels with at least one 4-neighbour outside the mask (the
    frame's border counts as outside); (..., H, W) -> (..., H, W) bool."""
    m = fabric_mask > 0
    pad = F.pad(m.to(torch.uint8), (1, 1, 1, 1)) > 0
    interior = (pad[..., :-2, 1:-1] & pad[..., 2:, 1:-1]
                & pad[..., 1:-1, :-2] & pad[..., 1:-1, 2:])
    return m & ~interior


def nearest_edge_candidates(edge_mask: Tensor, cx, cy, k: int = 20
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The ``k`` edge pixels nearest to ``(cx, cy)``, nearest first; equal
    distances in row-major order (``lax.top_k`` keeps the lower index first:
    a stable sort here). edge_mask (..., H, W); cx, cy scalars or (...,).
    Returns ``(ys, xs, dist, valid)``, each (..., k): past the number of
    edge pixels ys and xs are 0, dist +inf, valid False. ``k`` above H * W
    raises ``ValueError``."""
    h, w = edge_mask.shape[-2], edge_mask.shape[-1]
    if k > h * w:
        raise ValueError(f"k = {k} exceeds the {h * w} pixels of a {h}x{w} mask")
    dev = edge_mask.device
    cx = torch.as_tensor(cx, dtype=torch.float32, device=dev)[..., None, None]
    cy = torch.as_tensor(cy, dtype=torch.float32, device=dev)[..., None, None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    d2 = torch.where(edge_mask > 0, d2, torch.inf)
    d2 = d2.reshape(*d2.shape[:-2], h * w)
    near, idx = torch.sort(d2, dim=-1, stable=True)
    near, idx = near[..., :k], idx[..., :k]
    dist = torch.sqrt(near.double()).float()  # IEEE-rounded; PyTorch's float32 CPU sqrt is not
    valid = torch.isfinite(dist)
    zero = torch.zeros_like(idx)
    return (torch.where(valid, idx // w, zero).to(torch.int32),
            torch.where(valid, idx % w, zero).to(torch.int32), dist, valid)


def masked_median(values: Tensor, mask: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    """Median of the masked-in entries (numpy semantics: mean of the two
    middles for even counts). Returns (median, any_valid); invalid -> 0.0."""
    big = torch.finfo(torch.float32).max
    sorted_vals = torch.sort(torch.where(mask, values, big), dim=dim).values
    n = mask.sum(dim)
    any_valid = n > 0
    n_safe = torch.clamp(n, min=1)
    lo = torch.gather(sorted_vals, dim, ((n_safe - 1) // 2).unsqueeze(dim)).squeeze(dim)
    hi = torch.gather(sorted_vals, dim, (n_safe // 2).unsqueeze(dim)).squeeze(dim)
    return torch.where(any_valid, 0.5 * (lo + hi), 0.0), any_valid


def masked_mean(values: Tensor, mask: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    n = mask.sum(dim)
    s = torch.where(mask, values, 0.0).sum(dim)
    return s / torch.clamp(n, min=1), n > 0


def kmeans_1d_two_clusters(values: Tensor, valid: Tensor, iters: int = 10
                           ) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """Masked 1-D 2-means over the last axis with a fixed iteration count
    (extra iterations past convergence are no-ops). A degenerate split
    keeps the previous centers. Returns (labels int32 in {0,1}, (c0, c1));
    invalid rows get label 0."""
    big = 1e9
    c0 = torch.where(valid, values, big).amin(-1, keepdim=True)
    c1 = torch.where(valid, values, -big).amax(-1, keepdim=True)
    for _ in range(iters):
        labels = (torch.abs(values - c1) < torch.abs(values - c0)) & valid
        rest = valid & ~labels
        n1 = labels.sum(-1, keepdim=True)
        n0 = rest.sum(-1, keepdim=True)
        new_c0 = torch.where(rest, values, 0.0).sum(-1, keepdim=True) / torch.clamp(n0, min=1)
        new_c1 = torch.where(labels, values, 0.0).sum(-1, keepdim=True) / torch.clamp(n1, min=1)
        keep = (n1 == 0) | (n0 == 0)
        c0 = torch.where(keep, c0, new_c0)
        c1 = torch.where(keep, c1, new_c1)
    labels = ((torch.abs(values - c1) < torch.abs(values - c0)) & valid).to(torch.int32)
    return labels, (c0.squeeze(-1), c1.squeeze(-1))


def stitch_stats(masks: Tensor, boxes: Tensor, valid: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Per instance: the centroid from the mask's moments (m10/m00,
    m01/m00), the occupied columns' first and last, each falling back to
    the box where the mask is empty. masks (..., N, H, W) binary, boxes
    (..., N, 4) xyxy on the same grid, valid (..., N). Returns (cx, cy,
    left, right, has_mask), each (..., N), grid coordinates."""
    m = (masks > 0).to(torch.float32)
    h, w = m.shape[-2], m.shape[-1]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)
    ys = torch.arange(h, dtype=torch.float32, device=m.device)
    m00 = m.sum((-2, -1))
    m10 = (m * xs).sum((-2, -1))
    m01 = (m * ys[:, None]).sum((-2, -1))
    has_mask = (m00 > 1e-6) & valid
    denom = torch.clamp(m00, min=1e-6)
    col_any = m.amax(-2) > 0  # (..., N, W)
    left_m = _first_true(col_any, -1).to(torch.float32)
    right_m = (w - 1 - _first_true(col_any.flip(-1), -1)).to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return (torch.where(has_mask, m10 / denom, 0.5 * (x1 + x2)),
            torch.where(has_mask, m01 / denom, 0.5 * (y1 + y2)),
            torch.where(has_mask, left_m, x1), torch.where(has_mask, right_m, x2), has_mask)


def sample_envelope(envelope: Tensor, cx: Tensor, neighborhood_cols: Tensor
                    ) -> tuple[Tensor, Tensor]:
    """Median envelope height around each centroid column: the envelope at
    ``round(cx) + offsets`` (half to even, clipped to the row), the median
    over the columns that have fabric. envelope (..., W) int32 with -1
    sentinels; cx (..., N) float; neighborhood_cols (K,) int offsets.
    Returns (env_y (..., N) float32, has_env (..., N) bool)."""
    w = envelope.shape[-1]
    cols = torch.clamp(torch.round(cx).to(torch.int64)[..., None]
                       + neighborhood_cols.to(torch.int64), 0, w - 1)  # (..., N, K)
    vals = torch.gather(envelope[..., None, :].expand(*cols.shape[:-1], w), -1, cols)
    vals = vals.to(torch.float32)
    return masked_median(vals, vals >= 0)
