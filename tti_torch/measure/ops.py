"""Masked, fixed-shape measurement primitives (port of ``tti.measure.ops``).

Each reduces over the last axis, so a leading frame axis is a batch.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
