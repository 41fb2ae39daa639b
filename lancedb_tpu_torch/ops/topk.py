"""Top-k selection (smallest distances first).

Selection is exact: the reference's approximate tier
(``lax.approx_max_k``) is approximate only on the TPU, so the port has
one exact selector and no approximate one. It is a stable sort, so equal
values come out lower index first, the order ``lax.top_k`` gives; that
matters where duplicate-centroid IVF blocks tie in probe selection.
"""

from __future__ import annotations

import torch

from .util import INF


def topk_smallest(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest along the last axis → (values, indices int64)."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor, vals_b: torch.Tensor, idx_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (…, k') candidate sets into the k smallest."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    v, pos = topk_smallest(vals, k)
    return v, torch.gather(idx, -1, pos)


def mask_and_topk(
    dists: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k with an invalid-row mask: invalid entries get +inf."""
    return topk_smallest(torch.where(valid, dists, torch.full_like(dists, INF)), k)
