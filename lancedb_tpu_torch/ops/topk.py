"""Top-k selection (smallest distances first).

Selection is exact: the reference's approximate tier
(``lax.approx_max_k``) is approximate only on the TPU, so the port has
one exact selector and no approximate one. It is a stable sort, so equal
values come out lower index first, the order ``lax.top_k`` gives; that
matters where duplicate-centroid IVF blocks tie in probe selection.
``blocked_topk_scan`` keeps a running k-best over a blocked scan, so its
memory is O(Q·block) rather than O(Q·N).
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


def blocked_topk_scan(score_block, num_blocks: int, k: int, q_rows: int, exact: bool = True,
                      recall_target: float = 0.99) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over a blocked scan (the reference's
    blocked_topk_scan): ``score_block(i) -> (dists (Q, B), ids (Q, B) or
    (B,))`` computes block ``i``'s distances, and a running k-best is
    merged with each block's k smallest. Ties go to the lower index:
    within a block the earlier column, across blocks the earlier block.
    Rows short of k hits keep distance INF and id -1. ``exact=False`` and
    ``recall_target`` are accepted for the reference's signature, whose
    approximate tier is approximate only on the TPU; the result here is
    the exact one either way."""
    del exact, recall_target
    best_vals = best_ids = None
    for i in range(num_blocks):
        dists, ids = score_block(i)
        blk_vals, blk_pos = topk_smallest(dists, k)
        if ids.ndim == 1:
            blk_ids = ids[blk_pos]
        else:
            blk_ids = torch.gather(ids, -1, blk_pos)
        if best_vals is None:
            best_vals = torch.full((q_rows, k), INF, dtype=torch.float32, device=dists.device)
            best_ids = torch.full((q_rows, k), -1, dtype=torch.int64, device=dists.device)
        best_vals, best_ids = merge_topk(best_vals, best_ids, blk_vals.to(torch.float32),
                                         blk_ids.to(torch.int64), k)
    if best_vals is None:
        return (torch.full((q_rows, k), INF, dtype=torch.float32),
                torch.full((q_rows, k), -1, dtype=torch.int64))
    return best_vals, best_ids


def mask_and_topk(
    dists: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k with an invalid-row mask: invalid entries get +inf."""
    return topk_smallest(torch.where(valid, dists, torch.full_like(dists, INF)), k)
