"""A plain IVF_PQ build: coarse k-means (k-means++ seeding, Lloyd
iterations) on a sample, every row assigned to its nearest centroid, then
per-subvector k-means of the residuals and each residual coded by its
nearest codeword. Written from the algorithm, not from the port; float32
with TF32 off, or with every distance product's inputs rounded to a lower
precision (``exact.round_to``) for the control.

Returns the canonical form the comparison reads: ``centroids`` (P, D),
``block_of_row`` (N,), ``codes`` (N, S), ``codebooks`` (S, K, D/S)."""

from __future__ import annotations

import torch

from .exact import no_tf32, round_to

PRODUCT_BYTES = 1 << 30  # the largest (rows, K) f32 distance block formed at once


def _nearest(x: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    """Index of the nearest row of c (K, d) for each row of x (n, d), by
    squared L2 on inputs rounded to ``precision``, a block of rows at a time."""
    cr = round_to(c, precision)
    cn = (cr * cr).sum(1)
    step = max(1, PRODUCT_BYTES // (4 * c.shape[0]))
    out = []
    for s in range(0, x.shape[0], step):
        xr = round_to(x[s:s + step], precision)
        d = cn[None, :] - 2.0 * (xr @ cr.T)
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out)


def _kmeanspp(data: torch.Tensor, k: int, g: torch.Generator) -> torch.Tensor:
    n = data.shape[0]
    first = torch.randint(0, n, (1,), generator=g, device=data.device)
    cents = [data[first[0]]]
    d2 = ((data - cents[0]) ** 2).sum(1)
    for _ in range(1, k):
        i = torch.multinomial(d2 + 1e-30, 1, generator=g)[0]
        cents.append(data[i])
        d2 = torch.minimum(d2, ((data - data[i]) ** 2).sum(1))
    return torch.stack(cents)


def kmeans(data: torch.Tensor, k: int, iters: int, g: torch.Generator,
           precision: str = "float32") -> torch.Tensor:
    """Lloyd's k-means from k-means++ seeds; an empty cluster keeps its centroid."""
    cents = _kmeanspp(data, k, g)
    for _ in range(iters):
        a = _nearest(data, cents, precision)
        sums = torch.zeros_like(cents).index_add_(0, a, data)
        counts = torch.bincount(a, minlength=k).to(data.dtype)
        cents = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], cents)
    return cents


def build_ivf_pq(x: torch.Tensor, idx: dict, seed: int, precision: str = "float32") -> dict:
    """The reference's IVF_PQ index of rows ``x`` (N, D) f32 with the
    configuration's ``index`` parameters (num_partitions, num_sub_vectors,
    num_bits, sample_rate, max_iterations)."""
    no_tf32()
    n, dim = x.shape
    g = torch.Generator(device=x.device)
    g.manual_seed((int(seed) * 7919 + 17) & 0xFFFF_FFFF_FFFF_FFFF)
    nparts, nsub = int(idx["num_partitions"]), int(idx["num_sub_vectors"])
    kcode, iters = 1 << int(idx["num_bits"]), int(idx["max_iterations"])
    rate = int(idx["sample_rate"])
    sample = x[torch.randperm(n, generator=g, device=x.device)[: min(n, rate * nparts)]]
    cents = kmeans(sample, nparts, iters, g, precision)
    assign = _nearest(x, cents, precision)
    dsub = dim // nsub
    pq_rows = torch.randperm(n, generator=g, device=x.device)[: min(n, rate * kcode)]
    res_sample = (x[pq_rows] - cents[assign[pq_rows]]).reshape(-1, nsub, dsub)
    books = torch.stack([kmeans(res_sample[:, s].contiguous(), kcode, iters, g, precision)
                         for s in range(nsub)])
    codes = torch.empty((n, nsub), dtype=torch.long, device=x.device)
    step = 1 << 16
    for s0 in range(0, n, step):
        r = (x[s0:s0 + step] - cents[assign[s0:s0 + step]]).reshape(-1, nsub, dsub)
        for s in range(nsub):
            codes[s0:s0 + step, s] = _nearest(r[:, s], books[s], precision)
    return {"centroids": cents, "block_of_row": assign, "codes": codes, "codebooks": books,
            "misplaced": 0}
