"""Product quantization: codebook training and the fused encode + |x̂|².

Port of the reference's ops/pq.py build path. Codebooks are trained by
one batched k-means over all subvectors (the reference vmaps the same
Lloyd program), and encoding is one batched product per row chunk.

OPQ (``opq_train``) and the capacity modes of the build (raw-vector
encode, bf16 residuals) wait for a later slice (ROADMAP A3).
"""

from __future__ import annotations

import torch

from .kmeans import kmeans_fit_device, kmeanspp_init_device
from .util import lowp


def default_num_sub_vectors(dim: int) -> int:
    """Reference default: dim/16 if divisible, else dim/8, else 1."""
    if dim % 16 == 0:
        return dim // 16
    if dim % 8 == 0:
        return dim // 8
    return 1


def _encode_rnorms_device(
    residuals: torch.Tensor,
    cents: torch.Tensor,
    assign: torch.Tensor,
    codebooks: torch.Tensor,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused encode + reconstruct + |x̂|², blocked over row chunks.

    residuals: (N, D); cents: (P, D); assign: (N,) int; codebooks:
    (S, K, dsub) f32. Returns (codes (N, S) uint8, rnorms (N,) f32) with
    rnorms = |c_assign + r̂|². Like the reference, the code search and
    the reconstruction use codebooks rounded to ``matmul_dtype``."""
    n, d = residuals.shape
    nsub, kcode, dsub = codebooks.shape
    cb = codebooks.float()
    cb_lp = lowp(cb)
    cn2 = torch.sum(torch.square(cb), dim=-1)  # (S, K)
    sub_ids = torch.arange(nsub, device=cb.device)
    codes = torch.empty((n, nsub), dtype=torch.uint8, device=residuals.device)
    rnorms = torch.empty(n, dtype=torch.float32, device=residuals.device)
    for s in range(0, n, chunk):
        xs = residuals[s : s + chunk].float().reshape(-1, nsub, dsub)  # (c, S, dsub)
        dots = torch.einsum("csd,skd->csk", lowp(xs), cb_lp)
        c = torch.argmin(cn2[None] - 2.0 * dots, dim=-1)  # (c, S)
        recon = cb_lp[sub_ids[None, :], c].reshape(-1, d)
        asg = assign[s : s + chunk].long()
        xhat = recon + cents[asg]
        codes[s : s + chunk] = c.to(torch.uint8)
        rnorms[s : s + chunk] = torch.sum(torch.square(xhat), dim=-1)
    return codes, rnorms


def pq_build_device(
    residuals: torch.Tensor,
    cents: torch.Tensor,
    assign: torch.Tensor,
    sel: torch.Tensor,
    pool_sel: torch.Tensor,
    generator: torch.Generator,
    reseed: torch.Tensor,
    *,
    nsub: int,
    kcode: int,
    max_iters: int = 50,
    chunk: int = 1 << 17,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PQ stage: codebook-sample gather → per-subvector k-means++ and
    Lloyd (batched over subvectors) → fused encode + |x̂|².

    residuals: (N, D) f32 on the device; cents: (P, D) f32; assign: (N,);
    sel: (n_train,) training-row ids; pool_sel: (n_pool,) ids into the
    training sample for seeding; reseed: (max_iters, kcode), shared by
    the subvectors. Returns (codebooks (S, K, dsub) f32, codes (N, S)
    uint8, rnorms (N,) f32)."""
    dev = residuals.device
    d = residuals.shape[1]
    dsub = d // nsub
    sample = residuals[sel.to(device=dev, dtype=torch.long)].float()
    subs = sample.reshape(-1, nsub, dsub).transpose(0, 1).contiguous()  # (S, n, dsub)
    pools = subs[:, pool_sel.to(device=dev, dtype=torch.long)]
    inits = kmeanspp_init_device(pools, generator, k=kcode)
    codebooks, _ = kmeans_fit_device(subs, inits, reseed, k=kcode, max_iters=max_iters, metric="l2")
    codes, rnorms = _encode_rnorms_device(residuals, cents, assign, codebooks, chunk=chunk)
    return codebooks, codes, rnorms
