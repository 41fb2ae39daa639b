"""Batched k-means (Lloyd) for the IVF coarse quantizer and the PQ codebooks.

Port of the reference's ops/kmeans.py. Both halves of a Lloyd iteration
are tensor ops: the assignment is one (N, D)x(D, K) product in
``matmul_dtype`` plus an argmin; the update sums rows per cluster in f32
(``index_add_``, the one-hot product of the reference). Empty clusters
are reseeded from the host-drawn rows in ``reseed_rows``.

Every function takes a leading batch axis where the reference vmaps
(one k-means per PQ subvector), and the unbatched form is a batch of
one. The random draws of k-means++ come from an explicit
``torch.Generator``; they are not the reference's ``jax.random`` bits,
so builds are compared by recall, not bit for bit.
"""

from __future__ import annotations

import torch

from .distance import normalize_metric
from .util import lowp


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)


def _assign(x_lp: torch.Tensor, x_n2: torch.Tensor, cents: torch.Tensor, metric: str) -> torch.Tensor:
    """Nearest-centroid ids. x_lp: (B, N, D) rounded to matmul_dtype;
    x_n2: (B, N) f32 |x|^2; cents: (B, K, D) f32 → (B, N) int64."""
    dots = torch.bmm(x_lp, lowp(cents).transpose(1, 2))  # (B, N, K)
    if metric in ("cosine", "dot"):
        # spherical: centroids renormalized each iteration → argmax dot
        return torch.argmax(dots, dim=-1)
    cn2 = torch.sum(torch.square(cents), dim=-1)  # (B, K)
    d = x_n2[:, :, None] - 2.0 * dots + cn2[:, None, :]
    return torch.argmin(d, dim=-1)


def _update(x_lp: torch.Tensor, assign: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums (B, K, D) f32 and counts (B, K) f32."""
    b, n, d = x_lp.shape
    flat = (assign + torch.arange(b, device=assign.device)[:, None] * k).reshape(-1)
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=x_lp.device)
    sums.index_add_(0, flat, x_lp.reshape(-1, d))
    counts = torch.bincount(flat, minlength=b * k).float()
    return sums.reshape(b, k, d), counts.reshape(b, k)


def kmeans_fit_device(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    reseed_rows: torch.Tensor,
    k: int,
    max_iters: int = 50,
    metric: str = "l2",
    tol: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations. x: (N, D) or (B, N, D); init_centroids: (K, D)
    or (B, K, D); reseed_rows: (max_iters, K) int row ids shared by the
    batch. Returns (centroids f32, final assignment int32), each with the
    batch axis only if the input had one.

    The reference runs all ``max_iters`` steps under ``lax.scan`` and
    freezes a converged batch member; here the loop freezes the same way
    and stops once every member has converged, which gives the same
    centroids."""
    batched = x.dim() == 3
    if not batched:
        x, init_centroids = x[None], init_centroids[None]
    spherical = metric in ("cosine", "dot")
    xf = x.float()
    if spherical:
        xf = _normalize_rows(xf)
    x_lp = lowp(xf)
    x_n2 = torch.sum(torch.square(xf), dim=-1)
    reseed_rows = reseed_rows.to(device=x.device, dtype=torch.long)

    def renorm(c):
        return _normalize_rows(c) if spherical else c

    cents = renorm(init_centroids.float())
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for it in range(max_iters):
        assign = _assign(x_lp, x_n2, cents, metric)
        sums, counts = _update(x_lp, assign, k)
        new = sums / torch.clamp(counts[:, :, None], min=1.0)
        reseed = xf[:, reseed_rows[it]]  # (B, K, D)
        new = renorm(torch.where((counts > 0)[:, :, None], new, reseed))
        shift = torch.amax(torch.sum(torch.square(new - cents), dim=-1), dim=-1)
        cents = torch.where(done[:, None, None], cents, new)
        done = done | (shift < tol)
        if bool(done.all()):
            break
    final_assign = _assign(x_lp, x_n2, cents, metric).to(torch.int32)
    if not batched:
        return cents[0], final_assign[0]
    return cents, final_assign


def kmeanspp_init_device(x: torch.Tensor, generator: torch.Generator, k: int) -> torch.Tensor:
    """k-means++ seeding. x: (N, D) or (B, N, D) → (K, D) or (B, K, D).

    Each step extends the running min-distance with the newest centroid
    and samples the next one ∝ D² with the Gumbel-max trick, drawing the
    first index and the Gumbel noise from ``generator``."""
    batched = x.dim() == 3
    if not batched:
        x = x[None]
    b, n, _ = x.shape
    dev = x.device
    xf = x.float()
    x_n2 = torch.sum(torch.square(xf), dim=-1)  # (B, N)
    rows = torch.arange(b, device=dev)
    idx = torch.randint(0, n, (b,), generator=generator, device=dev)
    min_d2 = torch.full((b, n), float("inf"), device=dev)
    picks = []
    for _ in range(k):
        picks.append(idx)
        c = xf[rows, idx]  # (B, D)
        d2 = x_n2 - 2.0 * torch.bmm(xf, c[:, :, None])[..., 0] + torch.sum(torch.square(c), -1)[:, None]
        min_d2 = torch.minimum(min_d2, torch.clamp(d2, min=0.0))
        logits = torch.where(
            min_d2 > 0, torch.log(torch.clamp(min_d2, min=1e-30)),
            torch.full_like(min_d2, float("-inf")),
        )
        u = torch.rand((b, n), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
        idx = torch.argmax(logits + gumbel, dim=-1)
    out = xf[rows[:, None], torch.stack(picks, dim=1)]  # (B, K, D)
    return out if batched else out[0]


def assign_residuals_device(
    x: torch.Tensor,
    cents: torch.Tensor,
    metric: str = "l2",
    chunk: int = 1 << 17,
    with_residuals: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Blocked assignment (+ f32 residuals) of every row of x (N, D):
    the (chunk, K) distance transient stays bounded. Returns (assign
    (N,) int32, residuals (N, D) f32 or None)."""
    n = x.shape[0]
    spherical = metric in ("cosine", "dot")
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    residuals = (
        torch.empty((n, x.shape[1]), dtype=torch.float32, device=x.device)
        if with_residuals else None
    )
    for s in range(0, n, chunk):
        xc = x[s : s + chunk].float()
        if spherical:
            xc = _normalize_rows(xc)
        a = _assign(lowp(xc)[None], torch.sum(torch.square(xc), -1)[None], cents[None], metric)[0]
        assign[s : s + chunk] = a.to(torch.int32)
        if with_residuals:
            residuals[s : s + chunk] = xc - cents[a]
    return assign, residuals


def ivf_train_assign_device(
    x: torch.Tensor,
    sel: torch.Tensor,
    pool_sel: torch.Tensor,
    generator: torch.Generator,
    reseed: torch.Tensor,
    *,
    k: int,
    max_iters: int = 50,
    metric: str = "l2",
    chunk: int = 1 << 17,
    with_residuals: bool = True,
    tol: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The IVF coarse stage: sample gather → k-means++ seeding → Lloyd →
    full assignment (+ residuals).

    x: (N, D) f32 or bf16 on the device; sel: (n_sample,) training-row
    ids; pool_sel: (n_pool,) ids into the sample for seeding; reseed:
    (max_iters, k) empty-cluster reseed rows. Returns (centroids (K, D)
    f32, assign (N,) int32, residuals (N, D) f32 or None)."""
    metric = normalize_metric(metric)
    dev = x.device
    sample = x[sel.to(device=dev, dtype=torch.long)].float()
    pool = sample[pool_sel.to(device=dev, dtype=torch.long)]
    if metric in ("cosine", "dot"):
        pool = _normalize_rows(pool)
    init_c = kmeanspp_init_device(pool, generator, k=k)
    cents, _ = kmeans_fit_device(
        sample, init_c, reseed, k=k, max_iters=max_iters, metric=metric, tol=tol
    )
    assign, residuals = assign_residuals_device(
        x, cents, metric=metric, chunk=chunk, with_residuals=with_residuals
    )
    return cents, assign, residuals
