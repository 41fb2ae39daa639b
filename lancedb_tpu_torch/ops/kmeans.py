"""Batched k-means (Lloyd) for the IVF coarse quantizer and the PQ codebooks.

Port of the reference's ops/kmeans.py. Both halves of a Lloyd iteration
are tensor ops: the assignment is one (N, D)x(D, K) product in
``matmul_dtype`` plus an argmin; the update sums rows per cluster in f32
(``_sum_rows``, the one-hot product of the reference), in an order that
is the same on every run, so a build gives the same centroids each time,
as the reference's does. Empty clusters
are reseeded from the host-drawn rows in ``reseed_rows``.

Every function takes a leading batch axis where the reference vmaps
(one k-means per PQ subvector), and the unbatched form is a batch of
one. k-means++ draws the reference's ``jax.random`` bits from the same
seed (``prng``), so a training here starts where the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .distance import normalize_metric
from .util import lowp, resolve_device

# Gumbel noise elements drawn per block of k-means++ steps
_GUMBEL_BLOCK = 1 << 22


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


def _sum_rows(out: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """out[idx[i]] += rows[i], summed in an order fixed from run to run:
    ``index_add_`` on the CPU; on the card the accumulating ``index_put_``,
    which sorts the indices first (``index_add_`` there adds with float
    atomics, and ``index_put_`` on the CPU does)."""
    if out.device.type == "cuda":
        out.index_put_((idx,), rows, accumulate=True)
    else:
        out.index_add_(0, idx, rows)


def _update(x_lp: torch.Tensor, assign: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums (B, K, D) f32 and counts (B, K) f32."""
    b, n, d = x_lp.shape
    flat = (assign + torch.arange(b, device=assign.device)[:, None] * k).reshape(-1)
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=x_lp.device)
    _sum_rows(sums, flat, x_lp.reshape(-1, d))
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


def kmeanspp_init_device(x: torch.Tensor, key: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding. x: (N, D) or (B, N, D); key: (2,) or (B, 2), a
    ``prng`` key per batch member → (K, D) or (B, K, D).

    Each step extends the running min-distance with the newest centroid
    and samples the next one ∝ D² with the Gumbel-max trick. The first
    index and the (K, N) Gumbel noise are the reference's draws from the
    same key, made a block of steps at a time."""
    batched = x.dim() == 3
    if not batched:
        x, key = x[None], key[None]
    b, n, _ = x.shape
    dev = x.device
    xf = x.float()
    x_n2 = torch.sum(torch.square(xf), dim=-1)  # (B, N)
    rows = torch.arange(b, device=dev)
    sub = prng.split(key.to(dev))
    k_first, k_gumbel = sub[:, 0], sub[:, 1]
    idx = prng.randint(k_first, n)
    block = max(1, _GUMBEL_BLOCK // (b * n))
    min_d2 = torch.full((b, n), float("inf"), device=dev)
    picks = []
    for it in range(k):
        if it % block == 0:
            steps = min(block, k - it)
            gumbels = prng.gumbel(k_gumbel, it * n, steps * n).reshape(b, steps, n)
        picks.append(idx)
        c = xf[rows, idx]  # (B, D)
        d2 = x_n2 - 2.0 * torch.bmm(xf, c[:, :, None])[..., 0] + torch.sum(torch.square(c), -1)[:, None]
        min_d2 = torch.minimum(min_d2, torch.clamp(d2, min=0.0))
        logits = torch.where(
            min_d2 > 0, torch.log(torch.clamp(min_d2, min=1e-30)),
            torch.full_like(min_d2, float("-inf")),
        )
        idx = torch.argmax(logits + gumbels[:, it % block], dim=-1)
    out = xf[rows[:, None], torch.stack(picks, dim=1)]  # (B, K, D)
    return out if batched else out[0]


def assign_residuals_device(
    x: torch.Tensor,
    cents: torch.Tensor,
    metric: str = "l2",
    chunk: int = 1 << 17,
    with_residuals: bool = True,
    residual_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Blocked assignment (+ residuals) of every row of x (N, D): the
    (chunk, K) distance transient stays bounded, and each chunk is cast to
    f32 (and normalized) on its own, so a bf16 table never gets a
    full-size f32 copy. ``residual_dtype="bfloat16"`` halves the residual
    buffer for large-D builds (PQ code selection tolerates it; |x̂|² is
    rebuilt from the codebooks). Returns (assign (N,) int32, residuals
    (N, D) in ``residual_dtype`` or None)."""
    n = x.shape[0]
    spherical = metric in ("cosine", "dot")
    res_dt = torch.bfloat16 if residual_dtype == "bfloat16" else torch.float32
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    residuals = (
        torch.empty((n, x.shape[1]), dtype=res_dt, device=x.device)
        if with_residuals else None
    )
    for s in range(0, n, chunk):
        xc = x[s : s + chunk].float()
        if spherical:
            xc = _normalize_rows(xc)
        a = _assign(lowp(xc)[None], torch.sum(torch.square(xc), -1)[None], cents[None], metric)[0]
        assign[s : s + chunk] = a.to(torch.int32)
        if with_residuals:
            residuals[s : s + chunk] = (xc - cents[a]).to(res_dt)
    return assign, residuals


def ivf_train_assign_device(
    x: torch.Tensor,
    sel: torch.Tensor,
    pool_sel: torch.Tensor,
    key: torch.Tensor,
    reseed: torch.Tensor,
    *,
    k: int,
    max_iters: int = 50,
    metric: str = "l2",
    chunk: int = 1 << 17,
    with_residuals: bool = True,
    tol: float = 1e-4,
    residual_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The IVF coarse stage: sample gather → k-means++ seeding → Lloyd →
    full assignment (+ residuals).

    x: (N, D) f32 or bf16 on the device; sel: (n_sample,) training-row
    ids; pool_sel: (n_pool,) ids into the sample for seeding; reseed:
    (max_iters, k) empty-cluster reseed rows. Returns (centroids (K, D)
    f32, assign (N,) int32, residuals (N, D) in ``residual_dtype`` or
    None). The reference pads N to a whole number of chunks for its
    ``lax.map``; the loop here takes a ragged last chunk instead."""
    metric = normalize_metric(metric)
    dev = x.device
    sample = x[sel.to(device=dev, dtype=torch.long)].float()
    pool = sample[pool_sel.to(device=dev, dtype=torch.long)]
    if metric in ("cosine", "dot"):
        pool = _normalize_rows(pool)
    init_c = kmeanspp_init_device(pool, key, k=k)
    cents, _ = kmeans_fit_device(
        sample, init_c, reseed, k=k, max_iters=max_iters, metric=metric, tol=tol
    )
    assign, residuals = assign_residuals_device(
        x, cents, metric=metric, chunk=chunk, with_residuals=with_residuals,
        residual_dtype=residual_dtype,
    )
    return cents, assign, residuals


def kmeans_fit(
    data,
    k: int,
    metric: str = "l2",
    max_iters: int = 50,
    sample_rate: int = 256,
    seed: int = 0,
    tol: float = 1e-4,
    init: str = "kmeans++",
    device=None,
) -> np.ndarray:
    """Host entry: sample, seed and train on the device → (K, D) f32.

    The reference's sampling and draws: at most sample_rate × k training
    rows, k-means++ on a pool of at most 32 rows per centroid (or k rows
    drawn at random with ``init="random"``), reseed rows from the same
    numpy generator, the k-means++ draws from ``prng.prng_key(seed)``.
    ``data`` may be a tensor already on the device (it stays there) or a
    host array, uploaded to ``device``."""
    metric = normalize_metric(metric)
    if isinstance(data, torch.Tensor):
        xd = data
    else:
        xd = torch.from_numpy(np.array(data, dtype=np.float32)).to(resolve_device(device))
    dev = xd.device
    n = xd.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} rows to train k-means, got {n}")
    rng = np.random.default_rng(seed)
    if n > sample_rate * k:
        sample = xd[torch.from_numpy(rng.choice(n, size=sample_rate * k, replace=False)).to(dev)]
    else:
        sample = xd
    sample = sample.float()
    if init == "kmeans++":
        pool_size = min(sample.shape[0], max(32 * k, 4 * k))
        pool = sample
        if pool_size < sample.shape[0]:
            pool = sample[torch.from_numpy(
                rng.choice(sample.shape[0], size=pool_size, replace=False)).to(dev)]
        if metric in ("cosine", "dot"):
            pool = _normalize_rows(pool)
        init_c = kmeanspp_init_device(pool, prng.prng_key(seed), k=k)
    else:
        init_c = sample[torch.from_numpy(
            rng.choice(sample.shape[0], size=k, replace=False)).to(dev)]
    reseed = torch.from_numpy(rng.integers(0, sample.shape[0], size=(max_iters, k), dtype=np.int32))
    cents, _ = kmeans_fit_device(sample, init_c, reseed, k=k, max_iters=max_iters,
                                 metric=metric, tol=tol)
    return cents.cpu().numpy()


def kmeans_assign_device(x: torch.Tensor, cents: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Nearest-centroid ids (N,) int32 of x (N, D) on its device."""
    xf = x.float()
    if metric in ("cosine", "dot"):
        xf = _normalize_rows(xf)
    return _assign(lowp(xf)[None], torch.sum(torch.square(xf), -1)[None],
                   cents.float()[None], metric)[0].to(torch.int32)


def kmeans_assign(
    data: np.ndarray, centroids: np.ndarray, metric: str = "l2", block_rows: int = 1 << 18,
    device=None,
) -> np.ndarray:
    """Blocked host wrapper: partition-assign a whole host table on the
    device, ``block_rows`` rows per upload."""
    metric = normalize_metric(metric)
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    cents = torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev)
    out = np.empty(data.shape[0], dtype=np.int32)
    for start in range(0, data.shape[0], block_rows):
        block = torch.from_numpy(np.ascontiguousarray(data[start : start + block_rows])).to(dev)
        out[start : start + block.shape[0]] = kmeans_assign_device(block, cents, metric).cpu().numpy()
    return out
