"""Product quantization: codebook training, encoding, reconstruction, OPQ
and the ADC lookup tables.

Port of the reference's ops/pq.py. Codebooks are trained by one batched
k-means over all subvectors (the reference vmaps the same Lloyd program),
and encoding is one batched product per row chunk. Code search and
reconstruction use codebooks rounded to ``matmul_dtype``, as the
reference's one-hot products do; a reconstruction here is a gather of
those rounded entries, which is the one-hot product exactly.

The host functions (``pq_train``, ``pq_encode``, ``pq_reconstruct``,
``opq_train``) take numpy arrays, run on ``device`` (the card unless the
caller asks for the CPU) and return numpy arrays. They draw what the
reference draws from the same seed: numpy generators for the samples,
and one ``prng`` key per subvector for k-means++.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .kmeans import kmeans_fit_device, kmeanspp_init_device
from .util import lowp, matmul_dtype, resolve_device


def default_num_sub_vectors(dim: int) -> int:
    """Reference default: dim/16 if divisible, else dim/8, else 1."""
    if dim % 16 == 0:
        return dim // 16
    if dim % 8 == 0:
        return dim // 8
    return 1


def _split_subvectors(data: torch.Tensor, nsub: int) -> torch.Tensor:
    """(N, D) → (nsub, N, dsub)."""
    n, d = data.shape
    if d % nsub:
        raise ValueError(f"dim {d} not divisible by num_sub_vectors {nsub}")
    return data.reshape(n, nsub, d // nsub).transpose(0, 1).contiguous()


def _train_codebooks(
    subs: torch.Tensor, pool_ids: torch.Tensor, keys: torch.Tensor,
    reseed: torch.Tensor, kcode: int, max_iters: int,
) -> torch.Tensor:
    """Per-subvector k-means++ on ``subs[:, pool_ids]`` (subvector s drawing
    from keys[s]) then Lloyd, batched over the subvectors: (S, n, dsub)
    f32 → codebooks (S, K, dsub) f32."""
    inits = kmeanspp_init_device(subs[:, pool_ids], keys, k=kcode)
    codebooks, _ = kmeans_fit_device(subs, inits, reseed, k=kcode, max_iters=max_iters,
                                     metric="l2")
    return codebooks


def _code_search(xs: torch.Tensor, cb_lp: torch.Tensor, cn2: torch.Tensor) -> torch.Tensor:
    """Nearest codes of (c, S, dsub) subvectors → (c, S) int64; |x|² is
    constant per row, so argmin(|c|² − 2 x·c) picks the nearest."""
    dots = torch.einsum("csd,skd->csk", lowp(xs), cb_lp)
    # cn2 - 2·dots in place, the same bits: one (c, S, K) array, not three
    return torch.argmin(dots.mul_(-2.0).add_(cn2[None]), dim=-1)


def pq_train(
    data: np.ndarray,
    num_sub_vectors: int,
    num_bits: int = 8,
    max_iters: int = 50,
    sample_rate: int = 256,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Train codebooks → (nsub, 2^bits, dsub) f32, every subvector's
    k-means in one batched program. Tables with fewer rows than codes are
    oversampled with replacement (duplicate centroids are harmless: the
    encode picks the first argmin)."""
    if num_bits not in (4, 8):
        raise ValueError("num_bits must be 4 or 8")
    k = 1 << num_bits
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    if n > sample_rate * k:
        data = data[rng.choice(n, size=sample_rate * k, replace=False)]
        n = data.shape[0]
    if n < k:
        data = np.concatenate([data, data[rng.integers(0, n, size=k - n)]])
        n = data.shape[0]
    dev = resolve_device(device)
    subs = _split_subvectors(torch.from_numpy(np.ascontiguousarray(data)).to(dev), num_sub_vectors)
    pool_ids = torch.from_numpy(rng.choice(n, size=min(n, 32 * k), replace=False)).to(dev)
    reseed = torch.from_numpy(rng.integers(0, n, size=(max_iters, k), dtype=np.int32))
    keys = prng.split(prng.prng_key(seed), num_sub_vectors)
    return _train_codebooks(subs, pool_ids, keys, reseed, k, max_iters).cpu().numpy()


def pq_encode(data: np.ndarray, codebooks: np.ndarray, block_rows: int = 1 << 17,
              device=None) -> np.ndarray:
    """Encode rows → (N, nsub) uint8 codes, ``block_rows`` rows per upload."""
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    cb = torch.from_numpy(np.array(codebooks, dtype=np.float32)).to(dev)
    nsub, _, dsub = cb.shape
    cb_lp, cn2 = lowp(cb), torch.sum(torch.square(cb), dim=-1)
    out = np.empty((data.shape[0], nsub), dtype=np.uint8)
    for start in range(0, data.shape[0], block_rows):
        block = torch.from_numpy(np.ascontiguousarray(data[start : start + block_rows])).to(dev)
        if block.shape[1] != nsub * dsub:
            raise ValueError(f"dim {block.shape[1]} not divisible by num_sub_vectors {nsub}")
        codes = _code_search(block.reshape(-1, nsub, dsub), cb_lp, cn2)
        out[start : start + block.shape[0]] = codes.to(torch.uint8).cpu().numpy()
    return out


def pq_reconstruct_device(codes: torch.Tensor, codebooks: torch.Tensor,
                          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dequantize codes (N, S) against codebooks (S, K, dsub) → (N, D) in
    ``out_dtype`` (default ``matmul_dtype``): the entries of the
    codebooks rounded to ``matmul_dtype``, as the one-hot product gives."""
    if out_dtype is None:
        out_dtype = matmul_dtype(codes.device)
    nsub = codebooks.shape[0]
    sub_ids = torch.arange(nsub, device=codes.device)
    recon = lowp(codebooks.float())[sub_ids[None, :], codes.long()]  # (N, S, dsub)
    return recon.reshape(codes.shape[0], -1).to(out_dtype)


def pq_reconstruct(codes: np.ndarray, codebooks: np.ndarray, block_rows: int = 1 << 16,
                   device=None) -> np.ndarray:
    """Host wrapper of ``pq_reconstruct_device`` → (N, D) f32."""
    dev = resolve_device(device)
    cb = torch.from_numpy(np.array(codebooks, dtype=np.float32)).to(dev)
    out = np.empty((codes.shape[0], cb.shape[0] * cb.shape[2]), dtype=np.float32)
    for start in range(0, codes.shape[0], block_rows):
        blk = torch.from_numpy(np.array(codes[start : start + block_rows])).to(dev)
        out[start : start + blk.shape[0]] = (
            pq_reconstruct_device(blk, cb, out_dtype=torch.float32).cpu().numpy()
        )
    return out


def _encode_rnorms_device(
    residuals: torch.Tensor,
    cents: torch.Tensor,
    assign: torch.Tensor,
    codebooks: torch.Tensor,
    chunk: int,
    rotation: torch.Tensor | None = None,
    from_raw: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused encode + reconstruct + |x̂|², blocked over row chunks.

    residuals: (N, D); cents: (P, D); assign: (N,) int; codebooks:
    (S, K, dsub) f32; rotation: (D, D) f32 for OPQ (codes quantize the
    rotated residuals r·Rᵀ, and r̂ = ŷ·R). Returns (codes (N, S) uint8,
    rnorms (N,) f32) with rnorms = |c_assign + r̂|².

    ``from_raw``: the first argument holds the RAW rows; each chunk forms
    its residuals against its centroids itself, so no (N, D) residual
    buffer exists (the reference's capacity mode)."""
    n, d = residuals.shape
    nsub, kcode, dsub = codebooks.shape
    cb = codebooks.float()
    cb_lp = lowp(cb)
    cn2 = torch.sum(torch.square(cb), dim=-1)  # (S, K)
    sub_ids = torch.arange(nsub, device=cb.device)
    codes = torch.empty((n, nsub), dtype=torch.uint8, device=residuals.device)
    rnorms = torch.empty(n, dtype=torch.float32, device=residuals.device)
    for s in range(0, n, chunk):
        asg = assign[s : s + chunk].long()
        res = residuals[s : s + chunk].float()
        if from_raw:
            res = res - cents[asg]
        x = res if rotation is None else res @ rotation.T
        c = _code_search(x.reshape(-1, nsub, dsub), cb_lp, cn2)  # (c, S)
        recon = cb_lp[sub_ids[None, :], c].reshape(-1, d)
        if rotation is not None:
            recon = recon @ rotation
        xhat = recon + cents[asg]
        codes[s : s + chunk] = c.to(torch.uint8)
        rnorms[s : s + chunk] = torch.sum(torch.square(xhat), dim=-1)
    return codes, rnorms


def pq_encode_rnorms(
    residuals_dev: torch.Tensor,
    cents_dev: torch.Tensor,
    assign_dev: torch.Tensor,
    codebooks: np.ndarray,
    rotation: np.ndarray | None = None,
    chunk: int = 1 << 17,
) -> tuple[np.ndarray, np.ndarray]:
    """Device-resident encode + |x̂|² for the index build, on the device
    of ``residuals_dev`` → host (codes (N, S) uint8, rnorms (N,) f32)."""
    dev = residuals_dev.device
    rot = None if rotation is None else torch.from_numpy(
        np.array(rotation, dtype=np.float32)).to(dev)
    codes, rnorms = _encode_rnorms_device(
        residuals_dev, cents_dev, assign_dev,
        torch.from_numpy(np.array(codebooks, dtype=np.float32)).to(dev),
        chunk=min(chunk, residuals_dev.shape[0]), rotation=rot,
    )
    return codes.cpu().numpy(), rnorms.cpu().numpy()


def pq_build_device(
    residuals: torch.Tensor,
    cents: torch.Tensor,
    assign: torch.Tensor,
    sel: torch.Tensor,
    pool_sel: torch.Tensor,
    keys: torch.Tensor,
    reseed: torch.Tensor,
    *,
    nsub: int,
    kcode: int,
    max_iters: int = 50,
    chunk: int = 1 << 17,
    rotation: torch.Tensor | None = None,
    from_raw: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PQ stage: codebook-sample gather → per-subvector k-means++ and
    Lloyd (batched over subvectors) → fused encode + |x̂|².

    residuals: (N, D) f32 or bf16 on the device (the RAW rows with
    ``from_raw``: residuals are then formed per training row and per
    chunk); cents: (P, D) f32; assign: (N,); sel: (n_train,) training-row
    ids; pool_sel: (n_pool,) ids into the training sample for seeding;
    keys: (nsub, 2) ``prng`` keys, one per subvector; reseed: (max_iters, kcode), shared by the subvectors; rotation:
    (D, D) f32 for OPQ or None. Returns (codebooks (S, K, dsub) f32,
    codes (N, S) uint8, rnorms (N,) f32)."""
    dev = residuals.device
    sel = sel.to(device=dev, dtype=torch.long)
    sample = residuals[sel].float()
    if from_raw:
        sample = sample - cents[assign[sel].long()]
    if rotation is not None:
        sample = sample @ rotation.T
    subs = _split_subvectors(sample, nsub)  # (S, n, dsub)
    codebooks = _train_codebooks(subs, pool_sel.to(device=dev, dtype=torch.long), keys,
                                 reseed, kcode, max_iters)
    codes, rnorms = _encode_rnorms_device(
        residuals, cents, assign, codebooks, chunk=chunk, rotation=rotation, from_raw=from_raw
    )
    return codebooks, codes, rnorms


def opq_train(
    data: np.ndarray,
    num_sub_vectors: int,
    num_bits: int = 8,
    opq_iters: int = 8,
    max_iters: int = 50,
    sample_rate: int = 256,
    seed: int = 0,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """OPQ: an orthonormal rotation R that lowers the PQ reconstruction
    error, then codebooks trained on the rotated rows.

    Alternating minimization (OPQ-NP, Ge et al. 2013), as the reference
    runs it: fix R, train a short PQ on Y = X·Rᵀ; fix the codes, solve
    the orthogonal Procrustes problem R = U·Vᵀ from the SVD of Ŷᵀ·X,
    taken in float64 on the host. Returns (rotation (D, D) f32, codebooks
    (S, K, dsub) f32); encode with pq_encode(data @ rotation.T, codebooks)."""
    dev = resolve_device(device)
    k = 1 << num_bits
    data = np.asarray(data, dtype=np.float32)
    n, dim = data.shape
    rng = np.random.default_rng(seed)
    if n > sample_rate * k:
        data = data[rng.choice(n, size=sample_rate * k, replace=False)]
    rot = np.eye(dim, dtype=np.float32)
    xd = torch.from_numpy(np.ascontiguousarray(data)).to(dev)

    def rotated(r: np.ndarray) -> np.ndarray:
        return (xd @ torch.from_numpy(r).to(dev).T).cpu().numpy()

    for t in range(opq_iters):
        y = rotated(rot)
        cb = pq_train(y, num_sub_vectors, num_bits=num_bits, max_iters=min(10, max_iters),
                      sample_rate=sample_rate, seed=seed + t, device=dev)
        yhat = pq_reconstruct(pq_encode(y, cb, device=dev), cb, device=dev)
        m = (torch.from_numpy(yhat).to(dev).T @ xd).cpu().numpy()
        u, _, vt = np.linalg.svd(m.astype(np.float64))
        rot = (u @ vt).astype(np.float32)
    codebooks = pq_train(rotated(rot), num_sub_vectors, num_bits=num_bits, max_iters=max_iters,
                         sample_rate=sample_rate, seed=seed, device=dev)
    return rot, codebooks


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Classic ADC lookup tables (Q, S, K) of |q_s − C_s[k]|², in f32, on
    the device of ``queries``."""
    q = queries.float()
    cb = codebooks.float()
    nsub, _, dsub = cb.shape
    qs = q.reshape(q.shape[0], nsub, dsub)
    dots = torch.einsum("qsd,skd->qsk", qs, cb)
    qn2 = torch.sum(torch.square(qs), dim=-1)  # (Q, S)
    cn2 = torch.sum(torch.square(cb), dim=-1)  # (S, K)
    return qn2[:, :, None] - 2.0 * dots + cn2[None, :, :]


def adc_scan_lut(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """LUT-sum ADC: luts (Q, S, K) × codes (N, S) → distances (Q, N), the
    tables rounded to ``matmul_dtype`` and summed in f32, as the
    reference's one-hot contraction is."""
    lut = lowp(luts.float())
    nsub = lut.shape[1]
    sub_ids = torch.arange(nsub, device=lut.device)
    return lut[:, sub_ids[None, :], codes.long()].sum(dim=-1)  # (Q, N, S) → (Q, N)
