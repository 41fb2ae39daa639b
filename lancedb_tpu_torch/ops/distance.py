"""Distance functions as matmul formulations of every metric.

    l2(q, x)     = |q|^2 - 2 q·x + |x|^2          (squared L2, like lance)
    cosine(q, x) = 1 - (q·x) / (|q| |x|)
    dot(q, x)    = -(q·x)                          (distance ordering)
    hamming      = popcount(q XOR x) via a ±1 product over the bits

``precision="float32"`` is a full-f32 product (TF32 stays off, the
PyTorch default); ``"bfloat16"`` multiplies in ``matmul_dtype``.
"""

from __future__ import annotations

import torch

from .util import matmul_dtype

VALID_METRICS = ("l2", "cosine", "dot", "hamming")


def normalize_metric(metric: str) -> str:
    m = metric.lower().strip()
    aliases = {"euclidean": "l2", "cos": "cosine", "inner_product": "dot", "ip": "dot"}
    m = aliases.get(m, m)
    if m not in VALID_METRICS:
        raise ValueError(f"unknown distance metric {metric!r}; expected one of {VALID_METRICS}")
    return m


def _matmul(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """q (Q, D) @ x.T (D, N) → (Q, N) f32."""
    if precision == "bfloat16":
        dt = matmul_dtype(q.device)
        return (q.to(dt) @ x.to(dt).T).float()
    return q.float() @ x.float().T


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()), dim=-1)


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: str = "l2",
    precision: str = "float32",
    x_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense (Q, N) distance matrix between query rows and database rows.

    ``x_norms`` — optional precomputed |x|^2 (l2) or |x| (cosine)."""
    metric = normalize_metric(metric)
    if metric == "hamming":
        return hamming_distance(q, x)
    qf = q.float()
    xf = x.float()
    dots = _matmul(qf, xf, precision)
    if metric == "dot":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt(squared_norms(qf))[:, None]
        xn = torch.sqrt(squared_norms(xf))[None, :] if x_norms is None else x_norms[None, :]
        denom = torch.clamp(qn * xn, min=1e-30)
        return 1.0 - dots / denom
    qn2 = squared_norms(qf)[:, None]
    xn2 = squared_norms(xf)[None, :] if x_norms is None else x_norms[None, :]
    return torch.clamp(qn2 - 2.0 * dots + xn2, min=0.0)


def hamming_distance(q: torch.Tensor, x: torch.Tensor, chunk: int = 1 << 18) -> torch.Tensor:
    """Hamming distance between binary vectors packed in uint8 (Q, B) and
    (N, B) → (Q, N) f32. The bits unpack to ±1 and the XOR popcount is a
    product: popcount(a ^ b) = (nbits − a±1 · b±1) / 2. Every distance
    is an exact integer: on the CPU the product is f32; on the card it is
    f16 up to 2048 bits, where every partial sum is an integer of at most
    2048 in magnitude and so exact in f16, and f32 above. The rows
    unpack ``chunk`` at a time, which bounds the ±1 transient."""
    dtype = torch.float16 if q.device.type == "cuda" and q.shape[1] * 8 <= 2048 else (
        torch.float32)
    qb = _unpack_bits_pm1(q, dtype)
    nbits = qb.shape[-1]
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=q.device)
    for i in range(0, x.shape[0], chunk):
        dots = qb @ _unpack_bits_pm1(x[i : i + chunk], dtype).T
        out[:, i : i + chunk] = (nbits - dots.float()) * 0.5
    return out


def _unpack_bits_pm1(packed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (N, B) → (N, 8B) in {−1, +1} of ``dtype``, bit j of byte i at
    column 8i + j (little-endian, as np.packbits(bitorder="little"))."""
    n, b = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(n, b * 8).to(dtype) * 2 - 1


def refine_distances(
    q: torch.Tensor, candidates: torch.Tensor, metric: str = "l2"
) -> torch.Tensor:
    """Exact per-candidate distances for the refine rerank.

    q: (Q, D); candidates: (Q, K, D). Returns (Q, K) f32."""
    metric = normalize_metric(metric)
    qf = q.float()
    cf = candidates.float()
    dots = torch.einsum("qd,qkd->qk", qf, cf)
    if metric == "dot":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt(squared_norms(qf))[:, None]
        cn = torch.sqrt(torch.sum(torch.square(cf), dim=-1))
        return 1.0 - dots / torch.clamp(qn * cn, min=1e-30)
    qn2 = squared_norms(qf)[:, None]
    cn2 = torch.sum(torch.square(cf), dim=-1)
    return torch.clamp(qn2 - 2.0 * dots + cn2, min=0.0)
