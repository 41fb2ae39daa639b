"""Distance functions as matmul formulations of every metric.

    l2(q, x)     = |q|^2 - 2 q·x + |x|^2          (squared L2, like lance)
    cosine(q, x) = 1 - (q·x) / (|q| |x|)
    dot(q, x)    = -(q·x)                          (distance ordering)

``precision="float32"`` is a full-f32 product (TF32 stays off, the
PyTorch default); ``"bfloat16"`` multiplies in ``matmul_dtype``.
Hamming distance is not part of this slice.
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
        raise NotImplementedError("hamming distance waits for a later slice (ROADMAP A1)")
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
