"""Exact nearest neighbours and distances, and the same search computed in
a lower precision (the control).

Distances are the port's: squared L2 for ``l2``, 1 - cos for ``cosine``
(rows and queries are unit vectors in the cosine configurations)."""

from __future__ import annotations

import torch

SCREEN_EXTRA = 32  # candidates beyond k kept by the f32 screen before the f64 rescore
ROW_BLOCK = 1 << 16


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (f32) rounded to ``precision`` and back to f32: 'float32'
    (unchanged), 'tf32' (10 mantissa bits, to nearest even), 'bfloat16',
    'float16', 'fp8' (e4m3, each row scaled by its largest magnitude to
    448) or 'int8' (each row scaled to 127)."""
    x = x.float()
    if precision == "float32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "float16":
        return x.half().float()
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-30)
    if precision == "fp8":
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    if precision == "int8":
        scale = 127.0 / amax
        return torch.clamp(torch.round(x * scale), -127, 127) / scale
    raise ValueError(f"unknown precision {precision!r}")


def _dists(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(Q, N) distances in the dtype of the inputs, by the expansion."""
    dots = q @ x.T
    if metric == "cosine":
        return 1.0 - dots
    if metric != "l2":
        raise ValueError(f"unsupported metric {metric!r}")
    return (q * q).sum(1, keepdim=True) - 2.0 * dots + (x * x).sum(1)[None, :]


def exact_dist(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances of each query to its own rows, in float64: q (Q, D),
    rows (Q, C, D) → (Q, C)."""
    q, rows = q.double(), rows.double()
    if metric == "cosine":
        return 1.0 - torch.einsum("qd,qcd->qc", q, rows)
    return ((rows - q[:, None, :]) ** 2).sum(-1)


def topk(x: torch.Tensor, q: torch.Tensor, k: int, metric: str,
         allowed: torch.Tensor | None = None, precision: str | None = None):
    """The k nearest allowed rows of each query → (dists (Q, k), ids (Q, k)).

    ``precision=None``: exact, an f32 screen (TF32 off) of k + 32
    candidates, then each candidate's distance in float64, so the result
    is the exact top-k wherever the screen's rounding does not reorder
    the 32 candidates past it. Otherwise both sides are rounded to
    ``precision`` (``round_to``) and the distances and ranking are those
    of the rounded inputs, in f32: the control."""
    no_tf32()
    kk = k if precision is not None else k + SCREEN_EXTRA
    qr = q.float() if precision is None else round_to(q, precision)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    for s in range(0, x.shape[0], ROW_BLOCK):
        xb = x[s:s + ROW_BLOCK].float()
        if precision is not None:
            xb = round_to(xb, precision)
        d = _dists(qr, xb, metric)
        if allowed is not None:
            d = torch.where(allowed[s:s + ROW_BLOCK][None, :], d, torch.inf)
        d_all = torch.cat([best_d, d], 1)
        i_all = torch.cat([best_i, torch.arange(s, s + xb.shape[0], device=q.device)
                           .expand(q.shape[0], -1)], 1)
        best_d, pos = torch.topk(d_all, min(kk, d_all.shape[1]), dim=1, largest=False)
        best_i = torch.gather(i_all, 1, pos)
    if precision is not None:
        return best_d, best_i
    exact = exact_dist(q, x[best_i], metric)
    exact = torch.where(torch.isfinite(best_d), exact, torch.inf)
    d, pos = torch.topk(exact, k, dim=1, largest=False)
    return d, torch.gather(best_i, 1, pos)
