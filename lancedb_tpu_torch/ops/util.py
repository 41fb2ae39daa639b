"""Shared helpers for the device ops: padding arithmetic and dtype policy."""

from __future__ import annotations

import torch

# +inf stand-in for masked entries (the reference's INF, ops/util.py:53)
INF = 3.4e38


def resolve_device(device) -> torch.device:
    """``None`` means the card. There is no silent CPU fallback: a
    caller that wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lancedb_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def matmul_dtype(device) -> torch.dtype:
    """Fast-matmul input dtype: bfloat16 on the card (tensor-core rate),
    float32 on the CPU — the same split the reference makes between the
    TPU and its CPU test backend."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def lowp(t: torch.Tensor) -> torch.Tensor:
    """Round to ``matmul_dtype`` and come back to f32. A product of two
    such tensors is the reference's fast matmul exactly: low-precision
    inputs, f32 accumulation and f32 output (a bf16 ``torch.matmul``
    would also round its output to bf16)."""
    return t.to(matmul_dtype(t.device)).float()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
