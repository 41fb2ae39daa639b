"""Shared helpers for the device ops: padding arithmetic, dtype policy,
argument checks for the kernels and the pair grouping of the probed scans
(``grouped_plan``, which launches ``csrc/group_plan.cu`` on the card)."""

from __future__ import annotations

import torch

from .cuda_build import count_launch, launch, max_smem_bytes, static_smem_bytes

# +inf stand-in for masked entries (the reference's INF, ops/util.py:53)
INF = 3.4e38
# most queries one group of the grouped kernels holds (B2's register tile)
MAX_QPC = 32


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


def check_tensor(t: torch.Tensor, name: str, dtypes, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` with
    ``shape`` on ``device``: what a kernel's C interface takes."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def group_probe_pairs(probe_ids: torch.Tensor, p: int, qpc: int):
    """Sort the (query, probe) pairs by partition id and pad each
    partition's run to a multiple of ``qpc``, so that every group of qpc
    consecutive slots shares ONE partition and reads its block once
    (the reference's ops/util.py ``group_probe_pairs``, element for
    element; the sort is stable, as ``jnp.argsort`` is).

    Returns ``(gpid, qidx, slot, order, g, spad)``:
      gpid (G,) int32: partition per group (tail groups repeat the last
        real pid);
      qidx (SPAD,) int32: query index per padded slot (0 for padding);
      slot (S,) int32: padded-layout position of each sorted pair;
      order (S,) int32: pair indices sorted by pid;
      g, spad: group and slot counts, bounds fixed by the shapes."""
    q, np_ = probe_ids.shape
    s = q * np_
    dev = probe_ids.device
    flat = probe_ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    spids = flat[order]
    is_start = torch.ones(s, dtype=torch.bool, device=dev)
    is_start[1:] = spids[1:] != spids[:-1]
    ar = torch.arange(s, device=dev)
    start_idx = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    rank = ar - start_idx  # rank within the pid run
    counts = torch.bincount(flat, minlength=p)
    padded = (counts + qpc - 1) // qpc * qpc
    poff = torch.cumsum(padded, dim=0) - padded
    slot = poff[spids] + rank  # position in the padded layout
    g, spad = plan_bounds(s, p, qpc)
    qidx = torch.zeros(spad, dtype=torch.int32, device=dev)
    qidx[slot] = (order // np_).to(torch.int32)
    gpid = spids[-1:].to(torch.int32).repeat(g)  # stays on the device, no sync
    gpid[slot // qpc] = spids.to(torch.int32)
    return gpid, qidx, slot.to(torch.int32), order.to(torch.int32), g, spad


def plan_bounds(s: int, p: int, qpc: int) -> tuple[int, int]:
    """(G, SPAD) of the plan of ``s`` pairs over ``p`` partitions: at most
    min(P, S) partitions are probed, each padded by < qpc slots."""
    spad = (s + min(p, s) * (qpc - 1) + qpc - 1) // qpc * qpc
    return spad // qpc, spad


def grouped_plan_reference(probe_ids: torch.Tensor, p: int, qpc: int):
    """Plain torch version of ``grouped_plan``, from ``group_probe_pairs``."""
    gpid, _, slot, order, g, spad = group_probe_pairs(probe_ids, p, qpc)
    pair_of_slot = torch.full((spad,), -1, dtype=torch.int32, device=probe_ids.device)
    pair_of_slot[slot.long()] = order
    return gpid, pair_of_slot, g


def grouped_plan(probe_ids: torch.Tensor, p: int, qpc: int):
    """What the grouped kernels (B2, B3) read from ``group_probe_pairs``:
    (gpid (G,) int32, pair_of_slot (G·qpc,) int32, G). Slot i of group
    i // qpc holds pair ``pair_of_slot[i]`` = q·NP + j, or −1 where the
    group is padded. The kernel writes each real slot's row straight to
    out[q, j] and never writes a padded one, which replaces the
    reference's scatter back through ``slot`` and ``argsort(order)``.

    On the card: one launch of ``csrc/group_plan.cu`` on the current
    stream, with no host sync; probe ids must lie in [0, P). On the CPU:
    ``grouped_plan_reference``. The two agree element for element."""
    dev = probe_ids.device
    if dev.type == "cpu":
        return grouped_plan_reference(probe_ids, p, qpc)
    if dev.type != "cuda":
        raise ValueError(f"grouped_plan runs on cuda or cpu tensors, got {dev}")
    q, np_ = probe_ids.shape
    check_tensor(probe_ids, "probe_ids", torch.int32, (q, np_), dev)
    if qpc < 1 or p < 1:
        raise ValueError(f"grouped_plan needs qpc >= 1 and P >= 1, got qpc {qpc}, P {p}")
    g, spad = plan_bounds(q * np_, p, qpc)
    # the kernel keeps 2·P counters and a scratch copy of the padded layout
    # in shared memory, each as far as it fits, the rest in global scratch
    room = max_smem_bytes() - static_smem_bytes("group_plan")
    counters_fit = 8 * p <= room
    runs_fit = counters_fit and 8 * p + 4 * spad <= room
    extra = (0 if counters_fit else 2 * p) + (0 if runs_fit else spad)
    buf = torch.empty((g + spad + extra,), dtype=torch.int32, device=dev)  # one allocation
    gpid, pair_of_slot = buf[:g], buf[g : g + spad]
    if q * np_ == 0:
        return gpid, pair_of_slot, g
    base = buf.data_ptr()
    scratch = base + 4 * (g + spad)  # int32 offsets into buf
    counters = 0 if counters_fit else scratch
    runs = 0 if runs_fit else scratch + (0 if counters_fit else 8 * p)
    launch("group_plan", [probe_ids.data_ptr(), base, base + 4 * g, counters, runs],
           [q * np_, p, qpc, g], dev)
    count_launch("group_plan")
    return gpid, pair_of_slot, g
