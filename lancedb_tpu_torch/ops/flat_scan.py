"""Fused IVF_FLAT probe scans: the counterparts of the reference's
ops/pallas_group_scan.py ``ivf_flat_grouped_scan_pallas`` (B2, the one
IVF_FLAT search runs) and ops/pallas_scan.py ``ivf_flat_scan_pallas``
(B4, the same function without grouping).

Both compute, for query q, probe j and slot p of partition
pid = probe_ids[q, j]:

    out[q, j, p] = alpha[q] · (queries[q] · vectors[pid, p]) + norms[pid, p] + gamma[q]

in f32, from f32 or bf16 storage. The per-query (alpha, gamma) and the
per-slot ``norms`` encode the metric (the caller folds the padding,
filter and delete penalties into ``norms``):

    l2:     alpha = −2,     gamma = |q|²,  norms = |x|² (+3e38 padding)
    cosine: alpha = −1/|q|, gamma = 1,     norms = padding penalty
    dot:    alpha = −1,     gamma = 0,     norms = padding penalty

``ivf_flat_grouped_scan`` launches ``csrc/ivf_flat_group_scan.cu`` and
``ivf_flat_scan`` launches ``csrc/ivf_flat_scan.cu`` for tensors on the
card; for tensors on the CPU both use the plain torch version,
``ivf_flat_scan_reference``. A CUDA input that a kernel refuses raises.
"""

from __future__ import annotations

import functools

import torch

from .cuda_build import count_launch, launch
from .util import MAX_QPC, check_tensor, grouped_plan, round_up

# bytes of one of the per-pair kernel's two row stages
PAIR_STAGE = 32 * 1024
# shared memory of one SM and resident blocks of 256 threads an SM holds (H100)
SM_SMEM, SM_BLOCKS = 228 * 1024, 8
# waves of resident blocks the per-pair grid aims at
PAIR_WAVES = 4


def ivf_flat_scan_reference(
    probe_ids: torch.Tensor,  # (Q, NP) int
    queries: torch.Tensor,    # (Q, D) f32
    vectors: torch.Tensor,    # (P, pmax, D) f32 or bf16
    norms: torch.Tensor,      # (P, pmax) f32, penalties pre-added
    alpha: torch.Tensor,      # (Q,) f32
    gamma: torch.Tensor,      # (Q,) f32
    max_chunk_bytes: int = 1 << 28,
) -> torch.Tensor:
    """Plain torch version: gather the probed blocks and take the dots in
    f32, chunked over queries so the gathered blocks stay bounded."""
    q, np_ = probe_ids.shape
    _, pmax, d = vectors.shape
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=vectors.device)
    step = max(1, max_chunk_bytes // max(1, np_ * pmax * d * 4))
    pids_all = probe_ids.long()
    for q0 in range(0, q, step):
        q1 = min(q, q0 + step)
        pids = pids_all[q0:q1]
        blocks = vectors[pids].float()  # (c, NP, pmax, D)
        dots = torch.einsum("cnpd,cd->cnp", blocks, queries[q0:q1].float())
        out[q0:q1] = (
            alpha[q0:q1, None, None].float() * dots + norms[pids].float()
            + gamma[q0:q1, None, None].float()
        )
    return out


def _check_args(probe_ids, queries, vectors, norms, alpha, gamma) -> tuple[int, ...]:
    dev = vectors.device
    q, np_ = probe_ids.shape
    p, pmax, d = vectors.shape
    check_tensor(probe_ids, "probe_ids", torch.int32, (q, np_), dev)
    check_tensor(queries, "queries", torch.float32, (q, d), dev)
    check_tensor(vectors, "vectors", (torch.float32, torch.bfloat16), (p, pmax, d), dev)
    check_tensor(norms, "norms", torch.float32, (p, pmax), dev)
    check_tensor(alpha, "alpha", torch.float32, (q,), dev)
    check_tensor(gamma, "gamma", torch.float32, (q,), dev)
    return q, np_, p, pmax, d


def launch_grouped(gpid, pair_of_slot, g: int, qpc: int, queries, vectors, norms, alpha,
                   gamma, out) -> None:
    """One launch of the grouped kernel on a plan from ``grouped_plan``
    (arguments already checked), writing ``out`` (Q, NP, pmax)."""
    np_, pmax = out.shape[1], out.shape[2]
    launch(
        "ivf_flat_group_scan",
        [gpid.data_ptr(), pair_of_slot.data_ptr(), queries.data_ptr(), vectors.data_ptr(),
         norms.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), out.data_ptr()],
        [g, qpc, np_, pmax, vectors.shape[2], int(vectors.dtype == torch.bfloat16)],
        vectors.device,
    )


def ivf_flat_grouped_scan(
    probe_ids: torch.Tensor,  # (Q, NP) int32
    queries: torch.Tensor,    # (Q, D) f32
    vectors: torch.Tensor,    # (P, pmax, D) f32 or bf16
    norms: torch.Tensor,      # (P, pmax) f32, penalties pre-added
    alpha: torch.Tensor,      # (Q,) f32
    gamma: torch.Tensor,      # (Q,) f32
    qpc: int = 8,
) -> torch.Tensor:
    """Grouped probe-scan distances → (Q, NP, pmax) f32.

    On the card: the pairs are grouped by partition (``grouped_plan``),
    then one launch of the CUDA kernel on the current stream reads each
    group's block once for its ≤ qpc queries. On the CPU: the plain
    version. Unlike the TPU kernel this takes any D (no multiple of 128)
    and reads bf16 storage without a converted copy."""
    dev = vectors.device
    if dev.type == "cpu":
        return ivf_flat_scan_reference(probe_ids, queries, vectors, norms, alpha, gamma)
    if dev.type != "cuda":
        raise ValueError(f"ivf_flat_grouped_scan runs on cuda or cpu tensors, got {dev}")
    q, np_, p, pmax, d = _check_args(probe_ids, queries, vectors, norms, alpha, gamma)
    if not 1 <= qpc <= MAX_QPC:
        raise ValueError(f"qpc {qpc} must be in [1, {MAX_QPC}]")
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=dev)
    if q * np_ == 0 or pmax == 0:
        return out
    gpid, pair_of_slot, g = grouped_plan(probe_ids, p, qpc)
    launch_grouped(gpid, pair_of_slot, g, qpc, queries, vectors, norms, alpha, gamma, out)
    count_launch("ivf_flat_grouped_scan")
    return out


def pair_geometry(q: int, np_: int, pmax: int, d: int, esize: int, sms: int) -> dict:
    """Launch geometry of the per-pair kernel (``csrc/ivf_flat_scan.cu``)
    for a card of ``sms`` SMs, on (Q, NP) pairs of blocks of pmax rows of
    D elements of ``esize`` bytes:

      pitch:       bytes of a staged row, D x esize rounded up to 16;
      lanes, cpl:  lanes that share a row and 16-byte chunks each takes
                   (8 x 4 up to 512-byte rows, then 16 x 4, 32 x 4,
                   32 x 16);
      tile_rows:   rows of one of the two stages, about PAIR_STAGE bytes,
                   a multiple of the rows one pass of the block's 8 warps
                   sums (8 x 32 / lanes), no more than pmax needs;
      npb:         probes of one query a block takes, so that the grid
                   is about PAIR_WAVES waves of resident blocks;
      smem:        the block's dynamic shared memory, as the kernel's
                   ``ivf_flat_scan_smem_bytes`` counts.

    Raises on rows wider than 512 chunks (D above 2048 f32 or 4096 bf16)."""
    pitch = round_up(d * esize, 16)
    nchunks = pitch // 16
    for lanes, cpl in ((8, 4), (16, 4), (32, 4), (32, 16)):
        if nchunks <= lanes * cpl:
            break
    else:
        raise ValueError(f"per-pair scan rows of {pitch} bytes exceed {32 * 16 * 16}")
    unit = 8 * (32 // lanes)
    tile_rows = min(max(unit, PAIR_STAGE // pitch // unit * unit), round_up(max(pmax, 1), unit))
    smem = 2 * tile_rows * pitch
    per_sm = max(1, min(SM_BLOCKS, SM_SMEM // (smem + 1024)))
    npb = max(1, min(np_, q * np_ // (PAIR_WAVES * sms * per_sm)))
    return {"pitch": pitch, "lanes": lanes, "cpl": cpl, "tile_rows": tile_rows, "npb": npb,
            "smem": smem}


def ivf_flat_scan(
    probe_ids: torch.Tensor,  # (Q, NP) int32
    queries: torch.Tensor,    # (Q, D) f32
    vectors: torch.Tensor,    # (P, pmax, D) f32 or bf16
    norms: torch.Tensor,      # (P, pmax) f32, penalties pre-added
    alpha: torch.Tensor,      # (Q,) f32
    gamma: torch.Tensor,      # (Q,) f32
) -> torch.Tensor:
    """Per-pair probe-scan distances → (Q, NP, pmax) f32: one CUDA block
    per (query, a few of its probes) on the card, streaming each probed
    block's rows through shared memory; the plain version on the CPU. The
    same function as ``ivf_flat_grouped_scan``; every pair reads its
    block."""
    dev = vectors.device
    if dev.type == "cpu":
        return ivf_flat_scan_reference(probe_ids, queries, vectors, norms, alpha, gamma)
    if dev.type != "cuda":
        raise ValueError(f"ivf_flat_scan runs on cuda or cpu tensors, got {dev}")
    q, np_, p, pmax, d = _check_args(probe_ids, queries, vectors, norms, alpha, gamma)
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=dev)
    if q * np_ == 0 or pmax == 0:
        return out
    geo = pair_geometry(q, np_, pmax, d, vectors.element_size(), _sm_count(dev))
    launch(
        "ivf_flat_scan",
        [probe_ids.data_ptr(), queries.data_ptr(), vectors.data_ptr(), norms.data_ptr(),
         alpha.data_ptr(), gamma.data_ptr(), out.data_ptr()],
        [q, np_, pmax, d, int(vectors.dtype == torch.bfloat16), geo["npb"], geo["tile_rows"],
         geo["pitch"], geo["lanes"], geo["cpl"]], dev,
    )
    count_launch("ivf_flat_scan")
    return out


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
