"""Fused IVF_PQ ADC probe scans: the counterparts of the reference's
ops/pallas_adc.py ``ivf_pq_adc_scan_pallas`` (B1, the one IVF_PQ search
runs) and ``ivf_pq_adc_grouped_scan_pallas`` (B3, the same scan with the
pairs grouped by partition, which only the probes run).

``ivf_pq_adc_scan`` launches the hand-written CUDA kernel
(``csrc/adc_scan.cu``) and ``ivf_pq_adc_grouped_scan`` launches
``csrc/adc_grouped_scan.cu`` for tensors on the card; for tensors on the
CPU they use their plain torch versions, ``ivf_pq_adc_scan_reference``
and ``ivf_pq_adc_grouped_scan_reference``. There is no fallback between
the two: a CUDA input that a kernel refuses raises.

B1's output, for query q, probe j and slot p of partition pid = probe_ids[q, j]:

    out[q, j, p] = qn2[q] − 2·(qc[q, j] + Σ_s dlut[q, s, codes[pid, s, p]]) + rnorms[pid, p]

B3's is the same up to rounding for K > 64. For K ≤ 64 it sums the LUT
rounded to bf16, as the TPU kernel's one-hot cell does (see
``ivf_pq_adc_grouped_scan_reference``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import launch, launch_counts, load, max_smem_bytes
from .cuda_build import reset_launch_counts  # noqa: F401
from .util import MAX_QPC, grouped_plan, round_up
from .util import check_tensor as _check

# the index layout the reference's kernel requires, kept so both packages
# read and write the same files: pmax a multiple of 128, S of 8
PMAX_ALIGN = 128
S_ALIGN = 8
# codebook size up to which the reference's grouped kernel takes its
# one-hot cell, whose matrix product rounds the LUT to bf16
SELECT_MAX_K = 64
# shared memory the grouped kernel gives the LUTs it stages at once
GROUPED_LUT_BUDGET = 64 * 1024
# bytes of gathered codes and partial sums one chunk of B3's plain version holds
_CHUNK_BYTES = 1 << 28


def ivf_pq_adc_scan_reference(
    probe_ids: torch.Tensor,  # (Q, NP) int
    dlut: torch.Tensor,       # (Q, S, K) f32
    codes: torch.Tensor,      # (P, S, pmax) uint8
    rnorms: torch.Tensor,     # (P, pmax) f32, penalties pre-added
    qc_dots: torch.Tensor,    # (Q, NP) f32
    qn2: torch.Tensor,        # (Q,) f32
    max_chunk_bytes: int = 1 << 28,
) -> torch.Tensor:
    """Plain torch version: gather the LUT entries and sum over S,
    chunked over queries so the int64 gather index stays bounded."""
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    k = dlut.shape[2]
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=codes.device)
    per_query = max(1, np_ * s * pmax * 8)
    step = max(1, max_chunk_bytes // per_query)
    pids_all = probe_ids.long()
    for q0 in range(0, q, step):
        q1 = min(q, q0 + step)
        pids = pids_all[q0:q1]
        idx = codes[pids].long()  # (c, NP, S, pmax)
        lut = dlut[q0:q1].float()[:, None].expand(q1 - q0, np_, s, k)
        acc = torch.gather(lut, 3, idx).sum(dim=2)  # (c, NP, pmax)
        out[q0:q1] = (
            qn2[q0:q1, None, None].float() - 2.0 * (qc_dots[q0:q1, :, None].float() + acc)
            + rnorms[pids].float()
        )
    return out


def ivf_pq_adc_scan(
    probe_ids: torch.Tensor,  # (Q, NP) int32
    dlut: torch.Tensor,       # (Q, S, K) f32
    codes: torch.Tensor,      # (P, S, pmax) uint8
    rnorms: torch.Tensor,     # (P, pmax) f32, penalties pre-added
    qc_dots: torch.Tensor,    # (Q, NP) f32
    qn2: torch.Tensor,        # (Q,) f32
) -> torch.Tensor:
    """Fused probe-scan distances → (Q, NP, pmax) f32.

    On the card: one launch of the CUDA kernel on the current stream.
    On the CPU: the plain version."""
    dev = codes.device
    if dev.type == "cpu":
        return ivf_pq_adc_scan_reference(probe_ids, dlut, codes, rnorms, qc_dots, qn2)
    if dev.type != "cuda":
        raise ValueError(f"ivf_pq_adc_scan runs on cuda or cpu tensors, got {dev}")
    q, np_ = probe_ids.shape
    p, s, pmax = codes.shape
    k = dlut.shape[2]
    _check(probe_ids, "probe_ids", torch.int32, (q, np_), dev)
    _check(dlut, "dlut", torch.float32, (q, s, k), dev)
    _check(codes, "codes", torch.uint8, (p, s, pmax), dev)
    _check(rnorms, "rnorms", torch.float32, (p, pmax), dev)
    _check(qc_dots, "qc_dots", torch.float32, (q, np_), dev)
    _check(qn2, "qn2", torch.float32, (q,), dev)
    if not 1 <= k <= 256:
        raise ValueError(f"codebook size {k} must be in [1, 256] for uint8 codes")
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=dev)
    if q * np_ == 0 or pmax == 0:
        return out
    smem = s * k * 4
    limit = max_smem_bytes()
    if smem > limit:
        raise ValueError(
            f"ADC LUT of {s}x{k} f32 needs {smem} bytes of shared memory; the card allows {limit}"
        )
    launch(
        "adc_scan",
        [probe_ids.data_ptr(), dlut.data_ptr(), codes.data_ptr(), rnorms.data_ptr(),
         qc_dots.data_ptr(), qn2.data_ptr(), out.data_ptr()],
        [q, np_, s, k, pmax], dev,
    )
    launch_counts["ivf_pq_adc_scan"] += 1
    return out


def ivf_pq_adc_grouped_scan_reference(
    probe_ids: torch.Tensor,  # (Q, NP) int
    dlut: torch.Tensor,       # (Q, S, K) f32
    codes: torch.Tensor,      # (P, S, pmax) uint8
    rnorms: torch.Tensor,     # (P, pmax) f32, penalties pre-added
    qc_dots: torch.Tensor,    # (Q, NP) f32
    qn2: torch.Tensor,        # (Q,) f32
) -> torch.Tensor:
    """Plain torch version of B3's arithmetic, in pair order: the base
    qn2 − 2·qc in f32; the LUT rounded to bf16 when K ≤ SELECT_MAX_K (the
    one-hot cell's bf16 operand) and kept in f32 above (the gather cell);
    the S lookups summed in f32, subvector by subvector as the CUDA kernel
    sums them; then (base − 2·qdotr) + rnorms. Chunked over queries so
    the gathered codes stay bounded."""
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    k = dlut.shape[2]
    lut = dlut.float()
    if k <= SELECT_MAX_K:
        lut = lut.bfloat16().float()
    base = qn2[:, None].float() - 2.0 * qc_dots.float()  # (Q, NP)
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=codes.device)
    step = max(1, _CHUNK_BYTES // max(1, np_ * pmax * (s + 16)))
    pids_all = probe_ids.long()
    for q0 in range(0, q, step):
        q1 = min(q, q0 + step)
        pids = pids_all[q0:q1]
        blk = codes[pids]  # (c, NP, S, pmax)
        acc = torch.zeros((q1 - q0, np_, pmax), dtype=torch.float32, device=codes.device)
        for si in range(s):
            row = lut[q0:q1, si][:, None].expand(q1 - q0, np_, k)
            acc = acc + torch.gather(row, 2, blk[:, :, si].long())
        out[q0:q1] = (base[q0:q1, :, None] - 2.0 * acc) + rnorms[pids].float()
    return out


def _grouped_lpc(s: int, k: int, qpc: int) -> tuple[int, int]:
    """(LUTs the grouped kernel stages at once, its shared memory bytes)."""
    lpc = max(1, min(qpc, GROUPED_LUT_BUDGET // (s * k * 4)))
    fn = load("adc_grouped_scan").adc_grouped_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return lpc, fn(s, k, lpc)


def launch_adc_grouped(gpid, pair_of_slot, g: int, qpc: int, probe_ids, dlut, codes, rnorms,
                       qc_dots, qn2, out) -> None:
    """One launch of the grouped kernel on a plan from ``grouped_plan``
    (arguments already checked), writing ``out`` (Q, NP, pmax)."""
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    k = dlut.shape[2]
    lpc, smem = _grouped_lpc(s, k, qpc)
    limit = max_smem_bytes()
    if smem > limit:
        raise ValueError(
            f"grouped ADC scan at S={s}, K={k} needs {smem} bytes of shared memory for its "
            f"code tile and one LUT; the card allows {limit}"
        )
    launch(
        "adc_grouped_scan",
        [gpid.data_ptr(), pair_of_slot.data_ptr(), dlut.data_ptr(), codes.data_ptr(),
         rnorms.data_ptr(), qc_dots.data_ptr(), qn2.data_ptr(), out.data_ptr()],
        [g, qpc, lpc, np_, s, k, pmax, int(k <= SELECT_MAX_K)], codes.device,
    )


def ivf_pq_adc_grouped_scan(
    probe_ids: torch.Tensor,  # (Q, NP) int32
    dlut: torch.Tensor,       # (Q, S, K) f32
    codes: torch.Tensor,      # (P, S, pmax) uint8
    rnorms: torch.Tensor,     # (P, pmax) f32, penalties pre-added
    qc_dots: torch.Tensor,    # (Q, NP) f32
    qn2: torch.Tensor,        # (Q,) f32
    qpc: int = 8,
) -> torch.Tensor:
    """Grouped probe-scan distances → (Q, NP, pmax) f32.

    On the card: the pairs are grouped by partition (``grouped_plan``),
    then one launch of the CUDA kernel on the current stream reads each
    group's codes once for its ≤ qpc queries. On the CPU: the plain
    version, which ``qpc`` does not change."""
    dev = codes.device
    if not 1 <= qpc <= MAX_QPC:
        raise ValueError(f"qpc {qpc} must be in [1, {MAX_QPC}]")
    if dev.type == "cpu":
        return ivf_pq_adc_grouped_scan_reference(probe_ids, dlut, codes, rnorms, qc_dots, qn2)
    if dev.type != "cuda":
        raise ValueError(f"ivf_pq_adc_grouped_scan runs on cuda or cpu tensors, got {dev}")
    q, np_ = probe_ids.shape
    p, s, pmax = codes.shape
    k = dlut.shape[2]
    _check(probe_ids, "probe_ids", torch.int32, (q, np_), dev)
    _check(dlut, "dlut", torch.float32, (q, s, k), dev)
    _check(codes, "codes", torch.uint8, (p, s, pmax), dev)
    _check(rnorms, "rnorms", torch.float32, (p, pmax), dev)
    _check(qc_dots, "qc_dots", torch.float32, (q, np_), dev)
    _check(qn2, "qn2", torch.float32, (q,), dev)
    if not 1 <= k <= 256:
        raise ValueError(f"codebook size {k} must be in [1, 256] for uint8 codes")
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=dev)
    if q * np_ == 0 or pmax == 0:
        return out
    gpid, pair_of_slot, g = grouped_plan(probe_ids, p, qpc)
    launch_adc_grouped(gpid, pair_of_slot, g, qpc, probe_ids, dlut, codes, rnorms, qc_dots,
                       qn2, out)
    launch_counts["ivf_pq_adc_grouped_scan"] += 1
    return out


def pad_codes_for_pallas(codes_psp: np.ndarray) -> np.ndarray:
    """Pad a (P, S, pmax) code array to the index alignment (S→8,
    pmax→128). Padded subvector rows hold code 0 against zero LUT rows;
    padded slots are masked by +inf rnorms."""
    p, s, pmax = codes_psp.shape
    s_pad, pmax_pad = round_up(s, S_ALIGN), round_up(pmax, PMAX_ALIGN)
    if (s_pad, pmax_pad) != (s, pmax):
        codes_psp = np.pad(codes_psp, ((0, 0), (0, s_pad - s), (0, pmax_pad - pmax)))
    return codes_psp


def build_dlut_padded(q: np.ndarray, codebooks: np.ndarray, s_pad: int) -> np.ndarray:
    """Per-query dot LUT dlut[q, s, c] = q_s · cb[s, c], with zero rows
    for the padded subvectors."""
    qf = np.asarray(q, dtype=np.float32)
    nsub, k, dsub = codebooks.shape
    qs = qf.reshape(qf.shape[0], nsub, dsub)
    dlut = np.einsum("qsd,skd->qsk", qs, codebooks.astype(np.float32))
    if s_pad != nsub:
        dlut = np.pad(dlut, ((0, 0), (0, s_pad - nsub), (0, 0)))
    return dlut.astype(np.float32)
