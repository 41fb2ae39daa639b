"""The kernels of the design probes: the counterparts of the TPU kernels
of the reference's timing scripts, ``scripts/ab_adc8.py`` (S1: the ADC
scan's LUT sum in two inner-loop designs) and ``scripts/ab_gather_min.py``
(S2: a table gather inside a kernel). No search path runs them; the
probes in ``lancedb_tpu_torch.probes`` and ``chip_smoke.py`` do.

``adc_sum`` launches ``csrc/adc_sum_ab.cu`` and ``smem_gather`` launches
``csrc/smem_gather.cu`` for tensors on the card; for tensors on the CPU
they use their plain torch versions, ``adc_sum_reference`` and
``smem_gather_reference``. A CUDA input that a kernel refuses raises.
"""

from __future__ import annotations

import torch

from .cuda_build import launch, launch_counts, max_smem_bytes
from .util import cdiv, check_tensor

ADC_SUM_DESIGNS = ("select", "gather")
# S1's launch geometry, as csrc/adc_sum_ab.cu computes it: warps a block,
# slots a warp's unit (32 lanes x 4), blocks an SM at most, and the shared
# memory the card keeps for each block
ADC_SUM_WARPS = 8
ADC_SUM_UNIT_SLOTS = 128
ADC_SUM_BLOCKS_PER_SM = 4
SMEM_RESERVED = 1024


def adc_sum_reference(dlut: torch.Tensor, codes: torch.Tensor, ncells: int,
                      max_chunk_bytes: int = 1 << 28) -> torch.Tensor:
    """Plain torch version of S1's function → (ncells, pmax) f32:
    out[c, p] = Σ_s dlut[c mod Q, s, codes[c mod P, s, p]], a gather and a
    sum, chunked over cells so the int64 index stays bounded."""
    q, s, k = dlut.shape
    p, _, pmax = codes.shape
    out = torch.empty((ncells, pmax), dtype=torch.float32, device=codes.device)
    step = max(1, max_chunk_bytes // max(1, s * pmax * 12))
    for c0 in range(0, ncells, step):
        cells = torch.arange(c0, min(ncells, c0 + step), device=codes.device)
        idx = codes[cells % p].long()  # (c, S, pmax)
        out[c0 : c0 + len(cells)] = torch.gather(dlut[cells % q].float(), 2, idx).sum(dim=1)
    return out


def adc_sum_geometry(q: int, s: int, k: int, ncells: int, pmax: int, smem_limit: int,
                     sms: int) -> dict:
    """Launch geometry of S1's kernel (``csrc/adc_sum_ab.cu``, which
    computes the same in C) on a card of ``sms`` SMs whose blocks may use
    ``smem_limit`` bytes of shared memory (ncells, pmax ≥ 1). A unit is a
    warp's work, one cell's codes over ADC_SUM_UNIT_SLOTS slots:

      staged:  whether each warp's two code stages (S x 128 bytes each)
               fit beside the S x K f32 LUT; else each lane reads its codes
               from device memory;
      smem:    the block's dynamic shared memory, the stages and the LUT;
      units:   units of one query a block sums (cell c uses query c mod q's
               LUT, which the block stages once), so that the grid is one
               wave: ADC_SUM_BLOCKS_PER_SM blocks an SM, or as many as the
               SM's shared memory holds (the limit and one SMEM_RESERVED
               more, and one a block), over the queries that own a cell;
      blocks:  the grid."""
    lut = s * k * 4
    stages = 2 * ADC_SUM_WARPS * s * ADC_SUM_UNIT_SLOTS
    if stages + lut > smem_limit:
        stages = 0
    smem = stages + lut
    resident = max(1, min(ADC_SUM_BLOCKS_PER_SM,
                          (smem_limit + SMEM_RESERVED) // (smem + SMEM_RESERVED)))
    queries = min(q, ncells)
    per_query = cdiv(ncells, q) * cdiv(pmax, ADC_SUM_UNIT_SLOTS)  # units of query 0
    units = cdiv(per_query, max(1, min(per_query, resident * sms // queries)))
    return {"units": units, "blocks": queries * cdiv(per_query, units), "staged": stages > 0,
            "smem": smem}


def adc_sum(dlut: torch.Tensor, codes: torch.Tensor, ncells: int,
            design: str = "gather") -> torch.Tensor:
    """S1's function → (ncells, pmax) f32, by a select with no lookup at a
    data-dependent address (``design="select"``: warp shuffles of the LUT
    row held in registers) or the LUT gather (``"gather"``): one launch on
    the card, the plain version on the CPU. Both designs give the same
    bits. Every code must be below K; the kernel does not check it."""
    if design not in ADC_SUM_DESIGNS:
        raise ValueError(f"design {design!r} must be one of {ADC_SUM_DESIGNS}")
    dev = codes.device
    if dev.type == "cpu":
        return adc_sum_reference(dlut, codes, ncells)
    if dev.type != "cuda":
        raise ValueError(f"adc_sum runs on cuda or cpu tensors, got {dev}")
    q, s, k = dlut.shape
    p, _, pmax = codes.shape
    check_tensor(dlut, "dlut", torch.float32, (q, s, k), dev)
    check_tensor(codes, "codes", torch.uint8, (p, s, pmax), dev)
    if not 1 <= k <= 256:
        raise ValueError(f"codebook size {k} must be in [1, 256] for uint8 codes")
    smem, limit = s * k * 4, max_smem_bytes()
    if smem > limit:
        raise ValueError(f"a {s}x{k} f32 LUT needs {smem} bytes of shared memory; the card "
                         f"allows {limit}")
    out = torch.empty((ncells, pmax), dtype=torch.float32, device=dev)
    if ncells == 0 or pmax == 0:
        return out
    launch("adc_sum_ab", [dlut.data_ptr(), codes.data_ptr(), out.data_ptr()],
           [ncells, q, p, s, k, pmax, ADC_SUM_DESIGNS.index(design)], dev)
    launch_counts[f"adc_sum_{design}"] += 1
    return out


def smem_gather_reference(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain torch version of S2's function: ``take_along_dim``."""
    return torch.take_along_dim(x, idx.long(), dim=axis)


def smem_gather(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """take_along_axis(x, idx, axis) for an (s, w) f32 table and int32
    index, with the table staged in shared memory: one launch on the
    card, the plain version on the CPU. Every index must lie inside the
    table; the kernel does not check it."""
    if axis not in (0, 1):
        raise ValueError(f"axis {axis} must be 0 or 1")
    dev = x.device
    if dev.type == "cpu":
        return smem_gather_reference(x, idx, axis)
    if dev.type != "cuda":
        raise ValueError(f"smem_gather runs on cuda or cpu tensors, got {dev}")
    s, w = x.shape
    check_tensor(x, "x", torch.float32, (s, w), dev)
    check_tensor(idx, "idx", torch.int32, (s, w), dev)
    smem, limit = s * w * 4, max_smem_bytes()
    if smem > limit:
        raise ValueError(f"an ({s}, {w}) f32 table needs {smem} bytes of shared memory; the "
                         f"card allows {limit}")
    out = torch.empty((s, w), dtype=torch.float32, device=dev)
    if s * w == 0:
        return out
    launch("smem_gather", [x.data_ptr(), idx.data_ptr(), out.data_ptr()], [s, w, axis], dev)
    launch_counts["smem_gather"] += 1
    return out
