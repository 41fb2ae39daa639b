"""A/B of the ADC scan's inner loop on the card, compare-select sweep
against table gather (S1), at bench-like shapes: the port of the
reference's scripts/ab_adc8.py.

    python -m lancedb_tpu_torch.probes.ab_adc8

Q 128 queries x 20 probes = 2560 cells over P 1402 partitions of pmax
1280 slots; cell c sums the LUT of query c mod Q over the codes of
partition c mod P. Two codings: 8-bit (S 16, K 256) and 4-bit (S 32,
K 16). Each design is timed over 10 launches (CUDA events), held to the
plain version in full, and checked on cell 37's first 256 slots against
a numpy oracle, as the script checks it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.probe_kernels import ADC_SUM_DESIGNS, adc_sum, adc_sum_reference
from .common import compare, loop_ms, print_records, require_cuda

Q, NP = 128, 20
P, PMAX, PB = 1402, 1280, 256
NCELLS = Q * NP
CASES = ((8, 16, 256), (4, 32, 16))  # (bits, S, K)
REPS = 10
SEED = 0


def make_inputs(rng, s: int, k: int, q=Q, p=P, pmax=PMAX):
    """The script's inputs for one coding, as numpy: (dlut (Q, S, K) f32,
    codes (P, S, pmax) uint8)."""
    dlut = rng.standard_normal((q, s, k)).astype(np.float32)
    codes = rng.integers(0, k, (p, s, pmax), dtype=np.uint8)
    return dlut, codes


def cell_error(out: np.ndarray, dlut: np.ndarray, codes: np.ndarray, c0: int = 37) -> float:
    """The script's check: cell c0's first PB slots against numpy."""
    q, s, _ = dlut.shape
    want = dlut[c0 % q][np.arange(s)[:, None], codes[c0 % codes.shape[0]][:, :PB].astype(int)]
    return float(np.abs(out[c0, :PB] - want.sum(0)).max())


def run() -> list[dict]:
    """Both designs at both codings on the card; one record per
    (coding, design). The designs and the plain version are timed alike:
    per call in a run of REPS calls."""
    dev = require_cuda()
    rng = np.random.default_rng(SEED)
    records = []
    for bits, s, k in CASES:
        dlut, codes = make_inputs(rng, s, k)
        dlut_d, codes_d = torch.from_numpy(dlut).to(dev), torch.from_numpy(codes).to(dev)
        want = adc_sum_reference(dlut_d, codes_d, NCELLS)
        plain_ms = loop_ms([lambda: adc_sum_reference(dlut_d, codes_d, NCELLS)] * REPS)
        for design in ADC_SUM_DESIGNS:
            ms = loop_ms([lambda: adc_sum(dlut_d, codes_d, NCELLS, design)] * REPS)
            got = adc_sum(dlut_d, codes_d, NCELLS, design)
            records.append({
                "bits": bits, "S": s, "K": k, "design": design, "ms_per_scan": ms,
                "qps_equiv": Q / ms * 1e3, "plain_ms": plain_ms,
                "max_abs_err": compare(got, want, f"S1 {design} {bits}-bit"),
                "cell37_err": cell_error(got.cpu().numpy(), dlut, codes),
            })
        del dlut_d, codes_d, want
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    print_records("ab_adc8", run())
