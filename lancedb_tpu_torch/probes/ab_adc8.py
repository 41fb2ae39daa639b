"""A/B of the ADC scan's inner loop on the card, a select with no lookup
at a data-dependent address against a table gather (S1), at bench-like
shapes: the port of the reference's scripts/ab_adc8.py.

    python -m lancedb_tpu_torch.probes.ab_adc8

Q 128 queries x 20 probes = 2560 cells over P 1402 partitions of pmax
1280 slots; cell c sums the LUT of query c mod Q over the codes of
partition c mod P. Two codings: 8-bit (S 16, K 256) and 4-bit (S 32,
K 16). Each design is timed over 10 launches back to back (CUDA events),
on the card alone and with L2 flushed before each call; it is held to the
plain version in full and checked on cell 37's first 256 slots against a
numpy oracle, as the script checks it; the two designs must give the same
bits. Each record also carries the time the lookups take at one 4-byte
lookup a lane a clock on every SM, at the card's maximum SM clock.

``check_edges`` holds both designs to the plain version, and to each
other bit for bit, at the edge shapes of ``edge_cases``;
``partition_sweep`` times them with fewer or more cells sharing a
partition.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops.cuda_build import max_smem_bytes
from ..ops.probe_kernels import ADC_SUM_DESIGNS, adc_sum, adc_sum_geometry, adc_sum_reference
from .common import compare, cuda_ms_cold, device_ms, loop_ms, print_records, require_cuda

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


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.split()[0]) * 1e6


def edge_cases(smem_limit: int) -> list[dict]:
    """The shapes the kernel must handle beyond the probe's: K 1 / 16 / 48
    / 100 / 256 (1, 2, 4 and 8 register chunks for select), S 1 / 16 / 32, pmax 1,
    255, 1280, 1283, 1284 and 1288 (16-, 8- and 4-byte code copies and
    plain loads, one slot, ragged items), ncells not a multiple of Q, P
    above and below ncells; blocks of several cells over several code
    tiles; codes at an odd address; and a LUT that fills the card's
    shared memory, leaving no room for code stages (S = limit / 1 KiB at
    K 256)."""
    cases = [dict(k=k, s=s, pmax=pmax, q=5, p=p, ncells=23)
             for k in (1, 16, 48, 256) for s in (1, 16, 32)
             for pmax, p in ((1, 7), (255, 40), (1280, 7), (1283, 40), (1284, 7), (1288, 40))]
    cases += [dict(k=k, s=32, pmax=1283, q=2, p=3, ncells=2001) for k in (16, 100, 256)]
    cases += [dict(k=256, s=16, pmax=1280, q=3, p=50, ncells=40, offset=1),
              dict(k=256, s=smem_limit // 1024, pmax=255, q=3, p=4, ncells=10)]
    return cases


def check_edges(dev: torch.device, seed: int = 7) -> int:
    """Both designs at every edge case, each held to the plain version
    and select to gather bit for bit; raises on a difference. Returns the
    number of cases."""
    rng = np.random.default_rng(seed)
    cases = edge_cases(max_smem_bytes())
    for case in cases:
        dlut_np, codes_np = make_inputs(rng, case["s"], case["k"], case["q"], case["p"],
                                        case["pmax"])
        dlut = torch.from_numpy(dlut_np).to(dev)
        codes = torch.from_numpy(codes_np).to(dev)
        if case.get("offset"):  # the same codes, one byte past an aligned address
            buf = torch.empty(codes.numel() + case["offset"], dtype=torch.uint8, device=dev)
            codes = buf[case["offset"]:].view(codes.shape).copy_(codes)
        want = adc_sum_reference(dlut, codes, case["ncells"])
        got = {d: adc_sum(dlut, codes, case["ncells"], d) for d in ADC_SUM_DESIGNS}
        for design in ADC_SUM_DESIGNS:
            compare(got[design], want, f"S1 {design} edge {case}")
        if not torch.equal(got["select"], got["gather"]):
            raise AssertionError(f"S1 edge {case}: select and gather give other bits")
    return len(cases)


def partition_sweep(parts=(P, NCELLS, NCELLS // 2)) -> list[dict]:
    """Both designs at both codings with P varied, on the card alone: the
    probe's 1402 (about half the partitions read by two cells), 2560 (every
    cell its own partition) and 1280 (cell c + 1280 shares cell c's
    partition and query). Shows how far the time moves with the code bytes
    that come from device memory rather than L2."""
    dev = require_cuda()
    rng = np.random.default_rng(SEED)
    records = []
    for p in parts:
        for bits, s, k in CASES:
            dlut, codes = make_inputs(rng, s, k, p=p)
            dlut_d, codes_d = torch.from_numpy(dlut).to(dev), torch.from_numpy(codes).to(dev)
            for design in ADC_SUM_DESIGNS:
                def call(design=design):
                    return adc_sum(dlut_d, codes_d, NCELLS, design)

                records.append({"P": p, "bits": bits, "design": design,
                                "unique_code_bytes": min(p, NCELLS) * s * PMAX,
                                "device_ms": device_ms(call)})
            del dlut_d, codes_d
    return records


def run() -> list[dict]:
    """Both designs at both codings on the card; one record per
    (coding, design). The designs and the plain version are timed alike:
    per call in a run of REPS calls. Raises unless the designs give the
    same bits."""
    dev = require_cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lookups_per_s = sms * 32 * sm_clock_hz()  # one lookup a lane a clock on each SM
    rng = np.random.default_rng(SEED)
    records = []
    for bits, s, k in CASES:
        dlut, codes = make_inputs(rng, s, k)
        dlut_d, codes_d = torch.from_numpy(dlut).to(dev), torch.from_numpy(codes).to(dev)
        want = adc_sum_reference(dlut_d, codes_d, NCELLS)
        plain_ms = loop_ms([lambda: adc_sum_reference(dlut_d, codes_d, NCELLS)] * REPS)
        lookups = NCELLS * PMAX * s
        geometry = adc_sum_geometry(Q, s, k, NCELLS, PMAX, max_smem_bytes(), sms)
        outs = {}
        for design in ADC_SUM_DESIGNS:
            def call(design=design):
                return adc_sum(dlut_d, codes_d, NCELLS, design)

            ms = loop_ms([call] * REPS)
            outs[design] = got = call()
            records.append({
                "bits": bits, "S": s, "K": k, "design": design, "ms_per_scan": ms,
                "device_ms": device_ms(call), "cold_ms": cuda_ms_cold(call),
                "qps_equiv": Q / ms * 1e3, "plain_ms": plain_ms,
                "max_abs_err": compare(got, want, f"S1 {design} {bits}-bit"),
                "cell37_err": cell_error(got.cpu().numpy(), dlut, codes),
                "lookups": lookups, "lookup_ms": lookups / lookups_per_s * 1e3,
                "geometry": geometry,
            })
        if not torch.equal(outs["select"], outs["gather"]):
            raise AssertionError(f"S1 {bits}-bit: select and gather give other bits")
        del dlut_d, codes_d, want, outs, got
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    recs = run()
    recs.append({"edge_cases": check_edges(require_cuda())})
    print_records("ab_adc8", recs + partition_sweep())
