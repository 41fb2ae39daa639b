"""A/B of the grouped ADC scan (B3) against the per-pair scan (B1) and the
one-hot einsum at SIFT1M-class shapes (P 1024, pmax 1024, Q 128,
nprobes 20; (S, K) = (16, 16), (16, 256), (48, 16)), on the card: the
port of the reference's scripts/probe_adc_grouped.py.

    python -m lancedb_tpu_torch.probes.probe_adc_grouped

The probes are clustered as the script's are: groups of 8 queries share
a center and probe 20 of the 64 partitions after it, so partitions are
shared as in a real IVF batch. Each route is timed over 20 calls with
the probe ids shifted by the call's number (mod P), CUDA events around
the run, best of 3. Each B3 output is held to its plain version, and at
K = 256, where B3 keeps the LUT in f32, also to B1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.adc import (
    ivf_pq_adc_grouped_scan,
    ivf_pq_adc_grouped_scan_reference,
    ivf_pq_adc_scan,
)
from .common import compare, loop_ms, print_records, require_cuda

P, PMAX, Q, NP = 1024, 1024, 128, 20
SHAPES = ((16, 16), (16, 256), (48, 16))
QPCS = (8, 16)
SEED = 0
ITERS = 20  # calls per timed run of a kernel route
ONEHOT_ITERS = 3  # calls per timed run of the one-hot einsum (10-100 ms each)


def make_inputs(rng, s: int, k: int, device, p=P, pmax=PMAX, q=Q, np_=NP):
    """The script's inputs for one (S, K), drawn from ``rng`` in its
    order: (probe_ids, dlut, codes, rnorms, qc, qn2) on ``device``."""
    codes = rng.integers(0, k, (p, s, pmax), dtype=np.uint8)
    dlut = rng.standard_normal((q, s, k)).astype(np.float32)
    rnorms = rng.standard_normal((p, pmax)).astype(np.float32) ** 2
    qc = rng.standard_normal((q, np_)).astype(np.float32)
    qn2 = rng.standard_normal(q).astype(np.float32) ** 2
    # clustered probes: queries share partitions (realistic for IVF)
    centers = rng.integers(0, p, q // 8)
    probe_ids = np.stack([
        (centers[i // 8] + rng.choice(64, np_, replace=False)) % p for i in range(q)
    ]).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (probe_ids, dlut, codes, rnorms, qc,
                                                           qn2))


def onehot_scan(probe_ids, dlut, codes, rnorms, qc, qn2, max_chunk_bytes: int = 1 << 28):
    """The script's ``xla_onehot`` baseline in plain torch (the reference's
    XLA formulation of the probed scan): per probe step, a one-hot of the
    probed codes, (queries, pmax, S·K), times the bf16-rounded LUT, summed
    in f32, then qn2 − 2·(qc + qdotr) + rnorms. Chunked over queries so
    the one-hot stays bounded."""
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    k = dlut.shape[2]
    lut = dlut.bfloat16().float().reshape(q, s * k, 1)
    steps = torch.arange(k, dtype=torch.uint8, device=codes.device)
    out = torch.empty((q, np_, pmax), dtype=torch.float32, device=codes.device)
    step = max(1, max_chunk_bytes // (pmax * s * k * 5))  # bool + f32 one-hot
    for j in range(np_):
        pj = probe_ids[:, j].long()
        for q0 in range(0, q, step):
            q1 = min(q, q0 + step)
            blk = codes[pj[q0:q1]].transpose(1, 2)  # (c, pmax, S)
            oh = (blk[..., None] == steps).to(torch.float32).reshape(q1 - q0, pmax, s * k)
            qdotr = torch.bmm(oh, lut[q0:q1])[..., 0]  # (c, pmax)
            out[q0:q1, j] = (qn2[q0:q1, None] - 2.0 * (qc[q0:q1, j, None] + qdotr)
                             + rnorms[pj[q0:q1]])
    return out


def check(args, qpc: int) -> dict:
    """Hold B3 at ``qpc`` to its plain version and, at K = 256, to B1."""
    k = args[1].shape[2]
    got = ivf_pq_adc_grouped_scan(*args, qpc=qpc)
    out = {"max_abs_err": compare(got, ivf_pq_adc_grouped_scan_reference(*args),
                                  f"B3 qpc={qpc} K={k}")}
    if k > 64:
        out["max_abs_err_vs_b1"] = compare(got, ivf_pq_adc_scan(*args), f"B3 vs B1 K={k}")
    return out


def run() -> list[dict]:
    """Time every route at every (S, K) on the card; one record per
    (S, K, route)."""
    dev = require_cuda()
    rng = np.random.default_rng(SEED)
    records = []
    for s, k in SHAPES:
        args = make_inputs(rng, s, k, dev)
        probe_ids, rest = args[0], args[1:]
        shifted = [((probe_ids + i) % P).to(torch.int32) for i in range(ITERS)]
        routes = [
            ("onehot einsum (plain torch)", lambda pid: onehot_scan(pid, *rest), ONEHOT_ITERS),
            ("per-pair B1", lambda pid: ivf_pq_adc_scan(pid, *rest), ITERS),
        ] + [
            (f"grouped B3 qpc={qpc}",
             lambda pid, qpc=qpc: ivf_pq_adc_grouped_scan(pid, *rest, qpc=qpc), ITERS)
            for qpc in QPCS
        ]
        checks = {f"grouped B3 qpc={qpc}": check(args, qpc) for qpc in QPCS}
        for name, fn, n in routes:
            ms = loop_ms([lambda pid=pid: fn(pid) for pid in shifted[:n]])
            records.append({"S": s, "K": k, "route": name, "ms_per_batch": ms,
                            "qps": Q / ms * 1e3, "calls_timed": n, **checks.get(name, {})})
        del args, rest, shifted
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    print_records("probe_adc_grouped", run())
