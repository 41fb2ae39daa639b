#!/usr/bin/env python3
"""Drive lancedb_tpu_torch end to end on one CUDA card and check it.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phase kernels # build and check the kernels only
    python3 chip_smoke.py --phase hnsw    # path e alone (or --phase large_d: path d)
    python3 chip_smoke.py --out smoke.json # also write the full summary as JSON

Phases:
  1. card: the card's name and power limit (nvidia-smi) and torch's name.
  2. kernels: build every CUDA source under lancedb_tpu_torch/csrc (one
     nvcc per source, all started together), then hold the plan kernel of
     the grouped scans (csrc/group_plan.cu) against grouped_plan_reference
     element for element (random probes at qpc 1, 8 and 32, a partition
     probed by every query, P far above Q x NP), under torch's sync debug
     mode, and time it beside the torch ops; then hold the ADC scan
     kernel (B1) and the grouped ADC scan kernel (B3, at qpc 8 and 16)
     against their plain torch versions at SIFT1M shapes (1024
     partitions, pmax 1152, 128 queries, 20 probes) for 8-bit x16 and
     4-bit x32 codes, with padding and penalty slots, and time them.
     It also holds the grouped and the per-pair IVF_FLAT scan kernels
     (B2, B4) against their plain version at the IVF_FLAT path's shapes
     (1402 blocks of pmax 1224, D 128, 128 queries, 27 probes), for f32
     and bf16 storage and the l2, cosine and dot forms, and times them.
     Kernel times are CUDA events around single calls: ``ms`` back to
     back, as a caller meets them (the host's launch included); for B1,
     B2 and the plan also ``device_ms`` (behind a spin kernel, so the
     host's launch is hidden) and for B1 and B2 ``cold_ms`` (L2 flushed by
     a 128 MB write before each call).
     Then it drives the probes of the ADC inner loop (S1, both designs,
     lancedb_tpu_torch.probes.ab_adc8) and of the shared-memory gather
     (S2, its eight shapes, probes.ab_gather_min), each with the launch
     counts set to 0 just before it and read just after.
  3. main path, at SIFT1M scale: connect() on the default device →
     create_table with 1,000,000 rows of 128-d clustered vectors (seed 0)
     plus id and category = id % 10, then three paths, each with the
     launch counts set to 0 just before it and read just after:
     a. create_index(IVF_PQ, 1024 partitions) → search 256 queries at
        nprobes 20, raw and with refine_factor 10, then again with
        where("category < 5"); first for 8-bit x16 codes, then 4-bit x32.
        After each index B1 is checked and timed on the inputs the
        searcher gives it for the first 128 queries, and one batch's time
        is broken down by layer (searcher, prefilter, slot penalty,
        device busy time under torch.profiler). Then the grouped route
        (probes.probe_pq_real.full_grouped: probe selection, LUT, B3 at
        qpc 8, top-k) serves the 256 queries in chunks of 128, with B3's
        launches counted from 0 over it; its recall is held to the raw
        bar, its top-10 compared with the per-pair (B1) route's, and B3
        checked and timed on the searcher's inputs beside B1.
     b. create_index(IVF_FLAT, 1024 partitions) → search at nprobes 8, 20
        and 64, at 20 with the filter, and at 20 with refine_factor 10
        (the host refine); B2 and B4 checked and timed on the inputs the
        searcher gives B2 for the first 128 queries at nprobes 20;
        the planner's full scan called directly, with the time of the
        stable sort over its distance matrix.
     c. create_index(FLAT) → search in precision float32, bfloat16 and
        the default two-pass; then one OPQ build (8-bit x16), raw and
        refined.
     e. HNSW (bench.py:1158 run_hnsw_config): IVF_HNSW_FLAT (m 20) on the
        table's first 500,000 rows, the bench's 256 queries: the device
        beam at ef 64 and 128 (profiled, its runs on the card counted
        from 0) and the host walk at ef 64 on 64 queries, with the build's
        stages and peak memory; IVF_HNSW_SQ on the same rows (beam, ef
        64) and IVF_HNSW_PQ on 50,000 rows (host walk, ef 64).
     Ground truth is exact f32 on the card; every recall bar is checked.
     The plan kernel must run once per grouped call (B2 on b, B3 on the
     grouped route), and it is checked on their inputs.
  4. probes: probes.probe_adc_grouped (B3 at qpc 8 and 16 against B1 and
     the one-hot einsum at P 1024, pmax 1024, 128 queries, 20 clustered
     probes), with the launch counts set to 0 just before it and read
     just after.
  5. path d, the BASELINE large-D configs (bench.py:891-895): gist_960d
     (1M x 960 l2, 2048 partitions, 4-bit x96) and openai_1536d_cosine
     (1M x 1536 cosine, 1024 partitions, 4-bit x192, where("cat = 3")),
     each on its own database with the bench's data and 32 queries:
     create_index(IvfPq) (its capacity mode, seconds, peak memory) →
     search at nprobes 20, raw and fused-refined (and filtered), B1's
     launches counted from 0 over each search; B1 held to its plain
     version on the searcher's inputs; the residual-free encode held to
     the buffered one on a 65,536-row slice. Recall bars: the
     reference's (BASELINE.md:87-88) less 0.03, refined at least 0.95.

Prints, on lines before the last, the card's name and power limit, a
``kernels:`` line and one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0. The script imports neither JAX nor lancedb_tpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
KERNELS = {  # launch counter: (id, source, the TPU kernel it replaces)
    "ivf_pq_adc_scan": ("B1", "lancedb_tpu_torch/csrc/adc_scan.cu",
                        "lancedb_tpu/ops/pallas_adc.py:126"),
    "ivf_flat_grouped_scan": ("B2", "lancedb_tpu_torch/csrc/ivf_flat_group_scan.cu",
                              "lancedb_tpu/ops/pallas_group_scan.py:66"),
    "ivf_pq_adc_grouped_scan": ("B3", "lancedb_tpu_torch/csrc/adc_grouped_scan.cu",
                                "lancedb_tpu/ops/pallas_adc.py:278"),
    "ivf_flat_scan": ("B4", "lancedb_tpu_torch/csrc/ivf_flat_scan.cu",
                      "lancedb_tpu/ops/pallas_scan.py:53"),
    "adc_sum_select": ("S1 select", "lancedb_tpu_torch/csrc/adc_sum_ab.cu",
                       "scripts/ab_adc8.py:59"),
    "adc_sum_gather": ("S1 gather", "lancedb_tpu_torch/csrc/adc_sum_ab.cu",
                       "scripts/ab_adc8.py:59"),
    "smem_gather": ("S2", "lancedb_tpu_torch/csrc/smem_gather.cu",
                    "scripts/ab_gather_min.py:11"),
    # not a TPU kernel: the plan of B2 and B3, which the reference computes in XLA ops
    "group_plan": ("B2/B3 plan", "lancedb_tpu_torch/csrc/group_plan.cu",
                   "lancedb_tpu/ops/util.py:56"),
}
FLAT_COUNTERS = {"grouped": "ivf_flat_grouped_scan", "pair": "ivf_flat_scan"}
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
# the reference's recall@10 at 1M x 128, 1024 partitions, nprobes 20
# (bench_details.json ivf_pq_8bit_np20 / ivf_pq_4bit_np20)
RAW_RECALL_BARS = {8: 0.7656, 4: 0.7375}
# the reference's recall@10 less 0.03 (bench_details.json ivf_flat_np8 /
# np20 / np64, planner full scan, flat two-pass, flat bf16 approximate)
FLAT_RECALL_BARS = {
    "ivf_flat_np8": 0.95, "ivf_flat_np20": 0.968, "ivf_flat_np64": 0.97,
    "ivf_flat_np20_filtered": 0.95, "ivf_flat_full_scan": 0.99,
    "flat_float32": 0.99, "flat_default": 0.99, "flat_bfloat16": 0.94,
}
# BASELINE configs #3 and #4 as the reference's bench runs them
# (bench.py:891-895 and run_big_pq_config: 32 queries, nprobes 20)
LARGE_D = {
    "gist_960d": dict(n=1_000_000, d=960, npart=2048, nsub=96, nbits=4, metric="l2",
                      prefilter=False, seed=3960),
    "openai_1536d_cosine": dict(n=1_000_000, d=1536, npart=1024, nsub=192, nbits=4,
                                metric="cosine", prefilter=True, seed=41536),
}


def large_d_data(cfg: dict, n_queries: int = 32):
    """A large-D config's rows, queries and ``cat`` column (None without
    the prefilter), drawn as run_big_pq_config draws them: make_clustered
    with the config's seed, rows and queries normalized for cosine, then
    cat from the same generator."""
    from lancedb_tpu_torch.probes.common import make_clustered

    rng = np.random.default_rng(cfg["seed"])
    x, q = make_clustered(rng, cfg["n"], cfg["d"], n_queries=n_queries)
    if cfg["metric"] == "cosine":
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    cats = rng.integers(0, 10, cfg["n"]) if cfg["prefilter"] else None
    return x, q, cats


# the reference's raw / refined recall@10 (BASELINE.md:87-88) less 0.03,
# refined at least the BASELINE metric's 0.95; the filtered refined bar is 0.95
LARGE_D_BARS = {"gist_960d": (0.658, 0.95), "openai_1536d_cosine": (0.711, 0.961)}
# run_hnsw_config (bench.py:1158): IVF_HNSW_FLAT, m 20, on the first 500,000
# rows; the reference's recall@10 less 0.03 (device beam 1.0 at ef 64 and
# 128, host walk 0.9375 at ef 64; BASELINE.md:131-160)
HNSW_ROWS, HNSW_PQ_ROWS = 500_000, 50_000
HNSW_BARS = {"device_ef64": 0.97, "device_ef128": 0.97, "host_ef64": 0.9075}
# IVF_HNSW_SQ (device beam, ef 64) and IVF_HNSW_PQ (host walk, ef 64): the
# reference's recall@10 on the CPU at 50,000 rows of the same table with
# the same queries, 0.9953 and 0.7422 (tests/hnsw_reference_bars.py), less 0.03
HNSW_STORAGE_BARS = {("hnsw_sq_500k", "device_ef64"): 0.9653,
                     ("hnsw_pq_50k", "host_ef64"): 0.7121}


def kernel_record(counter: str, name: str, max_abs: float, ms: float, plain_ms: float,
                  bytes_ms: float, ops_ms: float, library_ms=None, launches=None, **extra) -> dict:
    """One kernel's record with every key of KERNEL_KEYS, then ``extra``."""
    _, source, replaces = KERNELS[counter]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else
        "operations", "library_ms": library_ms, "counter": counter, **extra,
    }


def check_flat(kind: str, args, label: str) -> dict:
    """Hold B2 (kind 'grouped') or B4 ('pair') against the plain version
    on ``args``, time both, and compute the bound. For B2 also the launch
    alone on its plan, and both on the card alone and with L2 flushed
    before each call (cold). Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import flat_scan
    from lancedb_tpu_torch.ops.cuda_build import launch, launch_counts
    from lancedb_tpu_torch.ops.util import grouped_plan
    from lancedb_tpu_torch.probes.common import compare, cuda_ms, cuda_ms_cold, device_ms

    counter = FLAT_COUNTERS[kind]
    fn = flat_scan.ivf_flat_grouped_scan if kind == "grouped" else flat_scan.ivf_flat_scan
    saved = dict(launch_counts)  # comparison launches do not count
    want = flat_scan.ivf_flat_scan_reference(*args)
    max_abs = compare(fn(*args), want, label)
    ms = cuda_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: flat_scan.ivf_flat_scan_reference(*args))
    extra = {}
    probe_ids, queries, vectors, norms, alpha, gamma = args
    q, np_ = probe_ids.shape
    p, pmax, d = vectors.shape
    if kind == "grouped":
        extra["cold_ms"] = cuda_ms_cold(lambda: fn(*args))
        extra["device_ms"] = device_ms(lambda: fn(*args))
        # the launch alone, on a plan made beforehand
        gpid, pair_of_slot, g = grouped_plan(probe_ids, p, 8)
        out = torch.empty((q, np_, pmax), device=vectors.device)
        ptrs = [gpid.data_ptr(), pair_of_slot.data_ptr(), queries.data_ptr(), vectors.data_ptr(),
                norms.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), out.data_ptr()]
        ints = [g, 8, np_, pmax, d, int(vectors.dtype == torch.bfloat16)]
        def alone():
            launch("ivf_flat_group_scan", ptrs, ints, vectors.device)

        extra["kernel_only_ms"] = cuda_ms(alone)
        extra["kernel_only_cold_ms"] = cuda_ms_cold(alone)
        extra["kernel_only_device_ms"] = device_ms(alone)
        extra["groups"] = int((pair_of_slot.view(g, 8)[:, 0] >= 0).sum())
        del out
    del want
    launch_counts.update(saved)
    # least bytes: each probed block (rows and norms) once, the queries,
    # probe ids, alpha and gamma once, the output once
    n_parts = int(torch.unique(probe_ids).numel())
    nbytes = (
        n_parts * pmax * (d * vectors.element_size() + 4) + queries.numel() * 4
        + probe_ids.numel() * 4 + 2 * q * 4 + q * np_ * pmax * 4
    )
    ops = q * np_ * pmax * (2 * d + 3)  # D FMAs and the affine epilogue per slot
    # library_ms None: no single PyTorch call computes a probed scan
    rec = kernel_record(
        counter, f"{counter} ({str(vectors.dtype).replace('torch.', '')} storage)", max_abs,
        ms, plain_ms, nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3, **extra,
        shape={"Q": q, "NP": np_, "P": p, "pmax": pmax, "D": d, "probed_partitions": n_parts},
    )
    print(f"[kernel] {label}: {json.dumps(rec)}", flush=True)
    return rec


def check_plan(probe_ids, p: int, qpc: int, label: str, timed: bool = True) -> dict:
    """Hold the plan kernel (grouped_plan on the card) against
    grouped_plan_reference element for element on ``probe_ids``, with
    torch's sync debug mode: an error if the kernel's path makes the host
    wait, a record of whether the torch ops do. With ``timed``, time both
    and return a kernel record (the torch ops are both the plain version
    and the library yardstick). Raises on disagreement."""
    import warnings

    import torch

    from lancedb_tpu_torch.ops.cuda_build import launch_counts
    from lancedb_tpu_torch.ops.util import grouped_plan, grouped_plan_reference
    from lancedb_tpu_torch.probes.common import cuda_ms, device_ms

    saved = dict(launch_counts)  # comparison launches do not count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grouped_plan(probe_ids, p, qpc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            want = grouped_plan_reference(probe_ids, p, qpc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    same = got[2] == want[2] and all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    if not same:
        raise AssertionError(f"{label}: the plan kernel differs from grouped_plan_reference")
    extra = {"groups_bound": got[2], "groups": int((want[1].view(-1, qpc)[:, 0] >= 0).sum()),
             "reference_syncs": sum("synchroniz" in str(w.message) for w in caught)}
    if not timed:
        launch_counts.update(saved)
        print(f"[kernel] {label}: equal, {json.dumps(extra)}", flush=True)
        return extra
    ms = cuda_ms(lambda: grouped_plan(probe_ids, p, qpc))
    extra["device_ms"] = device_ms(lambda: grouped_plan(probe_ids, p, qpc))
    plain_ms = cuda_ms(lambda: grouped_plan_reference(probe_ids, p, qpc))
    launch_counts.update(saved)
    # least bytes: the probe ids read once, gpid and pair_of_slot written once
    nbytes = 4 * (probe_ids.numel() + got[0].numel() + got[1].numel())
    rec = kernel_record(
        "group_plan", f"group_plan (P={p}, S={probe_ids.numel()}, qpc={qpc})", 0.0, ms, plain_ms,
        nbytes / HBM_BYTES_PER_S * 1e3, 0.0, library_ms=plain_ms, **extra,
    )
    print(f"[kernel] {label}: {json.dumps(rec)}", flush=True)
    return rec


def synthetic_plan_checks() -> tuple[dict, list[dict]]:
    """The plan kernel against grouped_plan_reference on synthetic probe
    ids: the IVF_FLAT path's shapes (128 x 27 random probes over 1402
    blocks, a repeated probe) at qpc 1, 8 and 32; one partition probed by
    every query (more pairs than MAX_QPC) at qpc 1 and 32; P far above
    Q x NP, in shared memory above 48 KB (P 20,000) and in the global
    scratch (P 100,000). Returns (the timed qpc-8 record, the rest)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    probe = torch.randint(0, 1402, (128, 27), generator=gen, device="cuda", dtype=torch.int32)
    probe[:, 1] = probe[:, 0]
    timed = check_plan(probe, 1402, 8, "synthetic plan qpc=8")
    rest = [check_plan(probe, 1402, qpc, f"synthetic plan qpc={qpc}", timed=False)
            for qpc in (1, 32)]
    hot = probe.clone()
    hot[:, 2] = 5
    rest += [check_plan(hot, 1402, qpc, f"hot partition plan qpc={qpc}", timed=False)
             for qpc in (1, 32)]
    for p in (20_000, 100_000):
        wide = torch.randint(0, p, (16, 8), generator=gen, device="cuda", dtype=torch.int32)
        rest.append(check_plan(wide, p, 8, f"wide plan P={p}", timed=False))
    return timed, rest


def synthetic_flat_args(metric: str, dtype, p=1402, pmax=1224, d=128, q=128, np_=27, seed=0):
    """B2/B4 inputs at the IVF_FLAT path's shapes for one metric's
    (alpha, gamma, norms) form: padding rows (+3e38), filter penalties on
    a tenth of the slots (inf where they meet padding), a repeated probe."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    vectors = torch.randn((p, pmax, d), generator=g, device=dev)
    queries = torch.randn((q, d), generator=g, device=dev)
    if metric == "cosine":
        vectors = vectors / vectors.norm(dim=-1, keepdim=True)
        queries = queries / queries.norm(dim=-1, keepdim=True)
    pad = torch.zeros((p, pmax), device=dev)
    pad[:, pmax - 100 :] = 3.0e38
    if metric == "l2":
        alpha = torch.full((q,), -2.0, device=dev)
        gamma = (queries * queries).sum(-1)
        norms = (vectors * vectors).sum(-1) + pad
    else:
        alpha = (-1.0 / queries.norm(dim=-1)) if metric == "cosine" else torch.full((q,), -1.0,
                                                                                    device=dev)
        gamma = torch.full((q,), 1.0 if metric == "cosine" else 0.0, device=dev)
        norms = pad
    pen = (torch.rand((p, pmax), generator=g, device=dev) < 0.1).float() * 3.0e38
    norms = (norms + pen).contiguous()
    probe_ids = torch.randint(0, p, (q, np_), generator=g, device=dev, dtype=torch.int32)
    probe_ids[:, 1] = probe_ids[:, 0]  # repeated probe ids
    return (probe_ids, queries.contiguous(), vectors.to(dtype).contiguous(), norms,
            alpha.contiguous(), gamma.contiguous())


def adc_bound(args) -> tuple[float, float, dict]:
    """(bytes ms, operations ms, shape) of the ADC scan's function on
    ``args``, the same for B1 and B3: each probed partition's codes and
    rnorms once, the LUTs, probe ids, q·c and |q|² once, the output once;
    S LUT adds and the affine epilogue per output."""
    import torch

    probe_ids, dlut, codes, rnorms, qc, qn2 = args
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    n_parts = int(torch.unique(probe_ids).numel())
    nbytes = (
        n_parts * (s * pmax + 4 * pmax) + dlut.numel() * 4 + probe_ids.numel() * 4
        + qc.numel() * 4 + qn2.numel() * 4 + q * np_ * pmax * 4
    )
    ops = q * np_ * pmax * (s + 3)
    shape = {"Q": q, "NP": np_, "P": int(codes.shape[0]), "S": s, "K": int(dlut.shape[2]),
             "pmax": pmax, "probed_partitions": n_parts}
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3, shape


def check_adc(args, label: str) -> dict:
    """Hold the CUDA ADC kernel (B1) against the plain version on
    ``args``, time both (B1 also on the card alone and with L2 flushed
    before each call), and compute the bound. Raises on disagreement."""
    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.probes.common import compare, cuda_ms, cuda_ms_cold, device_ms

    saved = dict(adc.launch_counts)  # comparison launches do not count
    want = adc.ivf_pq_adc_scan_reference(*args)
    max_abs = compare(adc.ivf_pq_adc_scan(*args), want, label)
    ms = cuda_ms(lambda: adc.ivf_pq_adc_scan(*args))
    extra = {"cold_ms": cuda_ms_cold(lambda: adc.ivf_pq_adc_scan(*args)),
             "device_ms": device_ms(lambda: adc.ivf_pq_adc_scan(*args))}
    plain_ms = cuda_ms(lambda: adc.ivf_pq_adc_scan_reference(*args))
    del want
    adc.launch_counts.update(saved)
    bytes_ms, ops_ms, shape = adc_bound(args)
    # library_ms None: no single PyTorch call computes the ADC scan
    rec = kernel_record("ivf_pq_adc_scan", f"ivf_pq_adc_scan (K={shape['K']}, S={shape['S']})",
                        max_abs, ms, plain_ms, bytes_ms, ops_ms, **extra, shape=shape)
    print(f"[kernel] {label}: {json.dumps(rec)}", flush=True)
    return rec


def check_adc_grouped(args, qpc: int, label: str, b1_ms: float) -> dict:
    """Hold the grouped ADC kernel (B3) at ``qpc`` against its plain
    version on ``args`` (and, where K > 64 keeps the LUT in f32, against
    B1), time both, the launch alone and the groups, and compute the
    bound, which is B1's on the same inputs; ``b1_ms`` is B1's time on
    them. Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.ops.util import grouped_plan
    from lancedb_tpu_torch.probes.common import compare, cuda_ms

    probe_ids, dlut, codes = args[:3]
    k = dlut.shape[2]
    saved = dict(adc.launch_counts)  # comparison launches do not count
    got = adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc)
    max_abs = compare(got, adc.ivf_pq_adc_grouped_scan_reference(*args), label)
    extra = {}
    if k > adc.SELECT_MAX_K:
        extra["max_abs_err_vs_b1"] = compare(got, adc.ivf_pq_adc_scan(*args), f"{label} vs B1")
    del got
    ms = cuda_ms(lambda: adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc))
    plain_ms = cuda_ms(lambda: adc.ivf_pq_adc_grouped_scan_reference(*args), reps=3)
    # the launch alone, without the grouping of the pairs (torch ops)
    gpid, pair_of_slot, g = grouped_plan(probe_ids, codes.shape[0], qpc)
    out = torch.empty((probe_ids.shape[0], probe_ids.shape[1], codes.shape[2]),
                      device=codes.device)
    kernel_only_ms = cuda_ms(lambda: adc.launch_adc_grouped(gpid, pair_of_slot, g, qpc, *args,
                                                            out))
    groups = int((pair_of_slot.view(g, qpc)[:, 0] >= 0).sum())
    adc.launch_counts.update(saved)
    bytes_ms, ops_ms, shape = adc_bound(args)
    # library_ms None: no single PyTorch call computes the ADC scan
    rec = kernel_record(
        "ivf_pq_adc_grouped_scan",
        f"ivf_pq_adc_grouped_scan (K={k}, S={shape['S']}, qpc={qpc})", max_abs, ms, plain_ms,
        bytes_ms, ops_ms, b1_ms=b1_ms, kernel_only_ms=kernel_only_ms, groups=groups,
        lut_bf16=k <= adc.SELECT_MAX_K, **extra, shape=shape,
    )
    print(f"[kernel] {label}: {json.dumps(rec)}", flush=True)
    return rec


def synthetic_adc_args(k: int, s: int, p=1024, pmax=1152, q=128, np_=20, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    codes = torch.randint(0, k, (p, s, pmax), generator=g, device=dev, dtype=torch.int32)
    codes = codes.to(torch.uint8)
    dlut = torch.randn((q, s, k), generator=g, device=dev)
    dlut[:, s - 2 :] = 0.0  # padded subvectors: zero LUT rows
    rnorms = torch.rand((p, pmax), generator=g, device=dev) * 50.0
    rnorms[:, pmax - 100 :] = 3.0e38  # padding slots
    pen = (torch.rand((p, pmax), generator=g, device=dev) < 0.1).float() * 3.0e38
    rnorms = (rnorms + pen).contiguous()  # penalties; padding + penalty overflows to inf
    probe_ids = torch.randint(0, p, (q, np_), generator=g, device=dev, dtype=torch.int32)
    probe_ids[:, 1] = probe_ids[:, 0]  # repeated probe ids
    qc = torch.randn((q, np_), generator=g, device=dev)
    qn2 = torch.rand((q,), generator=g, device=dev) * 100.0
    return probe_ids, dlut, codes, rnorms, qc, qn2


def searcher_adc_args(searcher, queries: np.ndarray, nprobes: int = 20):
    """The ADC kernels' inputs for the first 128 queries, as
    VectorSearcher.search forms them (l2, no filter)."""
    import torch

    from lancedb_tpu_torch.probes.probe_pq_real import grouped_inputs

    return grouped_inputs(searcher, torch.from_numpy(queries[:128]).cuda(), nprobes)


def searcher_flat_args(searcher, queries: np.ndarray, nprobes: int = 20):
    """B2's inputs for one search chunk, as VectorSearcher.search forms
    them (l2, no filter)."""
    import torch

    from lancedb_tpu_torch.index.vector import _flat_coefs, _select_probes

    dev = searcher._device
    q = torch.from_numpy(queries[:128]).cuda()
    probe_ids, _ = _select_probes(q, dev["centroids"], searcher._block_nprobes(nprobes),
                                  searcher.metric)
    alpha, gamma, norms = _flat_coefs(q, dev["norms2"], dev["pad_pen"], searcher.metric)
    return (probe_ids.to(torch.int32), q, dev["vectors"], norms.contiguous(),
            alpha.contiguous(), gamma.contiguous())


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of fn() ending in a device synchronize."""
    import torch

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def breakdown(tbl, searcher, queries: np.ndarray) -> dict:
    """Where one 256-query batch spends its time, by layer: the searcher
    (probe selection, LUTs, ADC kernel, top-k, fused refine, copy back),
    the prefilter, the slot penalty, and the device's busy time inside a
    raw searcher call (torch.profiler, CUDA kernels summed)."""
    import torch

    from lancedb_tpu_torch.index.vector import SearchParams
    from lancedb_tpu_torch.query import compute_allowed_rowids

    raw, refined = SearchParams(k=10, nprobes=20), SearchParams(k=10, nprobes=20, refine_factor=10)
    out = {
        "searcher_raw_ms": host_ms(lambda: searcher.search(queries, raw)),
        "searcher_refined_ms": host_ms(lambda: searcher.search(queries, refined)),
        "prefilter_ms": host_ms(lambda: compute_allowed_rowids(tbl, "category < 5")),
    }
    allowed = compute_allowed_rowids(tbl, "category < 5")
    out["slot_penalty_ms"] = host_ms(lambda: searcher.slot_penalty(allowed, None))
    pen = searcher.slot_penalty(allowed, None)
    out["searcher_filtered_refined_ms"] = host_ms(
        lambda: searcher.search(queries, refined, slot_penalty=pen)
    )
    out["profiled_searcher_raw"] = profile_search(searcher, queries, raw)
    return out


def profile_search(searcher, queries: np.ndarray, params) -> dict:
    """One searcher call under torch.profiler: wall time, the device's busy
    time (CUDA kernels, copies and fills summed), its idle share, and the
    largest kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        searcher.search(queries, params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kern = {}
    for e in prof.key_averages():  # device-side events only: kernels, copies, fills
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[e.key] = kern.get(e.key, 0.0) + e.device_time_total
    busy_us = sum(kern.values())
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in
                           sorted(kern.items(), key=lambda kv: -kv[1])[:6]},
    }


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def hit_ids(tbl, nq: int, k: int = 10) -> np.ndarray:
    """A batch's result table → ids (nq, k), -1 where a query has fewer hits."""
    qi = np.asarray(tbl.column("query_index"))
    ids = np.asarray(tbl.column("id"))
    out = np.full((nq, k), -1, np.int64)
    for i in range(nq):
        hit = ids[qi == i][:k]
        out[i, : len(hit)] = hit
    return out


def result_ids(tbl, nq: int, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """(ids (nq, k) with -1 for missing, categories of every hit)."""
    return hit_ids(tbl, nq, k), np.asarray(tbl.column("category"))


def rowids_to_ids(tbl, rids: np.ndarray) -> np.ndarray:
    """Row addresses → the table's ``id`` column (-1 for none)."""
    valid = rids != np.uint64(np.iinfo(np.uint64).max)
    uniq, inv = np.unique(rids[valid], return_inverse=True)
    ids = np.asarray(tbl._dataset.take_rows(uniq, columns=["id"]).column("id"))
    out = np.full(rids.shape, -1, np.int64)
    out[valid] = ids[inv]
    return out


def timed_searches(tbl, queries, k, cases) -> dict:
    """Each case (name, builder options, truth): one warm call, then the
    median of 3 host-clock times of a 256-query batch through to_arrow(),
    and recall@10 of the last against the truth."""
    import torch

    out = {}
    for name, opts, truth in cases:
        def run():
            s = tbl.search(queries).limit(k).select(["id", "category"])
            for method, arg in opts.items():
                s = getattr(s, method)(arg)
            t = time.perf_counter()
            res = s.to_arrow()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t) * 1e3

        run()  # the first call loads the searcher
        reps = [run() for _ in range(3)]
        ms = float(np.median([r[1] for r in reps]))
        hit_ids, cats = result_ids(reps[-1][0], len(queries), k)
        if "where" in opts and not np.all(cats < 5):
            raise AssertionError(f"{name}: a filtered hit has category >= 5")
        out[name] = {"recall@10": recall(hit_ids, truth), "ms_per_256q_batch": ms,
                     "qps": len(queries) / (ms / 1e3)}
    return out


def check_bars(results: dict) -> None:
    """Raise unless every IVF_FLAT and FLAT search meets its recall bar."""
    for name, bar in FLAT_RECALL_BARS.items():
        got = results[name]["recall@10"]
        if got < bar:
            raise AssertionError(f"{name}: recall@10 {got} < {bar}")


def ivf_flat_path(tbl, queries, gt, gt_f, card: str) -> tuple[dict, list[dict]]:
    """create_index(IVF_FLAT) and its searches, with B2's launches counted
    from 0 over them; B2, and B4 beside it, checked on the searcher's
    inputs; the planner's full scan called directly, as the reference's
    bench does."""
    import torch

    from lancedb_tpu_torch.index import IvfFlat
    from lancedb_tpu_torch.index.vector import _ivf_full_scan
    from lancedb_tpu_torch.ops.cuda_build import launch_counts, reset_launch_counts
    from lancedb_tpu_torch.probes.common import cuda_ms

    k = 10
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tbl.create_index(config=IvfFlat(num_partitions=1024))
    torch.cuda.synchronize()
    rec: dict = {"build_s": time.perf_counter() - t0}
    rec.update(timed_searches(tbl, queries, k, [
        ("ivf_flat_np8", {"nprobes": 8}, gt),
        ("ivf_flat_np20", {"nprobes": 20}, gt),
        ("ivf_flat_np64", {"nprobes": 64}, gt),
        ("ivf_flat_np20_filtered", {"nprobes": 20, "where": "category < 5"}, gt_f),
        ("ivf_flat_np20_host_refined", {"nprobes": 20, "refine_factor": 10}, gt),
    ]))
    torch.cuda.synchronize()
    launches = launch_counts["ivf_flat_grouped_scan"]
    rec["b2_launches"] = launches
    rec["plan_launches"] = plan_launches = launch_counts["group_plan"]
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    rec["layout"] = {"blocks": searcher.nparts, "pmax": searcher.pmax}
    args = searcher_flat_args(searcher, queries)
    krecs = [check_flat("grouped", args, "B2 main-path shapes"),
             check_flat("pair", args, "B4 on B2's main-path inputs"),
             check_plan(args[0], searcher.nparts, 8, "B2's plan main-path shapes")]
    krecs[0]["launches"] = launches
    krecs[1]["launches"] = launch_counts["ivf_flat_scan"]  # 0: no search path runs B4
    krecs[2]["launches"] = plan_launches
    del args

    dev = searcher._device

    def full_scan():
        slots = [
            _ivf_full_scan(torch.from_numpy(queries[i : i + 128]).cuda(), dev["vectors"],
                           dev["norms2"], None, k, searcher.metric)[1]
            for i in range(0, len(queries), 128)
        ]
        return torch.cat(slots).cpu().numpy()

    ids = rowids_to_ids(tbl, searcher.row_ids_flat[full_scan()])
    nslots = searcher.nparts * searcher.pmax
    mat = torch.rand((128, nslots), device="cuda")
    rec["ivf_flat_full_scan"] = {
        "recall@10": recall(ids, gt),
        "ms_per_256q_batch": host_ms(full_scan),
        "stable_sort_ms_128_queries": cuda_ms(lambda: torch.sort(mat, dim=-1, stable=True), 5),
        "slots": nslots,
    }
    del mat
    from lancedb_tpu_torch.index.vector import SearchParams

    rec["profiled_searcher_np20"] = profile_search(searcher, queries, SearchParams(k=k, nprobes=20))
    print(f"[main] ivf_flat ({card}): {json.dumps(rec)}", flush=True)
    if launches <= 0:
        raise AssertionError("ivf_flat: B2 was not launched on the search path")
    if plan_launches != launches:
        raise AssertionError(f"ivf_flat: {plan_launches} plan kernels for {launches} B2 launches")
    del searcher, dev
    tbl._invalidate_caches()
    torch.cuda.empty_cache()
    return rec, krecs


def flat_path(tbl, queries, gt, card: str) -> dict:
    """create_index(FLAT) and its three precisions."""
    import torch

    from lancedb_tpu_torch.index import Flat
    from lancedb_tpu_torch.index.vector import SearchParams

    k = 10
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tbl.create_index(config=Flat())
    torch.cuda.synchronize()
    rec: dict = {"build_s": time.perf_counter() - t0}
    rec.update(timed_searches(tbl, queries, k, [
        (f"flat_{p}", {"precision": p}, gt) for p in ("float32", "bfloat16", "default")
    ]))
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    rec["profiled_searcher_default"] = profile_search(searcher, queries, SearchParams(k=k))
    print(f"[main] flat ({card}): {json.dumps(rec)}", flush=True)
    del searcher
    tbl._invalidate_caches()
    torch.cuda.empty_cache()
    return rec


def grouped_route(tbl, searcher, queries, gt, tag: str, bar: float, b1_ms: float):
    """The grouped route (probe selection → LUT → B3 at qpc 8 → top-k) on
    the searcher's device arrays for every query, in chunks of 128, with
    B3's launches counted from 0 over it; then its recall@10, the overlap
    of its top-10 with the per-pair (B1) route's, and B3 held to its plain
    version on the searcher's inputs. Raises if B3 was not launched or
    the recall is below ``bar``."""
    import torch

    from lancedb_tpu_torch.ops.cuda_build import launch_counts, reset_launch_counts
    from lancedb_tpu_torch.probes.probe_pq_real import full_grouped, overlap, per_pair

    chunks = [torch.from_numpy(queries[i : i + 128]).cuda() for i in range(0, len(queries), 128)]
    reset_launch_counts()
    t = time.perf_counter()
    routed = [full_grouped(searcher, q, qpc=8) for q in chunks]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts["ivf_pq_adc_grouped_scan"]
    plan_launches = launch_counts["group_plan"]
    b1_slots = torch.cat([per_pair(searcher, q)[1] for q in chunks])
    vals = torch.cat([v for v, _ in routed]).cpu().numpy()
    slots = torch.cat([s for _, s in routed])
    rids = searcher.row_ids_flat[slots.cpu().numpy()]
    rids[vals >= 1.5e38] = np.iinfo(np.uint64).max  # fell off the index
    ids = rowids_to_ids(tbl, rids)
    rec = {"recall@10": recall(ids, gt), "top10_overlap_with_b1_route": overlap(slots, b1_slots),
           "ms_per_256q_host_clock": ms, "b3_launches": launches, "plan_launches": plan_launches}
    args = searcher_adc_args(searcher, queries)
    krec = check_adc_grouped(args, 8, f"{tag} B3 main-path shapes", b1_ms)
    krec["launches"] = launches
    prec = check_plan(args[0], args[2].shape[0], 8, f"{tag} B3's plan main-path shapes")
    prec["launches"] = plan_launches
    del args
    print(f"[main] {tag} grouped route: {json.dumps(rec)}", flush=True)
    if launches <= 0:
        raise AssertionError(f"{tag}: B3 was not launched on the grouped route")
    if plan_launches != launches:
        raise AssertionError(f"{tag}: {plan_launches} plan kernels for {launches} B3 launches")
    if rec["recall@10"] < bar:
        raise AssertionError(f"{tag}: grouped-route recall {rec['recall@10']} < {bar}")
    return rec, [krec, prec]


def exact_gt(x_d, xn2_d, q: np.ndarray, k: int, mask_d=None) -> np.ndarray:
    """Exact f32 top-k l2 on the card (TF32 off), optionally over a row mask."""
    import torch

    qd = torch.from_numpy(q).cuda()
    d = xn2_d[None, :] - 2.0 * (qd @ x_d.T)
    if mask_d is not None:
        d = torch.where(mask_d[None, :], d, torch.full_like(d, float("inf")))
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


def b1_args(searcher, q: np.ndarray, nprobes: int = 20):
    """B1's inputs for one chunk of at most 128 queries, as
    VectorSearcher.search forms them on an l2 or cosine IVF_PQ index
    without OPQ or filter (cosine scans l2 on the unit sphere)."""
    import torch

    from lancedb_tpu_torch.index.vector import _pq_dlut, _select_probes

    dev = searcher._device
    qd = torch.from_numpy(q[:128]).cuda()
    if searcher.metric == "cosine":
        qd = qd / torch.clamp(qd.norm(dim=1, keepdim=True), min=1e-30)
    probe_ids, probe_dots = _select_probes(qd, dev["centroids"], searcher._block_nprobes(nprobes),
                                           searcher.metric)
    return (probe_ids.to(torch.int32), _pq_dlut(qd, dev["codebooks"], dev["codes"].shape[1]),
            dev["codes"], dev["rnorms"], probe_dots.contiguous(),
            torch.sum(qd * qd, dim=-1).contiguous())


def encode_check(searcher, x_slice: np.ndarray, nsub: int, kcode: int) -> dict:
    """The residual-free encode on the card, on a slice of the table in the
    build's dtype (bf16): with the index's codebooks, the encode that forms
    residuals from the raw rows gives the codes and rnorms of the encode
    that reads an f32 residual buffer; and pq_build_device with
    ``from_raw`` against the buffered call, codebooks trained from the
    same draws (the reference's own test holds >= 0.999 equal codes)."""
    import torch

    from lancedb_tpu_torch.ops import prng
    from lancedb_tpu_torch.ops.kmeans import assign_residuals_device
    from lancedb_tpu_torch.ops.pq import _encode_rnorms_device, pq_build_device

    dev = searcher._device
    x = torch.from_numpy(x_slice).to(torch.bfloat16).cuda()
    cents, cb = dev["centroids"], dev["codebooks"]
    assign, res = assign_residuals_device(x, cents, chunk=1 << 15)
    buffered = _encode_rnorms_device(res, cents, assign, cb, chunk=1 << 15)
    raw = _encode_rnorms_device(x, cents, assign, cb, chunk=1 << 15, from_raw=True)
    if not torch.equal(raw[0], buffered[0]) or not torch.equal(raw[1], buffered[1]):
        raise AssertionError("residual-free encode differs from the buffered encode")
    n = x.shape[0]
    rng = np.random.default_rng(1)
    sel = torch.from_numpy(rng.choice(n, 256 * kcode, replace=False).astype(np.int32))
    pool = torch.from_numpy(np.arange(32 * kcode, dtype=np.int32))
    reseed = torch.from_numpy(rng.integers(0, 256 * kcode, (10, kcode)).astype(np.int32))
    outs = []
    keys = prng.split(prng.prng_key(0), nsub)
    for src, from_raw in ((res, False), (x, True)):
        outs.append(pq_build_device(src, cents, assign, sel, pool, keys, reseed, nsub=nsub,
                                    kcode=kcode, max_iters=10, chunk=1 << 15, from_raw=from_raw))
    same = float((outs[0][1] == outs[1][1]).float().mean())
    cb_err = float((outs[0][0] - outs[1][0]).abs().max())
    rec = {"rows": n, "shared_codebooks_codes_equal": True, "shared_codebooks_rnorms_equal": True,
           "pq_build_codes_equal_share": same, "pq_build_codebooks_max_abs_diff": cb_err}
    if same < 0.999:
        raise AssertionError(f"pq_build_device from_raw: only {same} of the codes equal")
    return rec


def large_d_config(tag: str, cfg: dict, card: str) -> tuple[dict, dict]:
    """One BASELINE large-D config through connect() → create_table →
    create_index(IvfPq) → search at nprobes 20, raw and with
    refine_factor(10) (the fused refine), and for #4 with where("cat = 3"),
    on the bench's own data (make_clustered with its seed, 32 queries,
    rows and queries normalized for cosine, cat drawn after them). Records
    the capacity mode, build seconds, peak device memory, recall against
    exact f32 truth on the card, B1 against its plain version on the
    searcher's inputs, and the residual-free encode on a slice."""
    import pyarrow as pa
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc

    k, nq = 10, 32
    n, d = cfg["n"], cfg["d"]
    t0 = time.perf_counter()
    x, q, cats = large_d_data(cfg, nq)
    rec: dict = {"rows": n, "dim": d, "queries": nq, "data_s": time.perf_counter() - t0}
    x_d = torch.from_numpy(x).cuda()
    xn2_d = torch.sum(x_d * x_d, dim=1)
    gt = exact_gt(x_d, xn2_d, q, k)  # unit rows for cosine: l2 ranks as cosine
    gt_f = exact_gt(x_d, xn2_d, q, k, torch.from_numpy(cats == 3).cuda()) if cats is not None \
        else None
    del x_d, xn2_d
    torch.cuda.empty_cache()
    x_slice = np.ascontiguousarray(x[: 1 << 16])
    cols = {"id": np.arange(n, dtype=np.int64),
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), d)}
    if cats is not None:
        cols["cat"] = cats
    del x
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as tmp:
        t0 = time.perf_counter()
        tbl = lancedb_tpu_torch.connect(tmp).create_table(tag, pa.table(cols))
        del cols
        rec["create_table_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tbl.create_index(config=IvfPq(num_partitions=cfg["npart"], num_sub_vectors=cfg["nsub"],
                                      num_bits=cfg["nbits"], distance_type=cfg["metric"]))
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        rec["build_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        meta = tbl._dataset.manifest.indices[0]
        rec["build_mode"] = meta.params["build_mode"]
        rec["layout"] = {"blocks": meta.params["num_partitions"], "pmax": meta.params["pmax"]}
        torch.cuda.reset_peak_memory_stats()
        cases = [("raw", None, None, gt), ("refined", 10, None, gt)]
        if cats is not None:
            cases += [("filtered_raw", None, "cat = 3", gt_f),
                      ("filtered_refined", 10, "cat = 3", gt_f)]
        for name, rf, where, truth in cases:
            s = tbl.search(q).nprobes(20).limit(k).select(["id"] + (["cat"] if cats is not None
                                                                    else []))
            if rf:
                s = s.refine_factor(rf)
            if where:
                s = s.where(where)
            s.to_arrow()  # the first call loads the searcher / the refine table
            adc.reset_launch_counts()
            t0 = time.perf_counter()
            out = s.to_arrow()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rec[name] = {"recall@10": recall(hit_ids(out, nq, k), truth), "ms_per_32q_batch": ms,
                         "b1_launches": adc.launch_counts["ivf_pq_adc_scan"]}
            if where is not None:
                rec[name]["all_match_filter"] = bool(np.all(np.asarray(out.column("cat")) == 3))
                if not rec[name]["all_match_filter"]:
                    raise AssertionError(f"{tag} {name}: a filtered hit has cat != 3")
        rec["search_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        searcher = tbl._get_searcher(meta)
        rec["refine_table_dtype"] = str(searcher._device["refine_vecs"].dtype)
        krec = check_adc(b1_args(searcher, q), f"{tag} B1 main-path shapes")
        krec["launches"] = rec["raw"]["b1_launches"]
        rec["encode_check"] = encode_check(searcher, x_slice, cfg["nsub"], 1 << cfg["nbits"])
        del searcher
        tbl._invalidate_caches()
    torch.cuda.empty_cache()
    print(f"[large_d] {tag} ({card}): {json.dumps(rec)}", flush=True)
    raw_bar, refined_bar = LARGE_D_BARS[tag]
    misses = []  # every check of the config, then one error naming all that failed
    if rec["raw"]["b1_launches"] <= 0:
        misses.append("B1 was not launched on the search path")
    if rec["raw"]["recall@10"] < raw_bar:
        misses.append(f"raw recall {rec['raw']['recall@10']} < {raw_bar}")
    if rec["refined"]["recall@10"] < refined_bar:
        misses.append(f"refined recall {rec['refined']['recall@10']} < {refined_bar}")
    if cats is not None and rec["filtered_refined"]["recall@10"] < 0.95:
        misses.append(f"filtered refined recall {rec['filtered_refined']['recall@10']} < 0.95")
    if rec["refine_table_dtype"] != "torch.float16":
        misses.append(f"the fused refine table is {rec['refine_table_dtype']}")
    if misses:
        raise AssertionError(f"{tag}: " + "; ".join(misses))
    return rec, krec


def large_d_path(card: str) -> tuple[dict, list[dict]]:
    """Path d: BASELINE configs #3 and #4, each on its own database."""
    results, kernels = {}, []
    for tag, cfg in LARGE_D.items():
        results[tag], krec = large_d_config(tag, cfg, card)
        kernels.append(krec)
    return results, kernels


def opq_path(tbl, queries, gt, plain_raw: float, card: str) -> dict:
    """One OPQ build (8-bit x16, 1024 partitions) on the 1M x 128 table,
    searched raw and refined at nprobes 20. Its raw recall must reach the
    plain build's of this run less 0.03, and its refined recall 0.99."""
    import torch

    from lancedb_tpu_torch.index import IvfPq

    k = 10
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tbl.create_index(config=IvfPq(num_partitions=1024, num_sub_vectors=16, num_bits=8, opq=True))
    torch.cuda.synchronize()
    rec: dict = {"build_s": time.perf_counter() - t0,
                 "build_peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    rec["opq"] = tbl._dataset.manifest.indices[0].params.get("opq")
    rec.update(timed_searches(tbl, queries, k, [
        ("opq_raw", {"nprobes": 20}, gt), ("opq_refined", {"nprobes": 20, "refine_factor": 10}, gt),
    ]))
    print(f"[main] opq ({card}): {json.dumps(rec)}", flush=True)
    tbl._invalidate_caches()
    torch.cuda.empty_cache()
    if rec["opq"] is not True:
        raise AssertionError("opq: the index was not built with a rotation")
    if rec["opq_raw"]["recall@10"] < plain_raw - 0.03:
        raise AssertionError(f"opq: raw recall {rec['opq_raw']['recall@10']} < {plain_raw - 0.03}")
    if rec["opq_refined"]["recall@10"] < 0.99:
        raise AssertionError(f"opq: refined recall {rec['opq_refined']['recall@10']} < 0.99")
    return rec


def hnsw_path(db, x: np.ndarray, card: str) -> dict:
    """Path e: IVF_HNSW_FLAT (m 20) on the first 500,000 rows of the 1M x
    128 table with run_hnsw_config's queries (256 rows picked with
    default_rng(17), plus 0.05 noise): the device beam at ef 64 and 128 on
    256 queries and the host walk at ef 64 on 64, with recall against
    exact f32 truth, the build's stages and peak memory, the beam under
    torch.profiler, and the device-run counts read just after the
    searches; then IVF_HNSW_SQ on the same rows (device beam, ef 64) and
    IVF_HNSW_PQ on 50,000 rows (host walk, ef 64)."""
    import pyarrow as pa
    import torch

    from lancedb_tpu_torch.index import HnswFlat, HnswPq, HnswSq
    from lancedb_tpu_torch.index import hnsw
    from lancedb_tpu_torch.index.vector import SearchParams

    k, dim = 10, x.shape[1]
    results: dict = {}

    def table(n):
        xh = np.ascontiguousarray(x[:n])
        tbl = db.create_table(f"hnsw_{n}", pa.table({
            "id": np.arange(n, dtype=np.int64),
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(xh.ravel()), dim)}))
        rng2 = np.random.default_rng(17)
        qs = xh[rng2.integers(0, n, 256)] + 0.05 * rng2.standard_normal((256, dim)).astype(
            np.float32)
        x_d = torch.from_numpy(xh).cuda()
        gt = exact_gt(x_d, torch.sum(x_d * x_d, dim=1), qs, k)
        del x_d
        torch.cuda.empty_cache()
        return tbl, qs.astype(np.float32), gt

    def build(tbl, config) -> tuple[dict, object]:
        torch.cuda.reset_peak_memory_stats()
        hnsw.device_runs.clear()
        t0 = time.perf_counter()
        tbl.create_index(config=config)
        torch.cuda.synchronize()
        meta = tbl._dataset.manifest.indices[0]
        rec = {"build_s": time.perf_counter() - t0,
               "build_peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
               "build_timings": meta.params["build_timings"],
               "num_levels": meta.params["num_levels"], "build_device_runs": dict(hnsw.device_runs)}
        return rec, tbl._get_searcher(meta)

    def beam(tbl, searcher, qs, gt, ef, tag):
        params = SearchParams(k=k, ef=ef)
        searcher.search(qs, params)  # the first call uploads the beam's arrays
        hnsw.device_runs.clear()
        t0 = time.perf_counter()
        _, rids = searcher.search(qs, params)
        ms = (time.perf_counter() - t0) * 1e3
        runs = hnsw.device_runs["beam"]
        ids = rowids_to_ids(tbl, rids)
        out = {"recall@10": recall(ids, gt), "recall@10_first64": recall(ids[:64], gt[:64]),
               "ms_per_256q_batch": ms, "beam_runs": runs}
        if runs <= 0:
            raise AssertionError(f"{tag}: the device beam did not run on the card")
        return out

    def host(tbl, searcher, qs, gt, ef, nq=64):
        t0 = time.perf_counter()
        _, rids = searcher._search_host(qs[:nq], SearchParams(k=k, ef=ef))
        ms = (time.perf_counter() - t0) * 1e3
        return {"recall@10": recall(rowids_to_ids(tbl, rids), gt[:nq]), "ms_per_query": ms / nq}

    tbl, qs, gt = table(HNSW_ROWS)
    rec, searcher = build(tbl, HnswFlat())
    for ef in (64, 128):
        rec[f"device_ef{ef}"] = beam(tbl, searcher, qs, gt, ef, f"hnsw_flat ef {ef}")
    rec["host_ef64"] = host(tbl, searcher, qs, gt, 64)
    rec["profiled_beam_ef64"] = profile_search(searcher, qs, SearchParams(k=k, ef=64))
    results["hnsw_flat_500k"] = rec
    print(f"[hnsw] flat ({card}): {json.dumps(rec)}", flush=True)
    for name, bar in HNSW_BARS.items():
        if rec[name]["recall@10"] < bar:
            raise AssertionError(f"hnsw_flat {name}: recall@10 {rec[name]['recall@10']} < {bar}")
    del searcher
    tbl._invalidate_caches()

    rec, searcher = build(tbl, HnswSq())
    rec["device_ef64"] = beam(tbl, searcher, qs, gt, 64, "hnsw_sq ef 64")
    results["hnsw_sq_500k"] = rec
    print(f"[hnsw] sq ({card}): {json.dumps(rec)}", flush=True)
    del searcher
    tbl._invalidate_caches()

    tbl, qs, gt = table(HNSW_PQ_ROWS)
    rec, searcher = build(tbl, HnswPq())
    rec["host_ef64"] = host(tbl, searcher, qs, gt, 64)
    results["hnsw_pq_50k"] = rec
    print(f"[hnsw] pq ({card}): {json.dumps(rec)}", flush=True)
    del searcher
    tbl._invalidate_caches()
    torch.cuda.empty_cache()
    for (tag, name), bar in HNSW_STORAGE_BARS.items():
        if results[tag][name]["recall@10"] < bar:
            raise AssertionError(f"{tag} {name}: recall@10 {results[tag][name]['recall@10']} < {bar}")
    return results


def main_path(card: str) -> tuple[dict, list[dict]]:
    import pyarrow as pa
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.probes.common import make_clustered

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off for exact f32"
    n, dim, nq, k = 1_000_000, 128, 256, 10
    t0 = time.perf_counter()
    x, queries = make_clustered(np.random.default_rng(0), n, dim, n_queries=nq)
    ids = np.arange(n, dtype=np.int64)
    data = pa.table({
        "id": ids,
        "category": (ids % 10).astype(np.int64),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), dim),
    })
    print(f"[main] data made in {time.perf_counter() - t0:.3f} s", flush=True)
    x_d = torch.from_numpy(x).cuda()
    xn2_d = torch.sum(x_d * x_d, dim=1)
    mask_d = torch.from_numpy(ids % 10 < 5).cuda()
    gt = exact_gt(x_d, xn2_d, queries, k)
    gt_f = exact_gt(x_d, xn2_d, queries, k, mask_d)
    del x_d, xn2_d, mask_d
    torch.cuda.empty_cache()

    results: dict = {"card": card, "rows": n, "dim": dim, "queries": nq}
    kernels = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        db = lancedb_tpu_torch.connect(tmp)
        assert db.device.type == "cuda", db.device
        t0 = time.perf_counter()
        tbl = db.create_table("sift1m_like", data)
        results["create_table_s"] = time.perf_counter() - t0
        print(f"[main] create_table {results['create_table_s']:.3f} s ({card})", flush=True)
        for nbits, nsub in ((8, 16), (4, 32)):
            tag = f"ivf_pq_{nbits}bit_x{nsub}"
            torch.cuda.reset_peak_memory_stats()
            adc.reset_launch_counts()
            t0 = time.perf_counter()
            tbl.create_index(config=IvfPq(num_partitions=1024, num_sub_vectors=nsub,
                                          num_bits=nbits))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            rec = {"build_s": build_s}

            def run(rf=None, where=None):
                s = tbl.search(queries).nprobes(20).limit(k).select(["id", "category"])
                if rf:
                    s = s.refine_factor(rf)
                if where:
                    s = s.where(where)
                t = time.perf_counter()
                out = s.to_arrow()
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t) * 1e3

            for name, rf, where, truth in (
                ("raw", None, None, gt), ("refined", 10, None, gt),
                ("filtered_raw", None, "category < 5", gt_f),
                ("filtered_refined", 10, "category < 5", gt_f),
            ):
                run(rf, where)  # first call loads the searcher / refine table
                reps = [run(rf, where) for _ in range(3)]
                out = reps[-1][0]
                ms = float(np.median([r[1] for r in reps]))
                hit_ids, cats = result_ids(out, nq, k)
                if where is not None and not np.all(cats < 5):
                    raise AssertionError(f"{tag} {name}: a filtered hit has category >= 5")
                rec[name] = {"recall@10": recall(hit_ids, truth), "ms_per_256q_batch": ms,
                             "qps": nq / (ms / 1e3)}
            torch.cuda.synchronize()
            rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
            launches = adc.launch_counts["ivf_pq_adc_scan"]
            rec["adc_launches"] = launches
            print(f"[main] {tag} ({card}): {json.dumps(rec)}", flush=True)
            results[tag] = rec
            searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
            krec = check_adc(searcher_adc_args(searcher, queries), f"{tag} main-path shapes")
            krec["launches"] = launches
            kernels.append(krec)
            rec["breakdown"] = breakdown(tbl, searcher, queries)
            print(f"[main] {tag} breakdown ({card}): {json.dumps(rec['breakdown'])}", flush=True)
            rec["grouped_route"], grecs = grouped_route(tbl, searcher, queries, gt, tag,
                                                        RAW_RECALL_BARS[nbits] - 0.03, krec["ms"])
            kernels.extend(grecs)
            # the quality bars
            if launches <= 0:
                raise AssertionError(f"{tag}: the ADC kernel was not launched on the search path")
            if rec["refined"]["recall@10"] < 0.99:
                raise AssertionError(f"{tag}: refined recall {rec['refined']['recall@10']} < 0.99")
            bar = RAW_RECALL_BARS[nbits] - 0.03
            if rec["raw"]["recall@10"] < bar:
                raise AssertionError(f"{tag}: raw recall {rec['raw']['recall@10']} < {bar}")
            if rec["filtered_refined"]["recall@10"] < 0.95:
                raise AssertionError(
                    f"{tag}: filtered refined recall {rec['filtered_refined']['recall@10']} < 0.95"
                )
            del searcher
            tbl._invalidate_caches()
            torch.cuda.empty_cache()
        results["ivf_flat"], krecs = ivf_flat_path(tbl, queries, gt, gt_f, card)
        kernels.extend(krecs)
        results["flat"] = flat_path(tbl, queries, gt, card)
        check_bars({**results["ivf_flat"], **results["flat"]})
        results["opq"] = opq_path(tbl, queries, gt,
                                  results["ivf_pq_8bit_x16"]["raw"]["recall@10"], card)
        del tbl, data
        results["hnsw"] = hnsw_path(db, x, card)
    return results, kernels


def probe_kernel_records() -> list[dict]:
    """Drive the probes of S1 (ab_adc8: both designs at both codings) and
    S2 (ab_gather_min: eight shapes), each with the launch counts set to
    0 just before it and read just after; one record per S1 design and
    coding and per S2 shape. The probes hold each kernel to its plain
    version and time both; the bound is the function's: S1 reads each
    partition's codes once (cell c reads partition c mod P), the LUTs once
    and writes its (cells, pmax) output, with S adds per output; S2 reads
    its table and index once and writes its output."""
    from lancedb_tpu_torch.ops.cuda_build import launch_counts, reset_launch_counts
    from lancedb_tpu_torch.probes import ab_adc8, ab_gather_min

    reset_launch_counts()
    s1 = ab_adc8.run()
    s1_counts = dict(launch_counts)
    reset_launch_counts()
    s2 = ab_gather_min.run()
    s2_counts = dict(launch_counts)
    recs = []
    for r in s1:
        s_, k = r["S"], r["K"]
        parts = min(ab_adc8.P, ab_adc8.NCELLS)
        nbytes = (parts * s_ * ab_adc8.PMAX + ab_adc8.Q * s_ * k * 4
                  + ab_adc8.NCELLS * ab_adc8.PMAX * 4)
        ops = ab_adc8.NCELLS * ab_adc8.PMAX * s_
        counter = f"adc_sum_{r['design']}"
        # library_ms None: no single PyTorch call computes the LUT sum
        recs.append(kernel_record(
            counter, f"adc_sum {r['design']} ({r['bits']}-bit, S={s_}, K={k})", r["max_abs_err"],
            r["ms_per_scan"], r["plain_ms"], nbytes / HBM_BYTES_PER_S * 1e3,
            ops / F32_OPS_PER_S * 1e3, launches=s1_counts[counter], cell37_err=r["cell37_err"],
        ))
    for r in s2:
        n = r["shape"][0] * r["shape"][1]
        # the plain version is torch.take_along_dim, also the one library call
        recs.append(kernel_record(
            "smem_gather", f"smem_gather (shape {tuple(r['shape'])}, axis {r['axis']})", r["err"],
            r["ms"], r["take_along_dim_ms"], 3 * n * 4 / HBM_BYTES_PER_S * 1e3, 0.0,
            library_ms=r["take_along_dim_ms"], launches=s2_counts["smem_gather"],
        ))
    for counter, counts in (("adc_sum_select", s1_counts), ("adc_sum_gather", s1_counts),
                            ("smem_gather", s2_counts)):
        if counts[counter] <= 0:
            raise AssertionError(f"{counter} was not launched by its probe")
    for rec in recs:
        print(f"[kernel] probe: {json.dumps(rec)}", flush=True)
    return recs


def probes_phase(card: str) -> dict:
    """probes.probe_adc_grouped (B3 at qpc 8 and 16 against B1 and the
    one-hot einsum), with the launch counts set to 0 just before it and
    read just after. Raises if B1 or B3 was not launched."""
    from lancedb_tpu_torch.ops.cuda_build import launch_counts, reset_launch_counts
    from lancedb_tpu_torch.probes import probe_adc_grouped

    reset_launch_counts()
    records = probe_adc_grouped.run()
    launches = {c: launch_counts[c] for c in ("ivf_pq_adc_scan", "ivf_pq_adc_grouped_scan")}
    for rec in records:
        print(f"[probe] probe_adc_grouped ({card}): {json.dumps(rec)}", flush=True)
    print(f"[probe] probe_adc_grouped launches: {json.dumps(launches)}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"probe_adc_grouped did not launch B1 and B3: {launches}")
    return {"records": records, "launches": launches}


def kernel_phases(phase: str, card: str) -> tuple[dict, list[dict]]:
    """The kernel checks, then (phase "all") paths a-c, the OPQ build and
    path e on the 1M x 128 table, the probes and path d. Returns (the
    summary, the kernel records of the JSON line)."""
    import torch

    plan_line, plan_rest = synthetic_plan_checks()
    synthetic, grouped = [], []
    for k, s in ((256, 16), (16, 32)):
        args = synthetic_adc_args(k, s)
        label = f"synthetic {8 if k == 256 else 4}-bit x{s}"
        synthetic.append(check_adc(args, label))
        grouped += [check_adc_grouped(args, qpc, f"{label} B3 qpc={qpc}", synthetic[-1]["ms"])
                    for qpc in (8, 16)]
        del args
    flat_checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for metric in ("l2", "cosine", "dot"):
            args = synthetic_flat_args(metric, dtype)
            for kind in ("grouped", "pair"):
                rec = check_flat(kind, args, f"synthetic {kind} {metric} {dtype}")
                rec["metric"] = metric
                flat_checks.append(rec)
            del args
    torch.cuda.empty_cache()
    probe_kernels = probe_kernel_records()
    summary: dict = {"synthetic_kernels": synthetic + grouped + flat_checks + probe_kernels
                     + [plan_line], "synthetic_plans": plan_rest}
    # the l2 records of each flat kernel and storage type go into the line
    flat_line = [r for r in flat_checks if r["metric"] == "l2"] + [plan_line]
    kernels = synthetic + grouped + flat_line
    if phase == "all":
        results, main_kernels = main_path(card)
        summary["main_path"] = results
        summary["probes"] = probes_phase(card)
        summary["large_d"], large_d_kernels = large_d_path(card)
        counts: dict = {}  # launches on the main path, per kernel
        for r in main_kernels:
            counts[r["counter"]] = counts.get(r["counter"], 0) + r["launches"]
        for r in grouped + flat_line:
            r["launches"] = counts[r["counter"]]
        kernels = main_kernels + large_d_kernels + grouped + flat_line
    kernels += probe_kernels
    return summary, kernels


def hnsw_only(card: str) -> dict:
    """Path e alone, on the 1M x 128 table's first rows (seed 0)."""
    import lancedb_tpu_torch
    from lancedb_tpu_torch.probes.common import make_clustered

    x, _ = make_clustered(np.random.default_rng(0), 1_000_000, 128)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hnsw_") as tmp:
        return hnsw_path(lancedb_tpu_torch.connect(tmp), x, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "large_d", "hnsw"), default="all",
                    help="kernels: the kernel checks only; large_d, hnsw: that path only")
    ap.add_argument("--out", help="also write the full summary as JSON to this file")
    a = ap.parse_args()
    if not (REPO / "lancedb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout that holds lancedb_tpu_torch/",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lancedb_tpu_torch.ops import cuda_build
    from lancedb_tpu_torch.probes.common import card_line

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(f"torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"[build] {len(built)} CUDA source(s) in {time.perf_counter() - t0:.3f} s", flush=True)
    for src, log in cuda_build.build_logs.items():
        print(f"[build] {src} ptxas:\n{log.strip()}", flush=True)

    summary: dict = {}
    kernels: list[dict] = []
    if a.phase in ("large_d", "hnsw"):
        if a.phase == "large_d":
            summary["large_d"], kernels = large_d_path(card)
        else:
            summary["hnsw"] = hnsw_only(card)
    else:
        summary, kernels = kernel_phases(a.phase, card)
    summary["seconds"] = time.perf_counter() - t_start
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(summary, indent=1))
    print(f"card: {card}", flush=True)
    print("kernels: " + json.dumps([f"{kid} {counter}" for counter, (kid, _, _) in
                                    sorted(KERNELS.items(), key=lambda kv: kv[1][0])]),
          flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in KERNEL_KEYS} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
