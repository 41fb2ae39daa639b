#!/usr/bin/env python3
"""Drive lancedb_tpu_torch end to end on one CUDA card and check it.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phase kernels # build and check the kernels only
    python3 chip_smoke.py --out smoke.json # also write the full summary as JSON

Phases:
  1. card: the card's name and power limit (nvidia-smi) and torch's name.
  2. kernels: build every CUDA source under lancedb_tpu_torch/csrc (one
     nvcc per source, all started together), then hold the ADC scan
     kernel (B1) against its plain torch version at SIFT1M shapes
     (1024 partitions, pmax 1152, 128 queries, 20 probes) for 8-bit x16
     and 4-bit x32 codes, with padding and penalty slots, and time both.
     It also holds the grouped and the per-pair IVF_FLAT scan kernels
     (B2, B4) against their plain version at the IVF_FLAT path's shapes
     (1402 blocks of pmax 1224, D 128, 128 queries, 27 probes), for f32
     and bf16 storage and the l2, cosine and dot forms, and times them.
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
        device busy time under torch.profiler).
     b. create_index(IVF_FLAT, 1024 partitions) → search at nprobes 8, 20
        and 64, at 20 with the filter, and at 20 with refine_factor 10
        (the host refine); B2 and B4 checked and timed on the inputs the
        searcher gives B2 for the first 128 queries at nprobes 20;
        the planner's full scan called directly, with the time of the
        stable sort over its distance matrix.
     c. create_index(FLAT) → search in precision float32, bfloat16 and
        the default two-pass.
     Ground truth is exact f32 on the card; every recall bar is checked.

Prints, on lines before the last, the card's name and power limit, a
``kernels:`` line and one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0. The script imports neither JAX nor lancedb_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
ADC_SOURCE = "lancedb_tpu_torch/csrc/adc_scan.cu"
ADC_REPLACES = "lancedb_tpu/ops/pallas_adc.py:126"
FLAT_KERNELS = {  # kind: (name, source, the TPU kernel it replaces)
    "grouped": ("ivf_flat_grouped_scan", "lancedb_tpu_torch/csrc/ivf_flat_group_scan.cu",
                "lancedb_tpu/ops/pallas_group_scan.py:66"),
    "pair": ("ivf_flat_scan", "lancedb_tpu_torch/csrc/ivf_flat_scan.cu",
             "lancedb_tpu/ops/pallas_scan.py:53"),
}
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


def make_clustered(rng, n, dim, n_coarse=4096, n_parents=65_536, n_queries=256):
    """Hierarchical clustered data + queries near existing parents: the
    generator of the reference's bench.py, so recall means the same."""
    spectrum = (np.arange(dim) + 1.0) ** -0.5
    spectrum = (spectrum / np.linalg.norm(spectrum) * np.sqrt(dim)).astype(np.float32)
    coarse = rng.standard_normal((n_coarse, dim)).astype(np.float32)
    parents = coarse[rng.integers(0, n_coarse, n_parents)] + 0.45 * rng.standard_normal(
        (n_parents, dim)
    ).astype(np.float32)
    pa_ = rng.integers(0, n_parents, n)
    x = (parents[pa_] + 0.18 * rng.standard_normal((n, dim)).astype(np.float32)) * spectrum
    qp = rng.integers(0, n_parents, n_queries)
    q = (parents[qp] + 0.18 * rng.standard_normal((n_queries, dim)).astype(np.float32)) * spectrum
    return x.astype(np.float32), q.astype(np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(got, want, label: str) -> float:
    """Entries >= 1.5e38 (padding, penalties, inf) at the same positions,
    the rest within rtol 1e-5 + atol 1e-4 x max|finite|: the kernels sum
    in another order than the plain version. Returns max|err|."""
    import torch

    torch.cuda.synchronize()
    big_got, big_want = got >= 1.5e38, want >= 1.5e38
    if not torch.equal(big_got, big_want):
        raise AssertionError(f"{label}: padded/penalized entries differ in position")
    fin = ~big_want
    g, w = got[fin], want[fin]
    max_abs = float((g - w).abs().max()) if g.numel() else 0.0
    atol = 1e-4 * float(w.abs().max()) if w.numel() else 0.0
    if not torch.allclose(g, w, rtol=1e-5, atol=atol):
        raise AssertionError(f"{label}: kernel disagrees with plain version, max|err|={max_abs}")
    return max_abs


def check_flat(kind: str, args, label: str) -> dict:
    """Hold B2 (kind 'grouped') or B4 ('pair') against the plain version
    on ``args``, time both, and compute the bound. Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import flat_scan
    from lancedb_tpu_torch.ops.cuda_build import launch_counts

    name, source, replaces = FLAT_KERNELS[kind]
    fn = flat_scan.ivf_flat_grouped_scan if kind == "grouped" else flat_scan.ivf_flat_scan
    saved = dict(launch_counts)  # comparison launches do not count
    max_abs = compare(fn(*args), flat_scan.ivf_flat_scan_reference(*args), label)
    ms = cuda_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: flat_scan.ivf_flat_scan_reference(*args))
    extra = {}
    if kind == "grouped":
        # the launch alone, without the grouping of the pairs (torch ops)
        probe_ids, queries, vectors, norms, alpha, gamma = args
        gpid, pair_of_slot, g = flat_scan.grouped_plan(probe_ids, vectors.shape[0], 8)
        out = torch.empty((probe_ids.shape[0], probe_ids.shape[1], vectors.shape[1]),
                          device=vectors.device)
        extra["kernel_only_ms"] = cuda_ms(lambda: flat_scan.launch_grouped(
            gpid, pair_of_slot, g, 8, queries, vectors, norms, alpha, gamma, out))
        extra["groups"] = int((pair_of_slot.view(g, 8)[:, 0] >= 0).sum())
    launch_counts.update(saved)
    probe_ids, queries, vectors, norms, alpha, gamma = args
    q, np_ = probe_ids.shape
    _, pmax, d = vectors.shape
    # least bytes: each probed block (rows and norms) once, the queries,
    # probe ids, alpha and gamma once, the output once
    n_parts = int(torch.unique(probe_ids).numel())
    nbytes = (
        n_parts * pmax * (d * vectors.element_size() + 4) + queries.numel() * 4
        + probe_ids.numel() * 4 + 2 * q * 4 + q * np_ * pmax * 4
    )
    ops = q * np_ * pmax * (2 * d + 3)  # D FMAs and the affine epilogue per slot
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    rec = {
        "name": f"{name} ({str(vectors.dtype).replace('torch.', '')} storage)",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a probed scan
        **extra,
        "shape": {"Q": q, "NP": np_, "P": int(vectors.shape[0]), "pmax": pmax, "D": d,
                  "probed_partitions": n_parts},
    }
    print(f"[kernel] {label}: {json.dumps(rec)}", flush=True)
    return rec


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


def check_adc(args, label: str) -> dict:
    """Hold the CUDA ADC kernel against the plain version on ``args``,
    time both, and compute the bound. Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import adc

    probe_ids, dlut, codes, rnorms, qc, qn2 = args
    saved = dict(adc.launch_counts)  # comparison launches do not count
    max_abs = compare(adc.ivf_pq_adc_scan(*args), adc.ivf_pq_adc_scan_reference(*args), label)
    ms = cuda_ms(lambda: adc.ivf_pq_adc_scan(*args))
    plain_ms = cuda_ms(lambda: adc.ivf_pq_adc_scan_reference(*args))
    adc.launch_counts.update(saved)
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    k = dlut.shape[2]
    # least bytes: each probed partition's codes and rnorms once, the
    # LUTs, probe ids, q·c and |q|² once, the output once
    n_parts = int(torch.unique(probe_ids).numel())
    nbytes = (
        n_parts * (s * pmax + 4 * pmax) + dlut.numel() * 4 + probe_ids.numel() * 4
        + qc.numel() * 4 + qn2.numel() * 4 + q * np_ * pmax * 4
    )
    ops = q * np_ * pmax * (s + 3)  # S LUT adds + the affine epilogue per slot
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    rec = {
        "name": f"ivf_pq_adc_scan (K={k}, S={s})",
        "route": "cuda",
        "source": ADC_SOURCE,
        "replaces": ADC_REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the ADC scan
        "shape": {"Q": q, "NP": np_, "P": int(codes.shape[0]), "S": s, "K": k, "pmax": pmax,
                  "probed_partitions": n_parts},
    }
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
    """The kernel's inputs for one search chunk, as VectorSearcher.search
    forms them (l2, no filter)."""
    import torch

    from lancedb_tpu_torch.index.vector import _pq_dlut, _select_probes

    dev = searcher._device
    q = torch.from_numpy(queries[:128]).cuda()
    logical = searcher.params.get("num_logical_partitions", searcher.nparts)
    npb = min(searcher.nparts, max(1, int(np.ceil(nprobes * searcher.nparts / logical))))
    probe_ids, probe_dots = _select_probes(q, dev["centroids"], npb, searcher.metric)
    dlut = _pq_dlut(q, dev["codebooks"], dev["codes"].shape[1])
    qn2 = torch.sum(torch.square(q), dim=-1)
    return (probe_ids.to(torch.int32), dlut, dev["codes"], dev["rnorms"],
            probe_dots.contiguous(), qn2.contiguous())


def searcher_flat_args(searcher, queries: np.ndarray, nprobes: int = 20):
    """B2's inputs for one search chunk, as VectorSearcher.search forms
    them (l2, no filter)."""
    import torch

    from lancedb_tpu_torch.index.vector import _flat_coefs, _select_probes

    dev = searcher._device
    q = torch.from_numpy(queries[:128]).cuda()
    logical = searcher.params.get("num_logical_partitions", searcher.nparts)
    npb = min(searcher.nparts, max(1, int(np.ceil(nprobes * searcher.nparts / logical))))
    probe_ids, _ = _select_probes(q, dev["centroids"], npb, searcher.metric)
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


def result_ids(tbl, nq: int, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """(ids (nq, k) with -1 for missing, categories of every hit)."""
    qi = np.asarray(tbl.column("query_index"))
    ids = np.asarray(tbl.column("id"))
    out = np.full((nq, k), -1, np.int64)
    for i in range(nq):
        hit = ids[qi == i][:k]
        out[i, : len(hit)] = hit
    return out, np.asarray(tbl.column("category"))


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
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    rec["layout"] = {"blocks": searcher.nparts, "pmax": searcher.pmax}
    args = searcher_flat_args(searcher, queries)
    krecs = [check_flat("grouped", args, "B2 main-path shapes"),
             check_flat("pair", args, "B4 on B2's main-path inputs")]
    krecs[0]["launches"] = launches
    krecs[1]["launches"] = launch_counts["ivf_flat_scan"]  # 0: no search path runs B4
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


def exact_gt(x_d, xn2_d, q: np.ndarray, k: int, mask_d=None) -> np.ndarray:
    """Exact f32 top-k l2 on the card (TF32 off), optionally over a row mask."""
    import torch

    qd = torch.from_numpy(q).cuda()
    d = xn2_d[None, :] - 2.0 * (qd @ x_d.T)
    if mask_d is not None:
        d = torch.where(mask_d[None, :], d, torch.full_like(d, float("inf")))
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


def main_path(card: str) -> tuple[dict, list[dict]]:
    import pyarrow as pa
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc

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
    return results, kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
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

    synthetic = [
        check_adc(synthetic_adc_args(256, 16), "synthetic 8-bit x16"),
        check_adc(synthetic_adc_args(16, 32), "synthetic 4-bit x32"),
    ]
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
    summary: dict = {"synthetic_kernels": synthetic + flat_checks}
    # the l2 records of each flat kernel and storage type go into the line
    flat_line = [r for r in flat_checks if r["metric"] == "l2"]
    kernels = synthetic + flat_line
    if a.phase == "all":
        results, kernels = main_path(card)
        summary["main_path"] = results
        counts = {r["source"]: r["launches"] for r in kernels}
        for r in flat_line:  # launches on the main path, per kernel
            r["launches"] = counts[r["source"]]
        kernels = kernels + flat_line
    summary["seconds"] = time.perf_counter() - t_start
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(summary, indent=1))
    print(f"card: {card}", flush=True)
    print('kernels: ["B1 ivf_pq_adc_scan", "B2 ivf_flat_grouped_scan", "B4 ivf_flat_scan"]',
          flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in KERNEL_KEYS} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
