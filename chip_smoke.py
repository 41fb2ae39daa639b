#!/usr/bin/env python3
"""Drive lancedb_tpu_torch end to end on one CUDA card and check it.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phase kernels # build and check the kernels only
    python3 chip_smoke.py --phase hnsw    # path e alone (or --phase large_d: path d;
                                          # --phase fts: path f; --phase
                                          # vector_family: path g; --phase
                                          # lifecycle: path h; --phase mesh:
                                          # path i; --phase table_surface:
                                          # path j)
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
     back, as a caller meets them (the host's launch included); for B1-B4
     and the plan also ``device_ms`` (behind a spin kernel, so the
     host's launch is hidden) and for B1-B4 ``cold_ms`` (L2 flushed by
     a 128 MB write before each call).
     Then it drives the probes of the ADC inner loop (S1, both designs,
     lancedb_tpu_torch.probes.ab_adc8: timed back to back, on the card
     alone and cold, select held to gather bit for bit, then both at the
     probe's edge shapes) and of the shared-memory gather (S2, its eight
     shapes, probes.ab_gather_min), each with the launch counts set to 0
     just before it and read just after.
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
     g. the vector family (--phase vector_family alone), on the same
        table: create_index(IVF_SQ) and (IVF_RQ), 1024 partitions, each
        searched raw, refined (fused) and filtered at nprobes 20 with
        build seconds and peak memory, the searcher's batch ms, the peak
        of its transients and its profile, and the probed codes' bytes
        as the scan's bound; recall bars from tests/sqrq_reference_bars.py.
        Then an IVF_PQ 4-bit x32 index (B1 counted from 0) and the query
        options, each held to a re-derivation: distance_range,
        offset(5), postfilter(), bypass_vector_index() and metric("dot")
        (the card's exact f32 top-10), fast_search() after adding 10,000
        rows. Then metric("hamming") over 1,000,000 packed 1024-bit rows
        (distances equal to a table popcount on the card, ties lower row
        first), and multivector MaxSim over 50,000 passages of 32-180
        128-d tokens with its token index, 32 queries of 32 tokens with
        and without a filter, held to the two-stage algorithm in f32 on
        the card (recall@10 >= 0.99) and to an exhaustive MaxSim.
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
  6. path f, full text and hybrid (bench.py:1296 run_fts_hybrid_config,
     BASELINE config #5 on one card), after asserting that the native
     library (native/lancedb_native.cpp, built with g++) loaded:
     FTS over 1,000,000 make_corpus docs (Zipf 1.3, 30k words, 8-word
     docs; seed 1042): create_fts_index(with_position=True), timed, then
     the bench's three mixes (default_rng(2042): 100 mid-frequency OR
     pairs, 50 phrases, 50 common-term pairs), qps per mix, the first 10
     queries of each held to an exhaustive numpy BM25 over the index's
     CSR arrays (scores to 1e-5, every doc above the 10th hit present).
     Hybrid on path a's 1M x 128 table with a make_corpus text column
     (seed 1043): IVF_PQ 1024 partitions 4-bit x32, an FTS index without
     positions; 64 (vector, text) pairs (path a's first 64 queries,
     texts as bench.py:1403 draws them from default_rng(3042)), one call
     each and one add_query call of all 64; every fused top-10 equals a
     numpy RRF (K 60) of its two legs; the vector leg's recall@10 holds
     path a's 4-bit bar; B1 launches once per single call and once per
     batched call. Then where("category = 3") by the scan, a BITMAP index
     on category, and again: the same results, every hit category 3, the
     index's allowed set equal to the scan's, and the prefilter's ms by
     each way; B1 checked at the batched hybrid's shapes.
  7. path h, the table lifecycle: its own 1M x 128 table (make_clustered,
     seed 0, id and category = id % 10) and IVF_PQ 1024 partitions 4-bit
     x32 (build seconds, peak memory), then merge_insert of 10,000 rows
     (5,000 existing ids with new vectors and categories, 5,000 new ids:
     each merged vector its own top-1, no id twice, no superseded row),
     update(category = 3 -> 42) with a filtered search at recall@10 >=
     0.99 of exact filtered truth, delete(id < 1000) (no deleted id
     returned), explain_plan / analyze_plan, the batch's ms before and
     after the mutations, compact_files and the search over the fully
     stale index (a brute force of the table, recall >= 0.99), optimize
     (seconds, reindex seconds, peak memory; then no unindexed row and
     path a's bars, 0.7075 raw and 0.99 refined), checkout of the version
     before compaction (the same ids, distances within 1e-6) with device
     memory held over 3 round trips, a tag and restore(v), plain scans
     against pyarrow (filter, to_batches(65536), order_by / offset /
     limit), a second connection at read_consistency_interval=0 and the
     same search through connect_async. Every truth comes from a host
     model of the rows and exact f32 top-k on the card; B1's launches are
     counted per stage and must be > 0 in each.
  8. path i, the device mesh (--phase mesh alone): BASELINE config #5's
     sharded IVF_PQ at DEEP's widths, 10,000,000 x 96 make_clustered rows
     (seed 0, id and category = id % 10; the BASELINE's 100M cut to 10M)
     and 256 queries: create_index(IVF_PQ 4096 partitions, 8-bit x12) with
     build seconds and peak memory; exact f32 truth on the card; nprobes 20
     raw, refine_factor(10) and where("category = 3") on one device, then
     through enable_sharded_serving on a mesh of cuda:0 once and four times
     (the 1-shard mesh within 9 of 10 ids a query, mean overlap 0.99 and
     distances 1e-3 of one device; the 4-shard mesh's recall at least one
     device's less 0.01, with 4 times the 1-shard mesh's B1 launches);
     delete("id % 1000 = 0") and the raw search again (no deleted id);
     B1 held to its plain version on shard 0's inputs (the dealt codes with
     the deletion penalty, the budget's probes, 128 queries); device memory
     back within one searcher after disable_sharded_serving(); the feed
     (StreamingDataset over the table into TorchBatchFeeder, batches of
     4096 on the 1- and the 4-device mesh: rows/s over 2,000,000 rows, every
     tensor on the card, sampled batches equal to the host's rows, and the
     state after 100 batches resuming the run's next 10 exactly); the
     distributed build (ShardedIvfPqIndex on the 4-shard mesh, raw recall
     at least one device's less 0.03, and its fused refine); ShardedFlatIndex
     over the 10M rows (recall at least a plain bf16 brute force's less
     0.01, top-10 equal to the 1-shard flat's on >= 99 % of ids; its
     products are bf16, as the reference's are on the TPU);
     make_sharded_ivf_search over the first 1,000,000
     rows with 1024 distributed_kmeans partitions at nprobes 20 (recall >=
     0.95). B1's launches are counted from 0 for each search.
  9. path j, the rest of the Table's surface (--phase table_surface): a
     LanceModel (id, text embedded by the "hash" function into a 256-d
     vector, category = id % 10) over 1,000,000 make_corpus docs (seed 0),
     added in 100,000-row batches (the host embedding timed apart from the
     write); IVF_PQ 1024 partitions x 32 8-bit sub-vectors, built in f32
     as the reference's CPU build behind the bars is, and an FTS index; 256 make_corpus strings (seed 1) through search(s,
     query_type="vector") at nprobes 20 raw, refine_factor(10) and
     where("category = 3"), one call a string, each equal to search(v) of
     the function's vector exactly, B1 once a call; recall@10 counting
     ties against exact f32 truth on the card, bars from
     tests/embed_reference_bars.py; 64 one-string hybrids single and in
     one add_query call, each fused top-10 a numpy RRF of its legs;
     to_pydantic; the LSM write path (a bucketed spec on id, one use_lsm
     upsert of 5,000 new and 5,000 rewritten texts with their vectors, a
     use_lsm scan with no superseded text, flush_lsm, 256 of the texts
     found at distance 0 through the delta merge and after optimize()); a
     second table of 10,000 captions with 1-128 KiB blob payloads: a flat
     text search of 32 captions, then fetch_blobs, fetch_blob_files (read
     and seek) and fetch_blob_ranges of the hits equal to the payloads.

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
    on ``args``, time both, also on the card alone and with L2 flushed
    before each call (cold), and compute the bound. For B2 also the
    launch alone on its plan; for B4 its geometry and the bytes any
    per-pair design reads. Raises on disagreement."""
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
    extra = {"cold_ms": cuda_ms_cold(lambda: fn(*args)),
             "device_ms": device_ms(lambda: fn(*args))}
    probe_ids, queries, vectors, norms, alpha, gamma = args
    q, np_ = probe_ids.shape
    p, pmax, d = vectors.shape
    if kind == "pair":
        extra["geometry"] = flat_scan.pair_geometry(
            q, np_, pmax, d, vectors.element_size(),
            torch.cuda.get_device_properties(vectors.device).multi_processor_count)
        # what any per-pair design reads: each pair's block and norms, and
        # the output, at the card's memory rate (the function's bound
        # reads each probed block once)
        per_pair = q * np_ * pmax * (d * vectors.element_size() + 4 + 4)
        extra["per_pair_bytes_ms"] = per_pair / HBM_BYTES_PER_S * 1e3
    if kind == "grouped":
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
    B1), time both (B3 also on the card alone and cold), the launch alone
    and the groups, and compute the bound, which is B1's on the same
    inputs; ``b1_ms`` is B1's time on them. Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.ops.cuda_build import max_smem_bytes
    from lancedb_tpu_torch.ops.util import grouped_plan
    from lancedb_tpu_torch.probes.common import compare, cuda_ms, cuda_ms_cold, device_ms

    probe_ids, dlut, codes = args[:3]
    k = dlut.shape[2]
    saved = dict(adc.launch_counts)  # comparison launches do not count
    got = adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc)
    max_abs = compare(got, adc.ivf_pq_adc_grouped_scan_reference(*args), label)
    extra = {"geometry": adc.grouped_geometry(codes.shape[1], k, qpc, codes.shape[2],
                                              max_smem_bytes())}
    if k > adc.SELECT_MAX_K:
        extra["max_abs_err_vs_b1"] = compare(got, adc.ivf_pq_adc_scan(*args), f"{label} vs B1")
    del got
    ms = cuda_ms(lambda: adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc))
    extra["device_ms"] = device_ms(lambda: adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc))
    extra["cold_ms"] = cuda_ms_cold(lambda: adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc))
    plain_ms = cuda_ms(lambda: adc.ivf_pq_adc_grouped_scan_reference(*args), reps=3)
    # the launch alone, without the grouping of the pairs (its plan kernel)
    gpid, pair_of_slot, g = grouped_plan(probe_ids, codes.shape[0], qpc)
    out = torch.empty((probe_ids.shape[0], probe_ids.shape[1], codes.shape[2]),
                      device=codes.device)

    def alone():
        adc.launch_adc_grouped(gpid, pair_of_slot, g, qpc, *args, out)

    kernel_only_ms = cuda_ms(alone)
    extra["kernel_only_device_ms"] = device_ms(alone)
    extra["kernel_only_cold_ms"] = cuda_ms_cold(alone)
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
        results["vector_family"], vf_krec = vector_family_path(db, tbl, x, queries, gt, gt_f,
                                                               card)
        kernels.append(vf_krec)
        del tbl, data
        results["hnsw"] = hnsw_path(db, x, card)
    return results, kernels


def probe_kernel_records() -> list[dict]:
    """Drive the probes of S1 (ab_adc8: both designs at both codings, then
    at its edge shapes) and S2 (ab_gather_min: eight shapes), each with
    the launch counts set to 0 just before it and read just after; one
    record per S1 design and coding and per S2 shape. The probes hold each
    kernel to its plain version and time both, and S1's select to its
    gather bit for bit (raising otherwise); S1 is timed back to back, on
    the card alone and cold. The bound is the function's: S1 reads each
    partition's codes once (cell c reads partition c mod P), the LUTs once
    and writes its (cells, pmax) output, with S adds per output; its
    ``lookup_ms`` is the S lookups of every output at one a lane a clock
    on each SM, beside the bound, and ``device_ms_by_partitions`` its time
    with P varied (ab_adc8.partition_sweep). S2 reads its table and index
    once and writes its output."""
    import torch

    from lancedb_tpu_torch.ops.cuda_build import launch_counts, reset_launch_counts
    from lancedb_tpu_torch.probes import ab_adc8, ab_gather_min

    reset_launch_counts()
    s1 = ab_adc8.run()
    s1_counts = dict(launch_counts)
    reset_launch_counts()
    n_edges = ab_adc8.check_edges(torch.device("cuda"))
    for counter in ("adc_sum_select", "adc_sum_gather"):
        if launch_counts[counter] != n_edges:
            raise AssertionError(f"{counter}: {launch_counts[counter]} launches over "
                                 f"{n_edges} edge cases")
    by_p: dict = {}  # (design, bits) -> {P: device ms}; not counted: not the probe's inputs
    for r in ab_adc8.partition_sweep():
        by_p.setdefault((r["design"], r["bits"]), {})[r["P"]] = r["device_ms"]
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
            device_ms=r["device_ms"], cold_ms=r["cold_ms"], lookup_ms=r["lookup_ms"],
            geometry=r["geometry"], select_equals_gather=True, edge_cases=n_edges,
            device_ms_by_partitions=by_p[(r["design"], r["bits"])],
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
        summary["fts"], fts_kernels = fts_phase(card)
        summary["lifecycle"], lifecycle_kernels = lifecycle_phase(card)
        summary["mesh"], mesh_kernels = mesh_phase(card)
        counts: dict = {}  # launches on the main path, per kernel
        for r in main_kernels:
            counts[r["counter"]] = counts.get(r["counter"], 0) + r["launches"]
        for r in grouped + flat_line:
            r["launches"] = counts[r["counter"]]
        kernels = (main_kernels + large_d_kernels + fts_kernels + lifecycle_kernels + mesh_kernels
                   + grouped + flat_line)
    kernels += probe_kernels
    return summary, kernels


def hnsw_only(card: str) -> dict:
    """Path e alone, on the 1M x 128 table's first rows (seed 0)."""
    import lancedb_tpu_torch
    from lancedb_tpu_torch.probes.common import make_clustered

    x, _ = make_clustered(np.random.default_rng(0), 1_000_000, 128)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hnsw_") as tmp:
        return hnsw_path(lancedb_tpu_torch.connect(tmp), x, card)


# ---------------------------------------------------------------- path f

FTS_DOCS = 1_000_000  # bench.py:1307 run_fts_hybrid_config's n_docs, uncut
HYBRID_ROWS = 1_000_000  # the bench's 100,000 raised to path a's table
RRF_K = 60


ZIPF_A, VOCAB = 1.3, 30_000


def make_corpus(rng, n):
    """Zipf-ish synthetic text: 30k-word vocabulary, 8-word docs: the law of
    bench.py:426 make_corpus, ``clip(rng.zipf(1.3), 1, 30000) - 1`` as each
    word's rank. ``Generator.zipf``'s stream differs between numpy versions
    (2.0.2 and 2.3.5 draw different ranks from one seed), so the ranks come
    from ``rng.random`` through the law's inverse CDF instead: the same
    corpus on every machine, so the reference's recall on one machine is
    the bar on another."""
    k = np.arange(1, VOCAB, dtype=np.float64)
    head = k ** -ZIPF_A
    # sum over k >= VOCAB of k^-a (Euler-Maclaurin; exact to f64 rounding here)
    tail = (VOCAB ** (1 - ZIPF_A) / (ZIPF_A - 1) + VOCAB ** -ZIPF_A / 2
            + ZIPF_A * VOCAB ** (-ZIPF_A - 1) / 12)
    cdf = np.cumsum(head) / (head.sum() + tail)
    ranks = np.searchsorted(cdf, rng.random(n * 8), side="right")
    docs = np.char.add("w", ranks.astype("U6")).reshape(n, 8)
    return [" ".join(row) for row in docs]


def bm25_oracle(col, tokens: list[str], phrase: bool, k: int = 10):
    """Exhaustive BM25 over the index's CSR arrays in numpy (k1 1.2, b 0.75):
    every doc's score for an OR of the unique terms, or, for a phrase, the
    summed per-token scores of the docs where the tokens stand at
    consecutive positions. Returns (scores over all docs, top-k docs)."""
    from lancedb_tpu_torch.index.fts import B, K1

    n = col.num_docs
    norm = (K1 * (1.0 - B + B * col.doc_lens / max(col.avgdl, 1e-9))).astype(np.float32)
    tids = [col.vocab.get(t) for t in tokens]
    scores = np.zeros(n, np.float64)
    if any(t is None for t in tids) and phrase:
        return scores.astype(np.float32), np.empty(0, np.int64)
    tids = [t for t in tids if t is not None]
    if not phrase:
        tids = sorted(set(tids))
    off = np.asarray(col.postings_offsets)
    keep = np.ones(n, bool)
    if phrase:  # docs where token i stands at position p + i
        starts = None
        for i, t in enumerate(tids):
            s, e = off[t], off[t + 1]
            docs = np.asarray(col.postings_docs[s:e])
            pa_, pb = col.pos_offsets[s:e], col.pos_offsets[s + 1:e + 1]
            cnt = (pb - pa_).astype(np.int64)
            pos = np.concatenate([col.positions[a:b] for a, b in zip(pa_, pb)]) if e > s \
                else np.empty(0, np.int64)
            key = np.repeat(docs, cnt) * 4096 + pos.astype(np.int64) - i
            starts = key if starts is None else np.intersect1d(starts, key)
        keep = np.zeros(n, bool)
        keep[np.unique(starts // 4096)] = True
    for t in tids:
        s, e = off[t], off[t + 1]
        docs = np.asarray(col.postings_docs[s:e])
        tf = np.asarray(col.postings_tf[s:e]).astype(np.float32)
        idf = np.float32(np.log(1.0 + (n - float(col.df[t]) + 0.5) / (float(col.df[t]) + 0.5)))
        scores += np.bincount(docs, weights=idf * tf * (K1 + 1.0) / (tf + norm[docs]),
                              minlength=n)
    scores = np.where(keep, scores, 0.0).astype(np.float32)
    top = np.argsort(-scores, kind="stable")[:k]
    return scores, top[scores[top] > 0]


def check_fts_hits(col, query: str, got_rowids, got_scores, label: str) -> float:
    """Hold one query's top-10 to bm25_oracle: the scores pairwise (1e-5),
    each hit's own score, and every doc that scores above the 10th hit
    present (ties at the cut may take any of the tied docs, as the native
    scorers do). Returns max|err|."""
    phrase = query.startswith('"')
    tokens = col.tokenizer.tokenize(query.strip('"'))
    scores, top = bm25_oracle(col, tokens, phrase)
    want = scores[top]
    got_scores = np.asarray(got_scores, np.float32)
    if len(got_scores) != len(want):
        raise AssertionError(f"{label} {query!r}: {len(got_scores)} hits, oracle {len(want)}")
    err = float(np.max(np.abs(got_scores - want))) if len(want) else 0.0
    if not np.allclose(got_scores, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label} {query!r}: scores {got_scores} != oracle {want}")
    docs = col._sorted_order[np.searchsorted(col._sorted_rowids,
                                             np.asarray(got_rowids, np.uint64))]
    if not np.allclose(scores[docs], got_scores, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label} {query!r}: a hit's own score is not the oracle's")
    if len(want):
        must = set(np.nonzero(scores > want[-1] + 1e-5)[0].tolist())
        if not must <= set(docs.tolist()):
            raise AssertionError(f"{label} {query!r}: a doc above the cut is missing")
    return err


def numpy_rrf(v_ids: np.ndarray, f_ids: np.ndarray, k: int = 10):
    """RRF (K 60) of two ranked row-id lists in numpy: the sum of 1/(K +
    rank) over the lists, ordered by descending score, ties in order of
    first appearance (the vector list first)."""
    ids = np.concatenate([v_ids, f_ids]).astype(np.uint64)
    ranks = np.concatenate([np.arange(1, len(v_ids) + 1), np.arange(1, len(f_ids) + 1)])
    uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    score = np.zeros(len(uniq))
    np.add.at(score, inv, 1.0 / (RRF_K + ranks))
    by_first = np.argsort(first, kind="stable")
    uniq, score = uniq[by_first], score[by_first]
    order = np.argsort(-score, kind="stable")[:k]
    return uniq[order], score[order].astype(np.float32)


def check_rrf(fused, v_leg, f_leg, label: str) -> None:
    """One fused top-10 against numpy_rrf of its two legs: ids exactly,
    relevance to 1e-6."""
    want_ids, want_rel = numpy_rrf(np.asarray(v_leg.column("_rowid")),
                                   np.asarray(f_leg.column("_rowid")))
    got_ids = np.asarray(fused.column("_rowid")).astype(np.uint64)
    got_rel = np.asarray(fused.column("_relevance_score"))
    if not np.array_equal(got_ids, want_ids) or not np.allclose(got_rel, want_rel, atol=1e-6):
        raise AssertionError(f"{label}: fused top-10 is not the RRF of its legs")


def timed(fn, reps: int = 1):
    """(result of the last call, median host seconds of ``reps`` calls)."""
    import torch

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return out, float(np.median(times))


def fts_mixes() -> dict:
    """The bench's three query mixes (bench.py:1352-1381), from default_rng(2042)."""
    qrng = np.random.default_rng(2042)
    qterms = [f"w{r}" for r in qrng.integers(50, 2000, size=200)]
    return {
        "or_mid": [f"{qterms[2 * i]} {qterms[2 * i + 1]}" for i in range(100)],
        "phrase": [f'"{qterms[2 * i]} {qterms[2 * i + 1]}"' for i in range(50)],
        "or_common": [f"w{r} w{r + 1}" for r in qrng.integers(0, 30, size=50)],
    }


def fts_corpus_path(db, card: str) -> dict:
    """FTS over 1,000,000 docs (bench.py:1296 run_fts_hybrid_config): build
    with positions, then each query mix through search(query_type="fts"),
    the first 10 queries of each held to bm25_oracle."""
    import pyarrow as pa

    t0 = time.perf_counter()
    docs = make_corpus(np.random.default_rng(1042), FTS_DOCS)
    tbl = db.create_table("fts_bench", pa.table({"id": np.arange(FTS_DOCS), "text": docs}))
    del docs
    rec: dict = {"docs": FTS_DOCS, "corpus_and_table_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tbl.create_fts_index("text", with_position=True)
    rec["build_s"] = time.perf_counter() - t0
    col = tbl._get_fts_index(tbl._dataset.manifest.indices[0]).by_column["text"]
    rec["postings"], rec["terms"] = int(len(col.postings_docs)), int(len(col.df))
    print(f"[fts] corpus + table {rec['corpus_and_table_s']:.3f} s, build {rec['build_s']:.3f} s "
          f"({rec['postings']} postings, {rec['terms']} terms; {card})", flush=True)
    for mix, queries in fts_mixes().items():
        for q in queries[:3]:  # warm, as the bench does
            tbl.search(q, query_type="fts").limit(10).to_arrow()
        t0 = time.perf_counter()
        outs = [tbl.search(q, query_type="fts").limit(10).with_row_id().to_arrow()
                for q in queries]
        dt = time.perf_counter() - t0
        err = max(check_fts_hits(col, q, out.column("_rowid"), out.column("_score"), mix)
                  for q, out in zip(queries[:10], outs[:10]))
        rec[mix] = {"queries": len(queries), "qps": len(queries) / dt,
                    "ms_per_query": dt / len(queries) * 1e3, "oracle_max_abs_err": err,
                    "mean_hits": float(np.mean([o.num_rows for o in outs]))}
        print(f"[fts] {mix} ({card}): {json.dumps(rec[mix])}", flush=True)
    # the bench's phrases rarely hit (mean_hits): hold phrases of common
    # pairs to the oracle too, untimed
    hits = []
    for q in [f'"{p}"' for p in fts_mixes()["or_common"][:10]]:
        out = tbl.search(q, query_type="fts").limit(10).with_row_id().to_arrow()
        check_fts_hits(col, q, out.column("_rowid"), out.column("_score"), "common phrase")
        hits.append(out.num_rows)
    rec["common_phrase_hits_checked"] = hits
    return rec


def hybrid_path(db, card: str) -> tuple[dict, dict]:
    """Hybrid RRF on 1,000,000 rows (bench.py:1383-1425 at path a's table):
    path a's clustered vectors, category = id % 10 and a make_corpus text
    column; IVF_PQ 1024 partitions 4-bit x32, an FTS index without
    positions, then a BITMAP index on category. Returns (summary, the B1
    record at the batched hybrid's shapes)."""
    import pyarrow as pa
    import torch

    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.probes.common import make_clustered
    from lancedb_tpu_torch.query import ROW_ID_COL, compute_allowed_rowids

    n, dim, k = HYBRID_ROWS, 128, 10
    t0 = time.perf_counter()
    x, queries = make_clustered(np.random.default_rng(0), n, dim, n_queries=256)
    ids = np.arange(n, dtype=np.int64)
    data = pa.table({
        "id": ids, "category": (ids % 10).astype(np.int64),
        "text": make_corpus(np.random.default_rng(1043), n),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), dim),
    })
    qv = queries[:64]
    qt = [f"w{r} w{r + 3}" for r in np.random.default_rng(3042).integers(50, 2000, size=64)]
    x_d = torch.from_numpy(x).cuda()
    gt = exact_gt(x_d, torch.sum(x_d * x_d, dim=1), qv, k)
    del x_d, x
    torch.cuda.empty_cache()
    tbl = db.create_table("hybrid_bench", data)
    del data
    rec: dict = {"rows": n, "data_and_table_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tbl.create_index(config=IvfPq(num_partitions=1024, num_sub_vectors=32, num_bits=4))
    torch.cuda.synchronize()
    rec["ivf_pq_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tbl.create_fts_index("text", with_position=False)
    rec["fts_build_s"] = time.perf_counter() - t0
    print(f"[hybrid] data + table {rec['data_and_table_s']:.3f} s, IVF_PQ build "
          f"{rec['ivf_pq_build_s']:.3f} s, FTS build {rec['fts_build_s']:.3f} s ({card})",
          flush=True)

    def legs(i=None):
        """The two legs as the hybrid runs them: the vector leg for one
        query or all 64 at once, the FTS legs one query each."""
        vq = qv if i is None else qv[i]
        v = tbl.search(vq).limit(k).with_row_id().to_arrow()
        texts = qt if i is None else [qt[i]]
        return v, [tbl.search(t, query_type="fts").limit(k).with_row_id().to_arrow()
                   for t in texts]

    def batched(where=None):
        b = tbl.search((qv[0], qt[0]), query_type="hybrid").limit(k).with_row_id()
        for i in range(1, 64):
            b.add_query(qv[i], qt[i])
        if where:
            b = b.where(where)
        return b.to_arrow()

    def per_query(where=None):
        outs = []
        for i in range(64):
            b = tbl.search((qv[i], qt[i]), query_type="hybrid").limit(k).with_row_id()
            outs.append((b.where(where) if where else b).to_arrow())
        return outs

    # the vector leg's recall, and each fused top-10 against numpy RRF
    v_all, f_all = legs()
    vq_idx = np.asarray(v_all.column("query_index"))
    rec["vector_leg_recall@10"] = recall(hit_ids(v_all, 64, k), gt)
    per_query()  # warm: the searcher and the FTS index load
    adc.reset_launch_counts()
    singles, single_s = timed(per_query)
    rec["single_launches_b1"] = adc.launch_counts["ivf_pq_adc_scan"]
    adc.reset_launch_counts()
    fused_all, batch_s = timed(batched, reps=3)
    rec["batched_launches_b1"] = adc.launch_counts["ivf_pq_adc_scan"] // 3
    rec["per_query_qps"], rec["batched_qps"] = 64 / single_s, 64 / batch_s
    rec["batched_ms"] = batch_s * 1e3
    f_qidx = np.asarray(fused_all.column("query_index"))
    for i in range(64):
        check_rrf(fused_all.filter(pa.array(f_qidx == i)),
                  v_all.filter(pa.array(vq_idx == i)), f_all[i], f"batched hybrid {i}")
        v1, f1 = legs(i)
        check_rrf(singles[i], v1, f1[0], f"hybrid {i}")
    print(f"[hybrid] unfiltered ({card}): {json.dumps(rec)}", flush=True)

    # filtered: the scan, then a BITMAP index on category
    pred = "category = 3"
    ds = tbl._dataset

    def scan_allowed():
        t = ds.to_table(columns=[], predicate=pred, with_row_id=True)
        return np.sort(t.column(ROW_ID_COL).to_numpy().astype(np.uint64))

    def filtered_search():
        return tbl.search(queries).nprobes(20).limit(k).where(pred).select(["id", "category"]) \
            .to_arrow()

    flt: dict = {}
    filtered_search()
    out_scan, s = timed(filtered_search, reps=3)
    flt["ivf_pq_256q_scan_ms"] = s * 1e3
    flt["prefilter_scan_ms"] = host_ms(lambda: compute_allowed_rowids(tbl, pred))
    batched(pred)
    hyb_scan, s = timed(lambda: batched(pred), reps=3)
    flt["hybrid_batched_scan_ms"] = s * 1e3
    t0 = time.perf_counter()
    tbl.create_scalar_index("category", index_type="BITMAP")
    flt["bitmap_build_s"] = time.perf_counter() - t0
    flt["prefilter_index_ms"] = host_ms(lambda: compute_allowed_rowids(tbl, pred))
    if not np.array_equal(compute_allowed_rowids(tbl, pred), scan_allowed()):
        raise AssertionError("the BITMAP index's allowed set is not the scan's")
    filtered_search()
    out_ix, s = timed(filtered_search, reps=3)
    flt["ivf_pq_256q_index_ms"] = s * 1e3
    batched(pred)
    hyb_ix, s = timed(lambda: batched(pred), reps=3)
    flt["hybrid_batched_index_ms"] = s * 1e3
    for name, a, b in (("IVF_PQ filtered", out_scan, out_ix),
                       ("hybrid filtered", hyb_scan, hyb_ix)):
        if not a.equals(b):
            raise AssertionError(f"{name}: results with the BITMAP index differ from the scan's")
        if not np.all(np.asarray(b.column("category")) == 3):
            raise AssertionError(f"{name}: a hit has category != 3")
    rec["filtered"] = flt
    print(f"[hybrid] filtered {pred!r} ({card}): {json.dumps(flt)}", flush=True)

    bar = RAW_RECALL_BARS[4] - 0.03
    if rec["vector_leg_recall@10"] < bar:
        raise AssertionError(f"hybrid vector leg recall {rec['vector_leg_recall@10']} < {bar}")
    if rec["single_launches_b1"] < 64 or rec["batched_launches_b1"] != 1:
        raise AssertionError(f"B1 launches in the hybrid calls: {rec['single_launches_b1']} "
                             f"per 64 single, {rec['batched_launches_b1']} per batched call")
    searcher = next(tbl._get_searcher(ix) for ix in tbl._dataset.manifest.indices
                    if ix.index_type == "IVF_PQ")
    krec = check_adc(searcher_adc_args(searcher, qv), "hybrid batched vector leg")
    krec["launches"] = rec["batched_launches_b1"]
    return rec, krec


def fts_phase(card: str) -> tuple[dict, list[dict]]:
    """Path f: FTS over 1M docs and hybrid RRF over the 1M x 128 table,
    with the native library asserted before anything is timed."""
    import lancedb_tpu_torch
    from lancedb_tpu_torch.native import native_available

    available = native_available()
    print(f"[fts] native_available() = {available}", flush=True)
    if not available:
        raise AssertionError("the native FTS library did not build: the phase would time the "
                             "pure-Python scorers")
    results: dict = {"card": card, "native_available": available}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fts_") as tmp:
        db = lancedb_tpu_torch.connect(tmp)
        results["fts"] = fts_corpus_path(db, card)
        results["hybrid"], krec = hybrid_path(db, card)
    print(f"card: {card}", flush=True)
    return results, [krec]


# ---------------------------------------------------------------- path g

# tests/sqrq_reference_bars.py: the reference's recall@10 on the CPU at path
# g's settings (1M x 128, 1024 partitions, nprobes 20), less 0.03; refined
# at least 0.95 as well
SQRQ_BARS = {"ivf_sq": {"raw": 0.981640625 - 0.03, "refined": 0.996875 - 0.03,
                        "filtered": 0.976953125 - 0.03},
             "ivf_rq": {"raw": 0.8171875 - 0.03, "refined": 0.996875 - 0.03,
                        "filtered": 0.822265625 - 0.03}}
VF_PARTITIONS = 1024  # path a's partitions, for every index of path g
OPTION_DELTA_ROWS = 10_000
# Cohere embed-v3's ubinary output: 1024 bits, 128 uint8 per row
HAMMING_ROWS, HAMMING_BYTES, HAMMING_FLIP = 1_000_000, 128, 0.05
# ColBERTv2: doc_maxlen 180, query_maxlen 32, dim 128
MV_PASSAGES, MV_TOPICS, MV_DIM, MV_QUERIES, MV_QUERY_TOKENS = 50_000, 1_000, 128, 32, 32
MV_TOKENS = (32, 180)


def same_topk(label: str, got_ids, got_d, want_ids, want_d, atol: float) -> None:
    """Raise unless two (k,) top lists agree: distances within atol, and the
    same ids apart from a swap among distances tied within atol (or at the
    cut, where a tie partner fell off)."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_d, want_d = np.asarray(got_d, np.float64), np.asarray(want_d, np.float64)
    if got_ids.shape != want_ids.shape or not np.allclose(got_d, want_d, rtol=0, atol=atol):
        raise AssertionError(f"{label}: {got_ids} {got_d} != {want_ids} {want_d}")
    for j in np.nonzero(got_ids != want_ids)[0]:
        if j != len(want_ids) - 1 and (np.abs(want_d - want_d[j]) <= atol).sum() < 2:
            raise AssertionError(f"{label}: id {got_ids[j]} != {want_ids[j]} at {j}")


def per_query(out, nq: int, col: str = "id") -> list[np.ndarray]:
    """A batch's result column split by query_index."""
    qi = np.asarray(out.column("query_index"))
    vals = np.asarray(out.column(col))
    return [vals[qi == i] for i in range(nq)]


def sqrq_index(tbl, queries, gt, gt_f, kind: str, card: str) -> dict:
    """create_index(IVF_SQ or IVF_RQ, 1024 partitions) on path a's table:
    build seconds and peak memory; raw, refined (fused) and filtered
    searches of the 256 queries at nprobes 20 with their recall; the
    searcher's ms for the batch, the peak of its transients (the gathered
    chunk) and its profile; the bound of the probed codes' bytes."""
    import torch

    from lancedb_tpu_torch.index import IvfRq, IvfSq
    from lancedb_tpu_torch.index.vector import SearchParams, _select_probes

    tag = kind.lower()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tbl.create_index(config=(IvfSq if kind == "IVF_SQ" else IvfRq)(num_partitions=VF_PARTITIONS))
    torch.cuda.synchronize()
    rec: dict = {"build_s": time.perf_counter() - t0,
                 "build_peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    rec.update(timed_searches(tbl, queries, 10, (
        ("raw", {"nprobes": 20}, gt), ("refined", {"nprobes": 20, "refine_factor": 10}, gt),
        ("filtered", {"nprobes": 20, "where": "category < 5"}, gt_f),
    )))
    searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    raw = SearchParams(k=10, nprobes=20)
    ms = host_ms(lambda: searcher.search(queries, raw))
    rec["searcher_raw_ms"], rec["searcher_raw_qps"] = ms, len(queries) / (ms / 1e3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    searcher.search(queries, raw)
    torch.cuda.synchronize()
    rec["search_transient_peak_bytes"] = int(torch.cuda.max_memory_allocated() - base)
    rec["profiled_searcher_raw"] = profile_search(searcher, queries, raw)
    # the least time of the scan: each 128-query chunk reads its distinct
    # probed blocks' codes (SQ: D bytes a row, RQ: D/8) once
    width = searcher.dim if kind == "IVF_SQ" else searcher.dim // 8
    nbytes = 0
    for i in range(0, len(queries), 128):
        pids, _ = _select_probes(torch.from_numpy(queries[i : i + 128]).cuda(),
                                 searcher._device["centroids"], searcher._block_nprobes(20), "l2")
        nbytes += int(torch.unique(pids).numel()) * searcher.pmax * width
    rec["probed_code_bytes"] = nbytes
    rec["scan_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[vector_family] {tag} ({card}): {json.dumps(rec)}", flush=True)
    for case, bar in SQRQ_BARS[tag].items():
        bar = max(bar, 0.95) if case == "refined" else bar
        if rec[case]["recall@10"] < bar:
            raise AssertionError(f"{tag} {case}: recall@10 {rec[case]['recall@10']} < {bar}")
    del searcher
    tbl._invalidate_caches()
    torch.cuda.empty_cache()
    return rec


def exact_topk(x_d, q: np.ndarray, k: int, metric: str):
    """Exact f32 top-k (ids, distances) on the card: l2 as |q|² − 2q·x +
    |x|² (clamped at 0), dot as −q·x."""
    import torch

    qd = torch.from_numpy(q).cuda()
    dots = qd @ x_d.T
    if metric == "dot":
        d = -dots
    else:
        d = torch.clamp(torch.sum(qd * qd, 1)[:, None] - 2.0 * dots
                        + torch.sum(x_d * x_d, 1)[None, :], min=0.0)
    vals, idx = torch.topk(d, k, dim=1, largest=False)
    return idx.cpu().numpy(), vals.cpu().numpy()


def options_path(tbl, x: np.ndarray, queries, card: str) -> tuple[dict, dict]:
    """The vector query options on an IVF_PQ 4-bit x32 index of path a's
    table (B1 on the path), each held to a re-derivation on the same
    candidates: distance_range keeps exactly the rows in [lo, hi),
    offset(5) is rows 5..14 of a limit-15 search, postfilter the raw top-10
    filtered, the metric("dot") override and bypass_vector_index the exact
    f32 top-10 of the card, fast_search after an add of 10,000 rows the
    index's results and the full search the delta's. B1's launches are
    counted from 0 over the path. Returns (summary, B1's record)."""
    import pyarrow as pa
    import torch

    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc

    nq, n, k = len(queries), len(x), 10
    t0 = time.perf_counter()
    tbl.create_index(config=IvfPq(num_partitions=VF_PARTITIONS, num_sub_vectors=32, num_bits=4))
    torch.cuda.synchronize()
    rec: dict = {"ivf_pq_build_s": time.perf_counter() - t0}
    adc.reset_launch_counts()

    def search(**opts):
        s = tbl.search(queries).nprobes(20).select(["id", "category"])
        for method, arg in opts.items():
            s = getattr(s, method)(*arg) if isinstance(arg, tuple) else getattr(s, method)(arg)
        out, secs = timed(s.to_arrow)
        return out, secs * 1e3

    search(limit=k)  # loads the searcher
    raw, rec["raw_ms"] = search(limit=k)
    raw_ids, raw_d = per_query(raw, nq), per_query(raw, nq, "_distance")
    raw_cat = per_query(raw, nq, "category")
    # distance_range: the upper bound midway between query 0's 5th and 6th
    d0 = np.unique(raw_d[0])
    j = 4 + int(np.argmax(np.diff(d0[4:])))
    lo, hi = float(d0[0] + d0[1]) / 2, float(d0[j] + d0[j + 1]) / 2
    ranged, rec["distance_range_ms"] = search(limit=k, distance_range=(lo, hi))
    for i, (ids, d) in enumerate(zip(per_query(ranged, nq), per_query(ranged, nq, "_distance"))):
        keep = (raw_d[i] >= lo) & (raw_d[i] < hi)
        if not (np.array_equal(ids, raw_ids[i][keep]) and np.array_equal(d, raw_d[i][keep])):
            raise AssertionError(f"distance_range [{lo}, {hi}) query {i}: {ids} != "
                                 f"{raw_ids[i][keep]}")
    rec["distance_range_rows"] = ranged.num_rows
    long, _ = search(limit=15)
    off, rec["offset_ms"] = search(limit=k, offset=5)
    for i, (a, b) in enumerate(zip(per_query(off, nq), per_query(long, nq))):
        if not np.array_equal(a, b[5:15]):
            raise AssertionError(f"offset(5) query {i}: {a} != rows 5..14 {b[5:15]}")
    post, rec["postfilter_ms"] = search(limit=k, where="category < 5", postfilter=())
    for i, ids in enumerate(per_query(post, nq)):
        if not np.array_equal(ids, raw_ids[i][raw_cat[i] < 5]):
            raise AssertionError(f"postfilter query {i}: {ids} != {raw_ids[i][raw_cat[i] < 5]}")
    rec["postfilter_rows"] = post.num_rows
    x_d = torch.from_numpy(x).cuda()
    for name, opts, metric in (("bypass_vector_index", {"bypass_vector_index": ()}, "l2"),
                               ("metric_dot", {"metric": "dot"}, "dot")):
        out, rec[f"{name}_ms"] = search(limit=k, **opts)
        want_ids, want_d = exact_topk(x_d, queries, k, metric)
        qn2 = (queries.astype(np.float64) ** 2).sum(1)
        for i, (ids, d) in enumerate(zip(per_query(out, nq), per_query(out, nq, "_distance"))):
            same_topk(f"{name} query {i}", ids, d, want_ids[i], want_d[i], 1e-5 * (qn2[i] + 1))
    del x_d
    torch.cuda.empty_cache()
    # fast_search: 10,000 rows near the queries added after the build
    rng = np.random.default_rng(5)
    xd_new = (queries[np.arange(OPTION_DELTA_ROWS) % nq]
              + 0.01 * rng.standard_normal((OPTION_DELTA_ROWS, x.shape[1]))).astype(np.float32)
    new_ids = np.arange(n, n + OPTION_DELTA_ROWS, dtype=np.int64)
    tbl.add(pa.table({"id": new_ids, "category": new_ids % 10,
                      "vector": pa.FixedSizeListArray.from_arrays(pa.array(xd_new.ravel()),
                                                                  x.shape[1])}))
    search(limit=k, fast_search=())  # reloads the searcher
    fast, rec["fast_search_ms"] = search(limit=k, fast_search=())
    full, rec["with_delta_ms"] = search(limit=k)
    delta_ids, delta_d = exact_topk(torch.from_numpy(xd_new).cuda(), queries, k, "l2")
    for i in range(nq):
        if not np.array_equal(per_query(fast, nq)[i], raw_ids[i]):
            raise AssertionError(f"fast_search query {i}: not the index's results")
        # without fast_search: the index's hits merged with the delta's exact top-k
        cand_ids = np.concatenate([raw_ids[i], delta_ids[i] + n])
        cand_d = np.concatenate([raw_d[i], delta_d[i]])
        top = np.argsort(cand_d, kind="stable")[:k]
        same_topk(f"delta query {i}", per_query(full, nq)[i], per_query(full, nq, "_distance")[i],
                  cand_ids[top], cand_d[top], 1e-4)
    rec["delta_hits"] = int(np.sum(np.asarray(full.column("id")) >= n))
    torch.cuda.synchronize()
    rec["b1_launches"] = adc.launch_counts["ivf_pq_adc_scan"]
    print(f"[vector_family] options ({card}): {json.dumps(rec)}", flush=True)
    if rec["b1_launches"] <= 0:
        raise AssertionError("the query options did not launch B1")
    searcher = next(tbl._get_searcher(ix) for ix in tbl._dataset.manifest.indices
                    if ix.index_type == "IVF_PQ")
    krec = check_adc(searcher_adc_args(searcher, queries), "vector options (IVF_PQ 4-bit x32)")
    krec["launches"] = rec["b1_launches"]
    return rec, krec


def hamming_path(db, card: str) -> dict:
    """metric("hamming") brute force over 1,000,000 packed 1024-bit rows
    (128 uint8) for 256 queries, each a row with 5 % of its bits flipped:
    every distance equals an XOR popcount the card computes with a
    256-entry table, and the ids equal that popcount's stable top-10
    (ties lower row first)."""
    import pyarrow as pa
    import torch

    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, (HAMMING_ROWS, HAMMING_BYTES), dtype=np.uint8)
    flips = np.packbits(rng.random((256, HAMMING_BYTES * 8)) < HAMMING_FLIP, axis=1,
                        bitorder="little")
    qbits = rows[rng.integers(0, HAMMING_ROWS, 256)] ^ flips
    t0 = time.perf_counter()
    tbl = db.create_table("hamming_1m", pa.table({
        "id": np.arange(HAMMING_ROWS, dtype=np.int64),
        "bits": pa.FixedSizeListArray.from_arrays(pa.array(rows.ravel()), HAMMING_BYTES),
    }))
    rec: dict = {"rows": HAMMING_ROWS, "bits": HAMMING_BYTES * 8, "queries": 256,
                 "table_s": time.perf_counter() - t0}

    def run():
        return tbl.search(qbits, vector_column_name="bits").metric("hamming").limit(10) \
            .select(["id"]).to_arrow()

    run()
    out, secs = timed(run, reps=3)
    rec["ms_per_batch"], rec["qps"] = secs * 1e3, 256 / secs
    # the oracle: popcount(q ^ x) by a 256-entry table, then a stable sort
    table = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32,
                         device="cuda")
    x_d, q_d = torch.from_numpy(rows).cuda(), torch.from_numpy(qbits).cuda()
    dist = torch.empty((256, HAMMING_ROWS), dtype=torch.int32, device="cuda")
    for s in range(0, HAMMING_ROWS, 2048):
        xor = q_d[:, None, :] ^ x_d[None, s : s + 2048]
        dist[:, s : s + 2048] = table[xor.long()].sum(-1, dtype=torch.int32)
    want_d, want_ids = torch.sort(dist, dim=1, stable=True)
    want_d, want_ids = want_d[:, :10].cpu().numpy(), want_ids[:, :10].cpu().numpy()
    del dist, x_d
    torch.cuda.empty_cache()
    ties = 0
    for i, (ids, d) in enumerate(zip(per_query(out, 256), per_query(out, 256, "_distance"))):
        if not (np.array_equal(ids, want_ids[i]) and np.array_equal(d, want_d[i])):
            raise AssertionError(f"hamming query {i}: {ids} {d} != {want_ids[i]} {want_d[i]}")
        ties += int(np.sum(np.diff(d) == 0))
    rec["tied_neighbours_checked"] = ties
    print(f"[vector_family] hamming ({card}): {json.dumps(rec)}", flush=True)
    return rec


def multivector_data(rng):
    """50,000 passages of 32-180 128-d tokens, clustered by topic (each
    passage near its topic's centre, each token near its passage's), and
    32 queries of 32 tokens drawn near given passages."""
    topics = rng.standard_normal((MV_TOPICS, MV_DIM), dtype=np.float32)
    topic = rng.integers(0, MV_TOPICS, MV_PASSAGES)
    centre = topics[topic] + 0.6 * rng.standard_normal((MV_PASSAGES, MV_DIM), dtype=np.float32)
    counts = rng.integers(MV_TOKENS[0], MV_TOKENS[1] + 1, MV_PASSAGES)
    owner = np.repeat(np.arange(MV_PASSAGES), counts)
    tokens = centre[owner]
    tokens += 0.8 * rng.standard_normal(tokens.shape, dtype=np.float32)
    src = rng.integers(0, MV_PASSAGES, MV_QUERIES)
    queries = centre[src][:, None, :] + 0.8 * rng.standard_normal(
        (MV_QUERIES, MV_QUERY_TOKENS, MV_DIM), dtype=np.float32)
    return tokens, counts, owner, topic, queries.astype(np.float32)


def multivector_truth(tok_d, owner_d, q: np.ndarray, allowed_d, k: int = 10, overfetch: int = 10):
    """On the card in f32: (the two-stage algorithm's top-k — each query
    token's k·overfetch nearest allowed tokens, then exact MaxSim over
    their parents — and the exhaustive MaxSim top-k over all allowed
    passages)."""
    import torch

    qd = torch.from_numpy(q).cuda()
    qd = qd / torch.clamp(qd.norm(dim=1, keepdim=True), min=1e-30)
    sims = qd @ tok_d.T  # (nq_tok, T)
    sims = torch.where(allowed_d[owner_d][None, :], sims, float("-inf"))
    per_doc = torch.full((len(q), len(allowed_d)), float("-inf"), device="cuda")
    per_doc = per_doc.scatter_reduce(1, owner_d[None, :].expand_as(sims), sims, "amax")
    scores = torch.where(torch.isfinite(per_doc), per_doc, 0.0).sum(0)
    scores = torch.where(allowed_d, scores, float("-inf"))
    exhaustive = torch.topk(scores, k).indices.cpu().numpy()
    cand = torch.unique(owner_d[torch.topk(sims, k * overfetch, dim=1).indices])
    two_stage = cand[torch.topk(scores[cand], min(k, len(cand))).indices].cpu().numpy()
    return two_stage, exhaustive


def multivector_path(db, card: str) -> dict:
    """ColBERT-style late interaction on the card: a multivector table of
    50,000 passages (~5.3M tokens), its token index, then 32 queries one
    call each, without and with where("id % 2 = 0"); each top-10 held to
    the two-stage algorithm recomputed in f32 on the card (recall@10 at
    least 0.99) and reported against an exhaustive MaxSim."""
    import pyarrow as pa
    import torch

    t0 = time.perf_counter()
    tokens, counts, owner, topic, queries = multivector_data(np.random.default_rng(11))
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = pa.ListArray.from_arrays(pa.array(offsets), pa.FixedSizeListArray.from_arrays(
        pa.array(tokens.ravel()), MV_DIM))
    tbl = db.create_table("colbert_50k", pa.table({
        "id": np.arange(MV_PASSAGES, dtype=np.int64), "topic": topic, "tokens": col}))
    rec: dict = {"passages": MV_PASSAGES, "tokens": int(len(tokens)),
                 "token_bytes_f32": int(tokens.nbytes), "data_and_table_s": time.perf_counter() - t0}
    del col
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tbl.create_index(vector_column_name="tokens")
    rec["build_s"] = time.perf_counter() - t0
    unit = tokens / np.maximum(np.linalg.norm(tokens, axis=1, keepdims=True), 1e-30)
    tok_d = torch.from_numpy(unit).cuda()
    del tokens, unit
    owner_d = torch.from_numpy(owner).cuda()
    ids = np.arange(MV_PASSAGES)
    for name, where in (("unfiltered", None), ("filtered", "id % 2 = 0")):
        allowed_d = torch.from_numpy(ids % 2 == 0 if where else np.ones(MV_PASSAGES, bool)).cuda()

        def one(i):
            s = tbl.search(queries[i], vector_column_name="tokens").limit(10).select(["id"])
            return (s.where(where) if where else s).to_arrow()

        one(0)  # loads the token index
        outs, secs = timed(lambda: [one(i) for i in range(MV_QUERIES)])
        r_two, r_all, hits = [], [], []
        for i, out in enumerate(outs):
            got = np.asarray(out.column("id"))
            if where and not np.all(got % 2 == 0):
                raise AssertionError(f"multivector {name} query {i}: a hit fails the filter")
            two, full = multivector_truth(tok_d, owner_d, queries[i], allowed_d)
            # stage 1 can find fewer than 10 parents; then so must the card
            if len(got) != len(two):
                raise AssertionError(f"multivector {name} query {i}: {len(got)} hits, the "
                                     f"two-stage recomputation {len(two)}")
            r_two.append(len(set(got) & set(two)) / len(two))
            r_all.append(len(set(got) & set(full)) / 10)
            hits.append(len(got))
        rec[name] = {"ms_per_query": secs / MV_QUERIES * 1e3,
                     "recall@10_vs_two_stage_f32": float(np.mean(r_two)),
                     "recall@10_vs_exhaustive": float(np.mean(r_all)),
                     "mean_hits": float(np.mean(hits))}
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    print(f"[vector_family] multivector ({card}): {json.dumps(rec)}", flush=True)
    del tok_d, owner_d
    torch.cuda.empty_cache()
    for name in ("unfiltered", "filtered"):
        if rec[name]["recall@10_vs_two_stage_f32"] < 0.99:
            raise AssertionError(f"multivector {name}: recall@10 against the f32 two-stage "
                                 f"{rec[name]['recall@10_vs_two_stage_f32']} < 0.99")
    return rec


def vector_family_path(db, tbl, x, queries, gt, gt_f, card: str) -> tuple[dict, dict]:
    """Path g on path a's table: IVF_SQ and IVF_RQ, then the query options
    over IVF_PQ (B1 counted from 0 over them; rows are added last), then
    hamming and multivector on tables of their own. Returns (summary, B1's
    record)."""
    results: dict = {"card": card}
    for kind in ("IVF_SQ", "IVF_RQ"):
        results[kind.lower()] = sqrq_index(tbl, queries, gt, gt_f, kind, card)
    results["options"], krec = options_path(tbl, x, queries, card)
    results["hamming"] = hamming_path(db, card)
    results["multivector"] = multivector_path(db, card)
    return results, krec


def vector_family_only(card: str) -> tuple[dict, list[dict]]:
    """Path g alone, on path a's table made anew (seed 0)."""
    import pyarrow as pa
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.probes.common import make_clustered

    n, dim = 1_000_000, 128
    x, queries = make_clustered(np.random.default_rng(0), n, dim, n_queries=256)
    ids = np.arange(n, dtype=np.int64)
    x_d = torch.from_numpy(x).cuda()
    xn2_d = torch.sum(x_d * x_d, dim=1)
    gt = exact_gt(x_d, xn2_d, queries, 10)
    gt_f = exact_gt(x_d, xn2_d, queries, 10, torch.from_numpy(ids % 10 < 5).cuda())
    del x_d, xn2_d
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vf_") as tmp:
        db = lancedb_tpu_torch.connect(tmp)
        tbl = db.create_table("sift1m_like", pa.table({
            "id": ids, "category": ids % 10,
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), dim)}))
        results, krec = vector_family_path(db, tbl, x, queries, gt, gt_f, card)
    print(f"card: {card}", flush=True)
    return results, [krec]


# ---------------------------------------------------------------- path h

# path a's 4-bit x32 configuration and bars, on a table of path h's own
LC_ROWS, LC_DIM, LC_QUERIES, LC_UPSERT, LC_PARTITIONS = 1_000_000, 128, 256, 5_000, 1024
LC_RAW_BAR, LC_REFINED_BAR = RAW_RECALL_BARS[4] - 0.03, 0.99


class LiveRows:
    """What the table must hold, kept beside it on the host: each id's
    vector, category and whether it is live."""

    def __init__(self, x: np.ndarray, extra: int):
        n = len(x)
        self.vec = np.concatenate([x, np.zeros((extra, x.shape[1]), np.float32)])
        self.cat = np.concatenate([np.arange(n) % 10, np.full(extra, -1)]).astype(np.int64)
        self.alive = np.arange(n + extra) < n

    def upsert(self, ids: np.ndarray, vecs: np.ndarray, cats: np.ndarray) -> None:
        self.vec[ids], self.cat[ids], self.alive[ids] = vecs, cats, True

    def ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]

    def truth(self, q: np.ndarray, k: int = 10, category: int | None = None) -> np.ndarray:
        """Exact f32 top-k ids over the live rows (of one category), on the card."""
        import torch

        ids = self.ids() if category is None else np.nonzero(self.alive & (self.cat == category))[0]
        idx, _ = exact_topk(torch.from_numpy(self.vec[ids]).cuda(), q, k, "l2")
        torch.cuda.empty_cache()
        return ids[idx]


def lc_rows(ids: np.ndarray, vecs: np.ndarray, cats: np.ndarray):
    import pyarrow as pa

    return pa.table({"id": ids.astype(np.int64), "category": cats.astype(np.int64),
                     "vector": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()),
                                                                 vecs.shape[1])})


def lc_search(tbl, q: np.ndarray, reps: int = 1, rf=None, where=None):
    """A batch search at nprobes 20, k 10, with ids, categories and row
    addresses: (result, median host ms of ``reps`` calls)."""
    def run():
        s = tbl.search(q).nprobes(20).limit(10).select(["id", "category"]).with_row_id(True)
        if rf:
            s = s.refine_factor(rf)
        if where:
            s = s.where(where)
        return s.to_arrow()

    out, secs = timed(run, reps)
    return out, secs * 1e3


def lc_check_hits(label: str, out, nq: int, dead_ids=None, superseded=None) -> np.ndarray:
    """Raise if a query holds an id twice, a dead id or a superseded row
    address; return each query's top-1 id (-1 where it has no hit)."""
    qi = np.asarray(out.column("query_index")).astype(np.int64)
    ids = np.asarray(out.column("id"))
    if len(np.unique(qi * (1 << 32) + ids)) != len(ids):
        raise AssertionError(f"{label}: a query returned an id twice")
    if dead_ids is not None and np.isin(ids, dead_ids).any():
        raise AssertionError(f"{label}: a deleted id was returned: "
                             f"{ids[np.isin(ids, dead_ids)][:5]}")
    if superseded is not None:
        rids = np.asarray(out.column("_rowid"))
        if np.isin(rids, superseded).any():
            raise AssertionError(f"{label}: a superseded row was returned")
    top1 = np.full(nq, -1, np.int64)
    first = np.r_[0, np.nonzero(np.diff(qi))[0] + 1] if len(qi) else np.zeros(0, np.int64)
    top1[qi[first]] = ids[first]
    return top1


def lc_recall(label: str, out, truth: np.ndarray, bar: float) -> float:
    got = recall(hit_ids(out, len(truth)), truth)
    if got < bar:
        raise AssertionError(f"{label}: recall@10 {got} < {bar}")
    return got


def lifecycle_path(db, card: str) -> tuple[dict, dict]:
    """Path h: the table lifecycle over a 1M x 128 IVF_PQ 4-bit x32 table
    (make_clustered, seed 0, id and category = id % 10), every check
    against a host model of the rows (LiveRows) and exact truth on the
    card. Returns (summary, B1's record)."""
    import asyncio

    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.probes.common import make_clustered
    from lancedb_tpu_torch.session import _searcher_nbytes

    n, nq = LC_ROWS, LC_QUERIES
    x, queries = make_clustered(np.random.default_rng(0), n, LC_DIM, n_queries=nq)
    live = LiveRows(x, 2 * LC_UPSERT + 1)
    rec: dict = {"card": card, "rows": n, "dim": LC_DIM, "queries": nq}
    b1: dict = {}

    def launched(stage: str) -> None:
        """B1's count since the last stage; raise if it did not launch."""
        total = adc.launch_counts["ivf_pq_adc_scan"]
        b1[stage] = total - sum(b1.values())
        if b1[stage] <= 0:
            raise AssertionError(f"lifecycle {stage}: B1 was not launched")

    adc.reset_launch_counts()
    # 1. the table and its index
    t0 = time.perf_counter()
    tbl = db.create_table("lifecycle", lc_rows(np.arange(n), x, np.arange(n) % 10))
    rec["create_table_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    (_, rec["build_s"]) = timed(lambda: tbl.create_index(
        config=IvfPq(num_partitions=LC_PARTITIONS, num_sub_vectors=32, num_bits=4)))
    rec["build_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    lc_search(tbl, queries)  # loads the searcher
    out, rec["search_ms_before_mutations"] = lc_search(tbl, queries, reps=3)
    rec["recall_before"] = recall(hit_ids(out, nq), live.truth(queries))
    launched("build_and_search")
    print(f"[lifecycle] built ({card}): {json.dumps(rec)}", flush=True)

    # 2. merge_insert: 5,000 existing ids with new vectors and categories,
    # 5,000 new ids; the rows they supersede are fragment 0's at offset id
    rng = np.random.default_rng(90)
    matched = np.sort(rng.choice(np.arange(1000, n), LC_UPSERT, replace=False))
    up_ids = np.concatenate([matched, np.arange(n, n + LC_UPSERT)])
    up_vecs = (x[rng.integers(0, n, len(up_ids))] + 0.1 * x.std(axis=0)
               * rng.standard_normal((len(up_ids), LC_DIM))).astype(np.float32)
    up_cats = rng.integers(0, 10, len(up_ids))
    if not np.array_equal(np.asarray(tbl.take_row_ids(matched[:8])["id"]), matched[:8]):
        raise AssertionError("lifecycle: fragment 0 does not hold id i at offset i")
    superseded = matched.astype(np.uint64)
    stats, secs = timed(lambda: tbl.merge_insert("id").when_matched_update_all()
                        .when_not_matched_insert_all().execute(lc_rows(up_ids, up_vecs, up_cats)))
    rec["merge_insert_s"], rec["merge_insert_stats"] = secs, stats
    live.upsert(up_ids, up_vecs, up_cats)
    if tbl.count_rows() != n + LC_UPSERT or stats["num_updated_rows"] != LC_UPSERT:
        raise AssertionError(f"lifecycle merge_insert: {tbl.count_rows()} rows, {stats}")
    out, rec["merged_search_ms"] = lc_search(tbl, up_vecs)
    top1 = lc_check_hits("merged vectors", out, len(up_ids), superseded=superseded)
    rec["merged_top1"] = float(np.mean(top1 == up_ids))
    if rec["merged_top1"] != 1.0:
        bad = np.nonzero(top1 != up_ids)[0][:5]
        raise AssertionError(f"lifecycle: merged vectors not found first: {up_ids[bad]} "
                             f"gave {top1[bad]}")
    out, _ = lc_search(tbl, queries)
    lc_check_hits("after merge_insert", out, nq, superseded=superseded)
    launched("merge_insert")

    # 3. update: category 3 → 42 (about 100k rows rewritten)
    stats, rec["update_s"] = timed(lambda: tbl.update(where="category = 3",
                                                      values={"category": 42}))
    rec["update_rows"] = stats["rows_updated"]
    live.cat[live.cat == 3] = 42
    if rec["update_rows"] != int(np.sum(live.alive & (live.cat == 42))):
        raise AssertionError(f"lifecycle update: {stats}")
    out, rec["filtered_search_ms"] = lc_search(tbl, queries, where="category = 42")
    lc_check_hits("category = 42", out, nq, superseded=superseded)
    if not np.all(np.asarray(out.column("category")) == 42):
        raise AssertionError("lifecycle: a filtered hit is not category 42")
    rec["filtered_recall"] = lc_recall("category = 42", out, live.truth(queries, category=42),
                                       0.99)
    launched("update")

    # 4. delete id < 1000; the queries include 256 deleted rows
    rec["delete_s"] = timed(lambda: tbl.delete("id < 1000"))[1]
    live.alive[:1000] = False
    probe_q = np.concatenate([queries, x[:256]])
    out, _ = lc_search(tbl, probe_q)
    lc_check_hits("after delete", out, len(probe_q), dead_ids=np.arange(1000),
                  superseded=superseded)
    launched("delete")
    if tbl.count_rows() != len(live.ids()):
        raise AssertionError(f"lifecycle: {tbl.count_rows()} rows, {len(live.ids())} expected")

    # 5. the plan: the delta fragments' brute force, timed per operator
    plan = tbl.search(queries).nprobes(20).where("category < 5").limit(10).explain_plan()
    if "KnnFlatExec: delta fragments" not in plan:
        raise AssertionError(f"lifecycle: no delta scan in the plan:\n{plan}")
    analyzed = tbl.search(queries).nprobes(20).where("category < 5").limit(10).analyze_plan()
    print(f"[lifecycle] analyze_plan ({card}):\n{analyzed}", flush=True)
    for op in ("ANNSubIndexExec", "KnnFlatExec", "PrefilterExec", "TakeExec"):
        line = next(ln for ln in analyzed.splitlines() if op in ln)
        if "elapsed_compute=" not in line:
            raise AssertionError(f"lifecycle: {op} was not timed: {line}")
    rec["analyze_plan"] = analyzed
    launched("analyze_plan")

    # 6. the delta's cost; then compaction leaves the index over no live
    # fragment, and a search brute-forces the whole table
    version_v, rows_v = tbl.version, tbl.count_rows()
    saved, rec["search_ms_after_mutations"] = lc_search(tbl, queries, reps=3)
    rec["compact_files_s"] = timed(tbl.compact_files)[1]
    lc_search(tbl, queries)
    out, rec["search_ms_stale_index"] = lc_search(tbl, queries, reps=3)
    truth = live.truth(queries)
    rec["stale_index_recall"] = lc_recall("stale index (brute force)", out, truth, 0.99)
    launched("compact_files")

    # 7. optimize: the reindex on the card
    torch.cuda.reset_peak_memory_stats()
    res, rec["optimize_s"] = timed(tbl.optimize)
    rec["optimize_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    stats = tbl.index_stats("vector_idx")
    rec["optimize_reindex_s"] = stats["params"]["build_seconds"]
    rec["optimize_result"] = res
    if stats["num_unindexed_rows"] != 0 or res["indices_rebuilt"] != 1:
        raise AssertionError(f"lifecycle optimize: {res}, {stats}")
    lc_search(tbl, queries)
    out, rec["search_ms_after_optimize"] = lc_search(tbl, queries, reps=3)
    rec["raw_recall"] = lc_recall("after optimize, raw", out, truth, LC_RAW_BAR)
    out, _ = lc_search(tbl, queries, rf=10)
    rec["refined_recall"] = lc_recall("after optimize, refined", out, truth, LC_REFINED_BAR)
    latest_ids = hit_ids(out, nq)
    launched("optimize")

    # 8. time travel: version v (before compaction) with its own index
    def same_as_saved(label: str) -> None:
        got, _ = lc_search(tbl, queries)
        if not got.column("id").equals(saved.column("id")):
            raise AssertionError(f"{label}: ids differ from version {version_v}'s")
        diff = np.max(np.abs(np.asarray(got.column("_distance"))
                             - np.asarray(saved.column("_distance"))))
        if diff > 1e-6:
            raise AssertionError(f"{label}: distances differ by {diff}")

    tbl.checkout(version_v)
    same_as_saved("checkout(v)")
    tbl.checkout_latest()
    lc_search(tbl, queries, rf=10)  # the latest searcher with its refine table
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ix = next(ix for ix in tbl._dataset.manifest.indices if ix.index_type == "IVF_PQ")
    searcher_bytes = _searcher_nbytes(tbl._get_searcher(ix))
    for trip in range(3):
        tbl.checkout(version_v)
        same_as_saved(f"round trip {trip}")
        tbl.checkout_latest()
        if not np.array_equal(hit_ids(lc_search(tbl, queries, rf=10)[0], nq), latest_ids):
            raise AssertionError(f"round trip {trip}: the latest version's hits changed")
    torch.cuda.synchronize()
    rec["memory_allocated"] = {"first": mem0, "after_3_round_trips": torch.cuda.memory_allocated(),
                               "searcher_bytes": searcher_bytes}
    if rec["memory_allocated"]["after_3_round_trips"] - mem0 > searcher_bytes:
        raise AssertionError(f"lifecycle: device memory grew over checkouts: "
                             f"{rec['memory_allocated']}")
    tbl.tags.create("before_optimize", version_v)
    tbl.checkout("before_optimize")
    if tbl.count_rows() != rows_v:
        raise AssertionError("checkout(tag): the row count is not version v's")
    tbl.checkout_latest()
    tbl.restore(version_v)
    if tbl.count_rows() != rows_v or tbl.list_versions()[-1]["metadata"]["op"] != "restore":
        raise AssertionError("restore(v): not version v's rows")
    same_as_saved("restore(v)")
    launched("time_travel")

    # 9. plain scans, held to pyarrow over to_arrow()
    full, rec["to_arrow_s"] = timed(tbl.to_arrow)
    got_model = full.select(["id", "category"]).sort_by("id")
    if not (np.array_equal(np.asarray(got_model["id"]), live.ids())
            and np.array_equal(np.asarray(got_model["category"]), live.cat[live.ids()])):
        raise AssertionError("lifecycle: to_arrow() is not the rows the table must hold")
    scan, rec["filtered_scan_s"] = timed(
        lambda: tbl.query().where("category = 42").select(["id", "category"]).to_arrow())
    want = full.filter(pc.equal(full["category"], 42)).select(["id", "category"])
    if not scan.equals(want):
        raise AssertionError("lifecycle: the filtered scan is not pyarrow's filter")
    batches, secs = timed(lambda: list(tbl.query().to_batches(65536)))
    if max(b.num_rows for b in batches) > 65536 or not pa.Table.from_batches(batches).equals(full):
        raise AssertionError("lifecycle: to_batches(65536) is not to_arrow()")
    rec["to_batches_rows_per_s"] = full.num_rows / secs
    ordered = tbl.query().where("category = 42").order_by(("id", "desc")).offset(100).limit(1000)
    want = want.sort_by([("id", "descending")]).slice(100, 1000)
    if not ordered.select(["id", "category"]).to_arrow().equals(want):
        raise AssertionError("lifecycle: order_by/offset/limit is not pyarrow's sort")

    # 10. a second connection with read_consistency_interval=0
    db2 = lancedb_tpu_torch.connect(db.uri, db.device, read_consistency_interval=0)
    other = db2.open_table("lifecycle")
    before = other.count_rows()
    pair_ids = np.array([live.ids()[-1], n + LC_UPSERT], np.int64)
    pair_vecs = (queries[:2] + 0.001).astype(np.float32)
    tbl.merge_insert("id").when_matched_update_all().when_not_matched_insert_all().execute(
        lc_rows(pair_ids, pair_vecs, np.array([7, 7])))
    live.upsert(pair_ids, pair_vecs, np.array([7, 7]))
    out, _ = lc_search(other, pair_vecs)
    top1 = lc_check_hits("second connection", out, 2)
    if other.count_rows() != before + 1 or not np.array_equal(top1, pair_ids):
        raise AssertionError(f"second connection: {other.count_rows()} rows after {before}, "
                             f"top-1 {top1} for {pair_ids}")
    db2.close()
    launched("second_connection")

    # 11. async: the same search through connect_async
    async def async_search():
        at = await (await lancedb_tpu_torch.connect_async(db.uri, db.device)).open_table(
            "lifecycle")
        return await at.search(queries).nprobes(20).limit(10).select(["id"]).to_arrow()

    got = asyncio.run(asyncio.wait_for(async_search(), 120))
    want = tbl.search(queries).nprobes(20).limit(10).select(["id"]).to_arrow()
    if not got.column("id").equals(want.column("id")):
        raise AssertionError("lifecycle: the async search's ids are not the sync search's")
    launched("async")

    rec["b1_launches"] = b1
    rec["b1_launches_total"] = adc.launch_counts["ivf_pq_adc_scan"]
    ix = next(ix for ix in tbl._dataset.manifest.indices if ix.index_type == "IVF_PQ")
    krec = check_adc(searcher_adc_args(tbl._get_searcher(ix), queries),
                     "lifecycle (IVF_PQ 4-bit x32 after the mutations)")
    krec["launches"] = rec["b1_launches_total"]
    print(f"[lifecycle] ({card}): {json.dumps({k: v for k, v in rec.items() if k != 'analyze_plan'})}",
          flush=True)
    return rec, krec


def lifecycle_phase(card: str) -> tuple[dict, list[dict]]:
    """Path h on a database of its own."""
    import lancedb_tpu_torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lc_") as tmp:
        results, krec = lifecycle_path(lancedb_tpu_torch.connect(tmp), card)
    print(f"card: {card}", flush=True)
    return results, [krec]


# ---------------------------------------------------------------- path i
# BASELINE config #5's sharded IVF_PQ at DEEP's widths (Deep1B, 96-d f32;
# big-ann-benchmarks serves 10M and 100M subsets), cut from 100M to 10M rows
MESH_ROWS, MESH_DIM, MESH_QUERIES = 10_000_000, 96, 256
MESH_PARTITIONS, MESH_NSUB = 4096, 12
MESH_DEVICE = "cuda:0"
MESH_IVF_ROWS, MESH_IVF_PARTITIONS = 1_000_000, 1024
FEED_ROWS, FEED_BATCH = 2_000_000, 4096


def exact_topk_chunked(x_d, q: np.ndarray, k: int, mask_d=None, chunk: int = 1 << 20,
                       bf16: bool = False):
    """Exact f32 top-k l2 ids on the card (TF32 off), a chunk of rows at a
    time so the (Q, chunk) distances stay bounded. ``bf16``: the products
    take q and x rounded to bf16 (f32 norms), as a bf16 brute force does."""
    import torch

    from lancedb_tpu_torch.ops.util import lowp

    qd = torch.from_numpy(q).to(x_d.device)
    if bf16:
        qd = lowp(qd)
    best_v = best_i = None
    for s in range(0, x_d.shape[0], chunk):
        xc = x_d[s : s + chunk]
        d = torch.sum(xc * xc, dim=1)[None, :] - 2.0 * (qd @ (lowp(xc) if bf16 else xc).T)
        if mask_d is not None:
            d = torch.where(mask_d[None, s : s + chunk], d, float("inf"))
        v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        i = i + s
        if best_v is not None:
            v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1, largest=False)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy()


def overlap_check(label: str, got_ids, got_d, want_ids, want_d) -> dict:
    """A mesh's hits against the single-device searcher's: >= 9 of 10 ids
    a query, mean overlap >= 0.99, sorted distances within 1e-3."""
    per_q = np.array([len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got_ids, want_ids)])
    worst_d = float(np.max(np.abs(np.sort(got_d, 1) - np.sort(want_d, 1))))
    out = {"min_overlap": int(per_q.min()), "mean_overlap": float(per_q.mean() / 10),
           "max_sorted_distance_diff": worst_d}
    if per_q.min() < 9 or per_q.mean() / 10 < 0.99 or worst_d > 1e-3:
        raise AssertionError(f"{label}: the 1-shard mesh disagrees with one device: {out}")
    return out


def batch_hits(out, nq: int, k: int = 10):
    """(ids (nq, k), distances (nq, k), categories of every hit) of a batch."""
    qi = np.asarray(out.column("query_index"))
    ids = np.full((nq, k), -1, np.int64)
    dist = np.full((nq, k), np.inf, np.float32)
    col_i, col_d = np.asarray(out.column("id")), np.asarray(out.column("_distance"))
    for q in range(nq):
        m = qi == q
        ids[q, : m.sum()] = col_i[m][:k]
        dist[q, : m.sum()] = col_d[m][:k]
    return ids, dist, np.asarray(out.column("category"))


def mesh_searches(tbl, queries, cases, gt_of) -> dict:
    """Each case (name, refine_factor, where): B1's count set to 0, one warm
    call, the median host ms of 3 more, then the count read; recall@10 of
    the last against its truth."""
    import torch

    from lancedb_tpu_torch.ops import adc

    out = {}
    for name, rf, where in cases:
        def run():
            s = tbl.search(queries).nprobes(20).limit(10).select(["id", "category"])
            if rf:
                s = s.refine_factor(rf)
            if where:
                s = s.where(where)
            t = time.perf_counter()
            res = s.to_arrow()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t) * 1e3

        adc.reset_launch_counts()
        run()  # loads the searcher (and the refine table)
        reps = [run() for _ in range(3)]
        launches = adc.launch_counts["ivf_pq_adc_scan"]
        ids, dist, cats = batch_hits(reps[-1][0], len(queries))
        if where is not None and not np.all(cats == 3):
            raise AssertionError(f"mesh {name}: a filtered hit has category != 3")
        if launches <= 0:
            raise AssertionError(f"mesh {name}: B1 was not launched")
        out[name] = {"recall@10": recall(ids, gt_of[name]),
                     "ms_per_256q_batch": float(np.median([r[1] for r in reps])),
                     "b1_launches": launches, "ids": ids, "distances": dist}
    return out


def public(res: dict) -> dict:
    """A search summary without its id and distance arrays."""
    return {name: {k: v for k, v in r.items() if k not in ("ids", "distances")}
            for name, r in res.items()}


def feed_rows(batch):
    """StreamingDataset transform of the feed: one dict of numpy values a row."""
    from lancedb_tpu_torch.arrow import fsl_to_numpy

    vec = fsl_to_numpy(batch.column("vector"))
    ids = batch.column("id").to_numpy()
    return [{"vector": v, "id": i} for v, i in zip(vec, ids)]


def feed_path(tbl, mesh, label: str, card: str) -> dict:
    """TorchBatchFeeder over the table on ``mesh``: rows/s over FEED_ROWS,
    every tensor on the card, sampled batches equal to the host's rows,
    and the resume after 100 batches bit for bit."""
    import itertools

    import torch

    from lancedb_tpu_torch.arrow import fsl_to_numpy
    from lancedb_tpu_torch.data import StreamingDataset, TorchBatchFeeder

    def feeder():
        sds = StreamingDataset(tbl, columns=["vector", "id"], read_batch_size=FEED_BATCH,
                               transform=feed_rows)
        return TorchBatchFeeder(sds, FEED_BATCH, mesh=mesh, columns=["vector", "id"])

    def host_cat(batch):
        return {k: (torch.cat(v) if isinstance(v, list) else v).cpu() for k, v in batch.items()}

    n_batches = -(-FEED_ROWS // FEED_BATCH)
    f = feeder()
    it = iter(f)
    t = time.perf_counter()
    batches = list(itertools.islice(it, n_batches))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    it.close()
    n_dev = mesh.size
    for b in batches:
        for col in b.values():
            parts = col if isinstance(col, list) else [col]
            if len(parts) != n_dev or any(p.device != torch.device(MESH_DEVICE) for p in parts):
                raise AssertionError(f"feed {label}: a batch is not on the mesh's cards")
    for bi in (0, 1, n_batches // 2, n_batches - 1):
        got = host_cat(batches[bi])
        want = tbl._dataset.take_offsets(np.arange(bi * FEED_BATCH, (bi + 1) * FEED_BATCH),
                                         columns=["vector", "id"])
        if not (np.array_equal(got["vector"].numpy(), fsl_to_numpy(want.column("vector")))
                and np.array_equal(got["id"].numpy(), want.column("id").to_numpy())):
            raise AssertionError(f"feed {label}: batch {bi} differs from the host's rows")
    del batches
    # resume: the state after 100 batches gives the uninterrupted run's next 10
    f = feeder()
    it = iter(f)
    for _ in range(100):
        next(it)
    state = f.state_dict()
    want = [host_cat(next(it)) for _ in range(10)]
    it.close()
    f2 = feeder()
    f2.load_state_dict(state)
    got = [host_cat(b) for b in itertools.islice(iter(f2), 10)]
    same = len(got) == 10 and all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w)
    if not same:
        raise AssertionError(f"feed {label}: the resumed feeder does not continue the run")
    rec = {"rows": n_batches * FEED_BATCH, "seconds": secs,
           "rows_per_s": n_batches * FEED_BATCH / secs, "devices": n_dev,
           "resume_after_100_batches_exact": True}
    print(f"[mesh] feed {label} ({card}): {json.dumps(rec)}", flush=True)
    return rec


def mesh_path(card: str) -> tuple[dict, dict]:
    """Path i: config #5's sharded IVF_PQ at DEEP's widths, served through
    enable_sharded_serving on a 1-shard and a 4-shard mesh of the one card,
    the distributed build, sharded FLAT and IVF_FLAT search, B1 on one
    shard's inputs, and the training feed. Returns (summary, B1's record)."""
    import gc
    import itertools

    import pyarrow as pa
    import torch

    import lancedb_tpu_torch
    from lancedb_tpu_torch.data import StreamingDataset
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.index.vector import SearchParams
    from lancedb_tpu_torch.ops import adc
    from lancedb_tpu_torch.ops.util import round_up
    from lancedb_tpu_torch.parallel import (ShardedFlatIndex, ShardedIvfPqIndex,
                                            distributed_kmeans, make_mesh,
                                            make_sharded_ivf_search, replicate, shard_rows)
    from lancedb_tpu_torch.probes.common import make_clustered
    from lancedb_tpu_torch.query import _deleted_rowids
    from lancedb_tpu_torch.session import _searcher_nbytes

    n, dim, nq, k = MESH_ROWS, MESH_DIM, MESH_QUERIES, 10
    rec: dict = {"card": card, "rows": n, "dim": dim, "queries": nq}
    t0 = time.perf_counter()
    x, queries = make_clustered(np.random.default_rng(0), n, dim, n_queries=nq)
    ids = np.arange(n, dtype=np.int64)
    rec["data_s"] = time.perf_counter() - t0
    x_d = torch.from_numpy(x).to(MESH_DEVICE)
    cat3_d = torch.from_numpy(ids % 10 == 3).to(MESH_DEVICE)
    gt = exact_topk_chunked(x_d, queries, k)
    gt_f = exact_topk_chunked(x_d, queries, k, cat3_d)
    gt_del = exact_topk_chunked(x_d, queries, k, torch.from_numpy(ids % 1000 != 0).to(MESH_DEVICE))
    gt_ivf = exact_topk_chunked(x_d[:MESH_IVF_ROWS], queries, k)
    # the bar of the sharded FLAT scan, whose products are bf16: a plain
    # bf16 brute force of the same rows (at 10M rows about 150 rows share
    # each parent cluster, more than bf16 can order)
    bf16_recall = recall(exact_topk_chunked(x_d, queries, k, bf16=True), gt)
    del x_d, cat3_d
    torch.cuda.empty_cache()
    truth = {"raw": gt, "refined": gt, "filtered": gt_f, "raw_after_delete": gt_del}
    mesh1 = make_mesh(devices=[MESH_DEVICE])
    mesh4 = make_mesh(devices=[MESH_DEVICE] * 4)
    cases = [("raw", None, None), ("refined", 10, None), ("filtered", None, "category = 3")]
    b1_total = 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        db = lancedb_tpu_torch.connect(tmp)
        t0 = time.perf_counter()
        tbl = db.create_table("deep10m_like", pa.table({
            "id": ids, "category": ids % 10,
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), dim),
        }))
        rec["create_table_s"] = time.perf_counter() - t0
        # 1. the index on one device
        torch.cuda.reset_peak_memory_stats()
        _, rec["build_s"] = timed(lambda: tbl.create_index(config=IvfPq(
            num_partitions=MESH_PARTITIONS, num_sub_vectors=MESH_NSUB, num_bits=8)))
        rec["build_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        print(f"[mesh] built ({card}): {json.dumps(rec)}", flush=True)
        # 3. one device, then 4. the 1-shard and the 4-shard mesh
        res = {"single": mesh_searches(tbl, queries, cases, truth)}
        for label, mesh in (("mesh1", mesh1), ("mesh4", mesh4)):
            tbl.enable_sharded_serving(mesh)
            res[label] = mesh_searches(tbl, queries, cases, truth)
        tbl.disable_sharded_serving()
        checks = {}
        for name, _, _ in cases:
            s, m1, m4 = res["single"][name], res["mesh1"][name], res["mesh4"][name]
            checks[name] = overlap_check(f"mesh1 {name}", m1["ids"], m1["distances"],
                                         s["ids"], s["distances"])
            if m4["recall@10"] < s["recall@10"] - 0.01:
                raise AssertionError(f"mesh4 {name}: recall {m4['recall@10']} < "
                                     f"{s['recall@10']} - 0.01")
            if m4["b1_launches"] != 4 * m1["b1_launches"]:
                raise AssertionError(f"mesh4 {name}: {m4['b1_launches']} B1 launches, not 4 x "
                                     f"{m1['b1_launches']}")
        b1_total += sum(r[name]["b1_launches"] for r in res.values() for name, _, _ in cases)
        # deletions, then the raw search on one device and on both meshes
        tbl.delete("id % 1000 = 0")
        after = [("raw_after_delete", None, None)]
        res["single"].update(mesh_searches(tbl, queries, after, truth))
        single = tbl._get_searcher(tbl._dataset.manifest.indices[0])
        mem_single = torch.cuda.memory_allocated()
        # one raw searcher call of each under torch.profiler: the card's
        # busy time and idle share, the four shards' launches serialised
        raw_params = SearchParams(k=k, nprobes=20)
        profiles = {"single": profile_search(single, queries, raw_params)}
        for label, mesh in (("mesh1", mesh1), ("mesh4", mesh4)):
            tbl.enable_sharded_serving(mesh)
            res[label].update(mesh_searches(tbl, queries, after, truth))
            profiles[label] = profile_search(next(iter(tbl._searchers.values())), queries,
                                             raw_params)
        rec["profiled_searcher_raw"] = profiles
        s, m1, m4 = (res[m]["raw_after_delete"] for m in ("single", "mesh1", "mesh4"))
        checks["raw_after_delete"] = overlap_check("mesh1 after delete", m1["ids"],
                                                   m1["distances"], s["ids"], s["distances"])
        for label, r in (("single", s), ("mesh1", m1), ("mesh4", m4)):
            if np.any((r["ids"] % 1000 == 0) & (r["ids"] >= 0)):
                raise AssertionError(f"{label}: a deleted id was returned")
        if m4["recall@10"] < s["recall@10"] - 0.01 or m4["b1_launches"] != 4 * m1["b1_launches"]:
            raise AssertionError(f"mesh4 after delete: {public({'mesh4': m4, 'single': s})}")
        b1_total += sum(r["b1_launches"] for r in (s, m1, m4))
        # 7. B1 on one shard's inputs: the dealt codes with the deletion
        # penalty added, the budget's probes, 128 queries
        sharded = next(iter(tbl._searchers.values()))._sharded
        deleted, vanished = _deleted_rowids(tbl._dataset, tbl._dataset.manifest.indices[0],
                                            next(iter(tbl._searchers.values())))
        pen = sharded.dealt_penalty(sharded.slot_penalty(None, deleted, vanished))
        q128 = torch.from_numpy(queries[:128]).to(MESH_DEVICE)
        b1_args_shard, _, _ = sharded._scan_inputs(0, 0, q128, q128, pen,
                                                   sharded.block_nprobes(20))
        krec = check_adc(b1_args_shard, "mesh4 shard 0 (after the deletions)")
        del b1_args_shard, pen, sharded
        tbl.disable_sharded_serving()
        gc.collect()
        mem_after = torch.cuda.memory_allocated()
        rec["memory"] = {"with_single_searcher_bytes": mem_single,
                         "after_disable_bytes": mem_after,
                         "one_searcher_bytes": _searcher_nbytes(single)}
        if abs(mem_after - mem_single) > _searcher_nbytes(single):
            raise AssertionError(f"mesh: device memory not released: {rec['memory']}")
        del single
        tbl._invalidate_caches()
        torch.cuda.empty_cache()
        rec["searches"] = {label: public(r) for label, r in res.items()}
        rec["mesh1_vs_single"] = checks
        print(f"[mesh] searches ({card}): {json.dumps(rec['searches'])}", flush=True)
        print(f"[mesh] profiled raw searcher calls ({card}): {json.dumps(profiles)}", flush=True)

        # 8. the feed: StreamingDataset over the table, to the card; then
        # the host read alone (the dataset without the feeder), warm as well
        rec["feed"] = {label: feed_path(tbl, mesh, label, card)
                       for label, mesh in (("mesh1", mesh1), ("mesh4", mesh4))}
        sds = StreamingDataset(tbl, columns=["vector", "id"], read_batch_size=FEED_BATCH,
                               transform=feed_rows)
        t0 = time.perf_counter()
        n_read = sum(1 for _ in itertools.islice(iter(sds), FEED_ROWS // 4))
        rec["feed_host_read_rows_per_s"] = n_read / (time.perf_counter() - t0)

        # 5. the distributed build on the 4-shard mesh
        adc.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        six, rec["distributed_build_s"] = timed(lambda: ShardedIvfPqIndex(
            mesh4, x, ids.view(np.uint64), MESH_PARTITIONS, MESH_NSUB))
        rec["distributed_build_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
        (d_v, d_ids), ms = timed(lambda: six.search(queries, k=k, nprobes=20), 3)
        dist = {"raw": {"recall@10": recall(d_ids.astype(np.int64), gt), "ms": ms * 1e3}}
        slot_ids = six.row_ids.astype(np.int64)
        live = slot_ids >= 0
        vecs = np.zeros((six.num_slots, dim), np.float32)
        vecs[live] = x[slot_ids[live]]
        six.attach_refine_table(vecs, np.sum(vecs.astype(np.float64) ** 2, 1).astype(np.float32))
        del vecs
        (_, r_ids), ms = timed(lambda: six.search(queries, k=100, nprobes=20, refine_k=k), 3)
        dist["refined"] = {"recall@10": recall(r_ids.astype(np.int64), gt), "ms": ms * 1e3}
        dist["b1_launches"] = adc.launch_counts["ivf_pq_adc_scan"]
        b1_total += dist["b1_launches"]
        if dist["b1_launches"] <= 0:
            raise AssertionError("distributed build: B1 was not launched")
        bar = res["single"]["raw"]["recall@10"] - 0.03
        if dist["raw"]["recall@10"] < bar:
            raise AssertionError(f"distributed build: raw recall {dist['raw']} < {bar}")
        rec["distributed"] = dist
        print(f"[mesh] distributed build ({card}): {json.dumps(dist)} "
              f"{rec['distributed_build_s']:.3f} s", flush=True)
        del six, tbl, db
        gc.collect()
        torch.cuda.empty_cache()

    # 6. sharded FLAT over the 10M rows, and sharded IVF_FLAT over 1M
    flat, flat_ids = {}, {}
    for label, mesh in (("mesh4", mesh4), ("mesh1", mesh1)):
        idx = ShardedFlatIndex(mesh, x, ids)
        (_, f_ids), ms = timed(lambda: idx.search(queries, k), 3)
        flat_ids[label] = f_ids.astype(np.int64)
        flat[label] = {"recall@10": recall(flat_ids[label], gt), "ms": ms * 1e3}
        del idx
        torch.cuda.empty_cache()
    flat["mesh4_vs_mesh1_overlap"] = recall(flat_ids["mesh4"], flat_ids["mesh1"])
    flat["plain_bf16_recall@10"] = bf16_recall
    if (flat["mesh4"]["recall@10"] < bf16_recall - 0.01
            or flat["mesh4_vs_mesh1_overlap"] < 0.99):
        raise AssertionError(f"sharded flat: {flat}")
    x1 = x[:MESH_IVF_ROWS]
    t0 = time.perf_counter()
    cents = distributed_kmeans(mesh4, x1, MESH_IVF_PARTITIONS, iters=25, seed=0)
    kmeans_s = time.perf_counter() - t0
    cd = torch.from_numpy(cents).to(MESH_DEVICE)
    xd = torch.from_numpy(x1).to(MESH_DEVICE)
    assign = torch.cat([torch.argmin(torch.sum(cd * cd, 1)[None] - 2.0 * (xc @ cd.T), 1)
                        for xc in torch.split(xd, 1 << 17)]).cpu().numpy()
    del cd, xd
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=MESH_IVF_PARTITIONS)
    pmax = round_up(int(counts.max()), 8)
    parts = np.zeros((MESH_IVF_PARTITIONS, pmax, dim), np.float32)
    rowids = np.full((MESH_IVF_PARTITIONS, pmax), -1, np.int32)
    slot = np.arange(MESH_IVF_ROWS) - np.repeat(np.cumsum(counts) - counts, counts)
    parts[assign[order], slot] = x1[order]
    rowids[assign[order], slot] = order
    norms2 = np.sum(parts.astype(np.float64) ** 2, 2).astype(np.float32)
    norms2[rowids < 0] = np.float32(3.0e38)
    step = make_sharded_ivf_search(mesh4, k=k, nprobes=20)
    placed = (shard_rows(mesh4, queries, over="query"), replicate(mesh4, cents),
              shard_rows(mesh4, parts), shard_rows(mesh4, norms2), shard_rows(mesh4, rowids))
    (_, ivf_ids), ms = timed(lambda: step(*placed), 3)
    ivf = {"recall@10": recall(ivf_ids.cpu().numpy().astype(np.int64), gt_ivf), "ms": ms * 1e3,
           "pmax": pmax, "kmeans_s": kmeans_s}
    del placed, parts
    torch.cuda.empty_cache()
    if ivf["recall@10"] < 0.95:
        raise AssertionError(f"sharded IVF_FLAT: {ivf}")
    rec["sharded_flat"], rec["sharded_ivf_flat"] = flat, ivf
    print(f"[mesh] sharded flat / IVF_FLAT ({card}): "
          f"{json.dumps({'flat': rec['sharded_flat'], 'ivf': ivf})}", flush=True)

    krec["launches"] = b1_total
    rec["b1_launches_total"] = b1_total
    print(f"[mesh] ({card}): {json.dumps({k2: v for k2, v in rec.items() if k2 != 'searches'})}",
          flush=True)
    return rec, krec


def mesh_phase(card: str) -> tuple[dict, list[dict]]:
    """Path i alone."""
    results, krec = mesh_path(card)
    print(f"card: {card}", flush=True)
    return results, [krec]


# ---------------------------------------------------------------- path j
# the bench's FTS corpus (bench.py:426 make_corpus, 1,000,000 docs as in its
# FTS config, bench.py:1296-1425) as a LanceModel table embedded by "hash"
TS_DOCS, TS_BATCH, TS_QUERIES, TS_HYBRID = 1_000_000, 100_000, 256, 64
TS_PARTITIONS, TS_SUBVECTORS, TS_NPROBES = 1024, 32, 20  # 8 dims a sub-vector
TS_LSM_ROWS, TS_LSM_SHARDS, TS_LSM_CHECKED = 10_000, 4, 256
TS_BLOB_ROWS, TS_BLOB_QUERIES = 10_000, 32
TS_BLOB_SIZES = (1 << 10, 128 << 10)  # thumbnails of 1-128 KiB
TS_ZERO = 1e-5  # |distance| of a row found by its own text (f32 rounding)
# Bags of Zipf words embed to many equal distances: a hit counts as right
# when its exact distance is within TS_TIE of the 10th exact distance
TS_TIE = 1e-4
# tests/embed_reference_bars.py: the reference's recall@10 (ties counted) on
# the CPU at path j's settings (1M docs, nprobes 20), less 0.03; refined at
# least 0.95 too
TS_BARS = {"raw": 0.904296875 - 0.03, "refined": max(0.963671875 - 0.03, 0.95),
           "filtered": 0.876171875 - 0.03}


def exact_topk_kth(x_d, xn2_d, q: np.ndarray, k: int, mask_d=None):
    """Exact f32 top-k l2 on the card (TF32 off), optionally over a row
    mask: (ids (Q, k), the k-th smallest distance less |q|² per query)."""
    import torch

    d = xn2_d[None, :] - 2.0 * (torch.from_numpy(q).cuda() @ x_d.T)
    if mask_d is not None:
        d = torch.where(mask_d[None, :], d, torch.full_like(d, float("inf")))
    top = torch.topk(d, k, dim=1, largest=False)
    return top.indices.cpu().numpy(), top.values[:, -1].cpu().numpy()


def tie_recall(hits: np.ndarray, q: np.ndarray, x: np.ndarray, kth: np.ndarray) -> float:
    """recall@k counting ties: a hit (an id, -1 for none) is right when its
    exact distance (the same f32 form as exact_topk_kth, on the host) is
    within TS_TIE of the query's k-th exact distance."""
    right = 0
    for i, ids in enumerate(hits):
        xi = x[ids[ids >= 0]]
        d = (xi * xi).sum(1) - 2.0 * (xi @ q[i])
        right += int(np.sum(d <= kth[i] + TS_TIE))
    return right / hits.size


def ts_rows(ids: np.ndarray, texts: list[str], vecs=None):
    """Rows of path j's table (category = id % 10), with vectors when given."""
    import pyarrow as pa

    cols = {"id": ids.astype(np.int64), "text": texts}
    if vecs is not None:
        cols["vector"] = pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), vecs.shape[1])
    cols["category"] = (ids % 10).astype(np.int64)
    return pa.table(cols)


def ts_text_searches(tbl, fn, texts: list[str], k: int, card: str) -> tuple[dict, dict]:
    """Each string through search(s, query_type="vector") at nprobes 20,
    raw, refine_factor(10) and where("category = 3"), one call a string,
    then search(v) with v = fn.compute_query_embeddings(s): the same ids
    and distances, exactly. B1 is counted over the text searches and must
    launch once a call (one 128-query chunk). Returns (summary, the hit
    ids (nq, k) per mode)."""
    import torch

    from lancedb_tpu_torch.ops import adc

    modes = {"raw": {}, "refined": {"refine_factor": 10}, "filtered": {"where": "category = 3"}}

    def one(q, opts):
        b = tbl.search(q, query_type="vector").nprobes(TS_NPROBES).limit(k).select(["id"])
        for method, arg in opts.items():
            b = getattr(b, method)(arg)
        return b.to_arrow()

    t0 = time.perf_counter()
    vecs = [fn.compute_query_embeddings(s)[0] for s in texts]
    rec: dict = {"embed_256_queries_s": time.perf_counter() - t0}
    for opts in modes.values():  # warm: the searcher, the refine table
        one(texts[0], opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ids = {}
    for mode, opts in modes.items():
        adc.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [one(s, opts) for s in texts]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = adc.launch_counts["ivf_pq_adc_scan"]
        want = [one(v, opts) for v in vecs]
        for i, (a, b) in enumerate(zip(outs, want)):
            if not (np.array_equal(np.asarray(a["id"]), np.asarray(b["id"]))
                    and np.array_equal(np.asarray(a["_distance"]), np.asarray(b["_distance"]))):
                raise AssertionError(f"path j {mode} {i}: the text search is not search(v)")
        hits = np.full((len(texts), k), -1, np.int64)
        for i, out in enumerate(outs):
            hits[i, : out.num_rows] = np.asarray(out["id"])
        ids[mode] = hits
        rec[mode] = {"ms_per_query": dt / len(texts) * 1e3, "qps": len(texts) / dt,
                     "b1_launches": launches, "b1_expected": len(texts)}
        if launches != len(texts):
            raise AssertionError(f"path j {mode}: B1 launched {launches} times over "
                                 f"{len(texts)} one-query searches")
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    print(f"[table_surface] text searches ({card}): {json.dumps(rec)}", flush=True)
    return rec, ids


def ts_hybrid(tbl, fn, texts: list[str], k: int, card: str) -> dict:
    """One-string hybrid: each string one call, then all of them in one
    add_query call; every fused top-10 equals numpy_rrf of its two legs
    (the vector leg of the embedded string, the FTS leg of the string)."""
    import pyarrow as pa

    from lancedb_tpu_torch.ops import adc

    def single(s):
        return tbl.search(s, query_type="hybrid").limit(k).with_row_id().to_arrow()

    def batched():
        b = tbl.search(texts[0], query_type="hybrid").limit(k).with_row_id()
        for s in texts[1:]:
            b.add_query(text=s)
        return b.to_arrow()

    single(texts[0])  # warm: the FTS index loads
    adc.reset_launch_counts()
    singles, single_s = timed(lambda: [single(s) for s in texts])
    single_launches = adc.launch_counts["ivf_pq_adc_scan"]
    adc.reset_launch_counts()
    fused_all, batch_s = timed(batched, reps=3)
    batched_launches = adc.launch_counts["ivf_pq_adc_scan"] // 3
    vecs = np.stack([fn.compute_query_embeddings(s)[0] for s in texts])
    v_all = tbl.search(vecs).limit(k).with_row_id().to_arrow()
    f_legs = [tbl.search(s, query_type="fts").limit(k).with_row_id().to_arrow() for s in texts]
    vq_idx, f_idx = np.asarray(v_all.column("query_index")), np.asarray(
        fused_all.column("query_index"))
    for i, s in enumerate(texts):
        check_rrf(fused_all.filter(pa.array(f_idx == i)), v_all.filter(pa.array(vq_idx == i)),
                  f_legs[i], f"path j batched hybrid {i}")
        v1 = tbl.search(vecs[i]).limit(k).with_row_id().to_arrow()
        check_rrf(singles[i], v1, f_legs[i], f"path j hybrid {i}")
    rec = {"queries": len(texts), "per_query_qps": len(texts) / single_s,
           "batched_ms": batch_s * 1e3, "batched_qps": len(texts) / batch_s,
           "single_launches_b1": single_launches, "batched_launches_b1": batched_launches}
    print(f"[table_surface] hybrid ({card}): {json.dumps(rec)}", flush=True)
    if single_launches != len(texts) or batched_launches != 1:
        raise AssertionError(f"path j hybrid: B1 launched {single_launches} times over "
                             f"{len(texts)} calls and {batched_launches} per batched call")
    return rec


def ts_find_own_rows(tbl, fn, texts: list[str], ids: np.ndarray, label: str, rf=None) -> dict:
    """Each text's vector search finds its row at distance 0: the top hit's
    exact distance to the text's vector is 0 (within TS_ZERO, f32 rounding),
    and its own id is among the top 10 unless ten rows with the same
    vector (the same bag of words) fill them. Returns the seconds, the
    largest top-hit distance and how many texts had ten such duplicates."""
    worst, crowded = 0.0, 0
    t0 = time.perf_counter()
    for s, want in zip(texts, ids):
        b = tbl.search(s, query_type="vector").nprobes(TS_NPROBES).limit(10).select(["id",
                                                                                     "vector"])
        out = (b.refine_factor(rf) if rf else b).to_arrow()
        q = fn.compute_query_embeddings(s)[0]
        v = out["vector"].combine_chunks().values.to_numpy().reshape(out.num_rows, -1)
        exact = np.sum((v - q) ** 2, axis=1)
        got = np.asarray(out["id"])
        duplicates = int(np.sum(exact <= TS_ZERO))
        if not out.num_rows or exact[0] > TS_ZERO or (want not in got and duplicates < 10):
            raise AssertionError(f"{label}: id {want} not found at distance 0: {got} {exact}")
        crowded += int(want not in got)
        worst = max(worst, float(exact[0]))
    return {"ms_per_query": (time.perf_counter() - t0) / len(texts) * 1e3,
            "max_top_hit_distance": worst, "crowded_out_by_duplicates": crowded}


def ts_lsm(tbl, fn, k: int, card: str) -> dict:
    """The LSM write path on path j's table: a bucketed spec on id (no
    maintained index, so the flush leaves the indexes to the delta merge),
    one use_lsm upsert of 5,000 new ids and 5,000 rewritten texts carrying
    the function's vectors, a use_lsm scan (the new texts, no superseded
    one), flush_lsm, then the 256 checked texts found at distance 0 through
    the delta merge and again after optimize()."""
    import pyarrow.compute as pc
    import torch

    from lancedb_tpu_torch.ops import adc

    half = TS_LSM_ROWS // 2
    old_ids = np.sort(np.random.default_rng(5).choice(TS_DOCS, half, replace=False))
    ids = np.concatenate([old_ids, TS_DOCS + np.arange(half)])
    texts = make_corpus(np.random.default_rng(2), TS_LSM_ROWS)
    rows = ts_rows(ids, texts, fn.compute_source_embeddings(texts))
    rec: dict = {"rows": TS_LSM_ROWS, "rewritten": half, "new": half}
    tbl.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=TS_LSM_SHARDS,
                           maintained_indexes=[])
    t0 = time.perf_counter()
    put = (tbl.merge_insert("id").when_matched_update_all().when_not_matched_insert_all()
           .use_lsm().execute(rows))
    rec["put_s"] = time.perf_counter() - t0
    if put["num_rows"] != TS_LSM_ROWS or tbl.count_rows() != TS_DOCS:
        raise AssertionError(f"path j LSM put: {put}, {tbl.count_rows()} rows in the table")
    t0 = time.perf_counter()
    scan = tbl.query().use_lsm().select(["id", "text"]).to_arrow()
    rec["scan_s"] = time.perf_counter() - t0
    sid = np.asarray(scan["id"])
    order = np.argsort(sid, kind="stable")
    if len(sid) != TS_DOCS + half or len(np.unique(sid)) != len(sid):
        raise AssertionError(f"path j LSM scan: {len(sid)} rows, {len(np.unique(sid))} ids")
    pos = order[np.searchsorted(sid[order], ids)]
    if not pc.all(pc.equal(scan["text"].take(pos), rows["text"])).as_py():
        raise AssertionError("path j LSM scan: a row does not carry its newest text")
    t0 = time.perf_counter()
    flushed = tbl.flush_lsm()
    rec["flush_s"] = time.perf_counter() - t0
    merge = flushed["merge"]
    rec["flush"] = {"rows_flushed": flushed["rows_flushed"],
                    "updated": merge["num_updated_rows"], "inserted": merge["num_inserted_rows"]}
    if (flushed["rows_flushed"], merge["num_updated_rows"], merge["num_inserted_rows"]) != (
            TS_LSM_ROWS, half, half) or tbl.count_rows() != TS_DOCS + half:
        raise AssertionError(f"path j LSM flush: {rec['flush']}, {tbl.count_rows()} rows")
    m = TS_LSM_CHECKED // 2  # rewritten and new rows alike
    pick = np.concatenate([np.arange(m), half + np.arange(m)])
    check_texts, check_ids = [texts[i] for i in pick], ids[pick]
    adc.reset_launch_counts()
    rec["delta_merge"] = ts_find_own_rows(tbl, fn, check_texts, check_ids,
                                          "path j after flush_lsm")
    rec["delta_merge"]["b1_launches"] = adc.launch_counts["ivf_pq_adc_scan"]
    # one search through the delta merge, each operator timed
    plan = tbl.search(check_texts[0], query_type="vector").nprobes(TS_NPROBES).limit(10) \
        .analyze_plan()
    print(f"[table_surface] analyze_plan through the delta merge ({card}):\n{plan}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt = tbl.optimize()
    torch.cuda.synchronize()
    rec["optimize_s"] = time.perf_counter() - t0
    rec["indices_rebuilt"] = opt["indices_rebuilt"]
    adc.reset_launch_counts()
    rec["after_optimize"] = ts_find_own_rows(tbl, fn, check_texts, check_ids,
                                             "path j after optimize", rf=10)
    rec["after_optimize"]["b1_launches"] = adc.launch_counts["ivf_pq_adc_scan"]
    print(f"[table_surface] LSM ({card}): {json.dumps(rec)}", flush=True)
    for stage in ("delta_merge", "after_optimize"):
        if rec[stage]["b1_launches"] != TS_LSM_CHECKED:
            raise AssertionError(f"path j {stage}: B1 launched {rec[stage]['b1_launches']} "
                                 f"times over {TS_LSM_CHECKED} searches")
    if tbl.lsm_stats()["total_wal_rows"] or opt["indices_rebuilt"] < 2:
        raise AssertionError(f"path j: WAL not empty or indexes not rebuilt: {opt}")
    return rec


def ts_blobs(db, card: str) -> dict:
    """Blobs on a second table: 10,000 seeded captions, their hash vectors
    (an embedding definition on the caption) and one blob column of
    seeded 1-128 KiB payloads. A flat search of 32 captions at k 10, then
    fetch_blobs, fetch_blob_files (whole reads and a seek) and
    fetch_blob_ranges of the hits, each equal to the script's payloads."""
    import pyarrow as pa
    import torch

    from lancedb_tpu_torch.blob import blob_field
    from lancedb_tpu_torch.embeddings import EmbeddingDefinition

    rng = np.random.default_rng(4)
    sizes = rng.integers(TS_BLOB_SIZES[0], TS_BLOB_SIZES[1] + 1, TS_BLOB_ROWS)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    buf = rng.bytes(int(offs[-1]))
    payloads = [buf[offs[i]:offs[i + 1]] for i in range(TS_BLOB_ROWS)]
    captions = make_corpus(np.random.default_rng(6), TS_BLOB_ROWS)
    schema = pa.schema([pa.field("id", pa.int64()), pa.field("caption", pa.string()),
                        blob_field("thumb")])
    data = pa.table({"id": np.arange(TS_BLOB_ROWS), "caption": captions,
                     "thumb": pa.array(payloads, pa.large_binary())}, schema=schema)
    rec: dict = {"rows": TS_BLOB_ROWS, "payload_bytes": int(offs[-1])}
    t0 = time.perf_counter()
    tbl = db.create_table("thumbs", data, embedding_functions=[EmbeddingDefinition(
        source_column="caption", vector_column="vector", function_name="hash")])
    rec["create_s"] = time.perf_counter() - t0
    del data, buf
    t0 = time.perf_counter()
    hits = [tbl.search(captions[i], query_type="vector").limit(10).select(["id"])
            .with_row_id(True).to_arrow() for i in range(TS_BLOB_QUERIES)]
    torch.cuda.synchronize()
    rec["search_ms_per_query"] = (time.perf_counter() - t0) / TS_BLOB_QUERIES * 1e3
    hit_ids = np.concatenate([np.asarray(h["id"]) for h in hits])
    rowids = np.concatenate([np.asarray(h["_rowid"]) for h in hits]).tolist()
    for i, h in enumerate(hits):
        if abs(float(h["_distance"][0].as_py())) > TS_ZERO:
            raise AssertionError(f"path j blobs: caption {i}'s top hit is not at distance 0")
    want = [payloads[i] for i in hit_ids]
    t0 = time.perf_counter()
    got = tbl.fetch_blobs("thumb", rowids)
    rec["fetch_blobs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    files = tbl.fetch_blob_files("thumb", rowids)
    whole = [f.read() for f in files]
    seeked = []
    for f in files:
        f.seek(len(f) // 2)
        seeked.append(f.read(100))
    rec["fetch_blob_files_s"] = time.perf_counter() - t0
    ranges = [(len(p) // 3, len(p) // 4) for p in want]
    t0 = time.perf_counter()
    parts = tbl.fetch_blob_ranges("thumb", rowids, ranges)
    rec["fetch_blob_ranges_s"] = time.perf_counter() - t0
    rec["fetched_bytes"] = sum(len(p) for p in want)
    if got != want or whole != want:
        raise AssertionError("path j blobs: fetched payloads differ from the script's")
    if seeked != [p[len(p) // 2: len(p) // 2 + 100] for p in want]:
        raise AssertionError("path j blobs: a seek then read differs from the payload")
    if parts != [p[a: a + n] for p, (a, n) in zip(want, ranges)]:
        raise AssertionError("path j blobs: a range differs from the payload")
    print(f"[table_surface] blobs ({card}): {json.dumps(rec)}", flush=True)
    return rec


def table_surface_path(db, card: str) -> tuple[dict, dict]:
    """Path j: the table's ingest surface at the bench's FTS scale. A
    LanceModel (id, text embedded by "hash" into a 256-d vector, category
    = id % 10) over 1,000,000 make_corpus docs added in 100,000-row batches
    (the host embedding timed apart from the write); IVF_PQ 1024 x 32
    8-bit sub-vectors and an FTS index on text; 256 text searches raw,
    refined and filtered (each equal to search(v), recall against exact f32
    truth on the card), the one-string hybrid, to_pydantic, the LSM write
    path and blobs. Returns (summary, B1's record at the text searches'
    shapes)."""
    import torch

    from lancedb_tpu_torch.embeddings import get_registry
    from lancedb_tpu_torch.index import IvfPq
    from lancedb_tpu_torch.pydantic import LanceModel, Vector

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off for exact f32"
    k = 10
    fn = get_registry().get("hash").create()

    class Doc(LanceModel):
        id: int
        text: str = fn.SourceField()
        vector: Vector(fn.ndims()) = fn.VectorField()
        category: int

    rec: dict = {"card": card, "docs": TS_DOCS, "dim": fn.ndims()}
    t0 = time.perf_counter()
    docs = make_corpus(np.random.default_rng(0), TS_DOCS)
    rec["corpus_s"] = time.perf_counter() - t0
    tbl = db.create_table("docs", schema=Doc)
    embedder = tbl.embedding_functions["vector"]
    embed_s = [0.0]
    compute = embedder.compute_source_embeddings

    def timed_compute(texts):  # the host embedding, timed apart from the write
        t = time.perf_counter()
        out = compute(texts)
        embed_s[0] += time.perf_counter() - t
        return out

    embedder.compute_source_embeddings = timed_compute
    t0 = time.perf_counter()
    for s in range(0, TS_DOCS, TS_BATCH):
        ids = np.arange(s, min(s + TS_BATCH, TS_DOCS))
        tbl.add(ts_rows(ids, docs[s: s + TS_BATCH]))
    rec["add_s"] = time.perf_counter() - t0
    rec["embed_s"] = embed_s[0]
    rec["write_s"] = rec["add_s"] - embed_s[0]
    embedder.compute_source_embeddings = compute
    print(f"[table_surface] corpus {rec['corpus_s']:.3f} s, add {rec['add_s']:.3f} s "
          f"(embedding {rec['embed_s']:.3f} s on the host) ({card})", flush=True)

    x = tbl.to_arrow().column("vector").combine_chunks().values.to_numpy().reshape(TS_DOCS, -1)
    x_d = torch.from_numpy(x.copy()).cuda()
    queries = make_corpus(np.random.default_rng(1), TS_QUERIES)
    qv = np.stack([fn.compute_query_embeddings(s)[0] for s in queries])
    xn2_d = torch.sum(x_d * x_d, dim=1)
    mask_d = torch.from_numpy(np.arange(TS_DOCS) % 10 == 3).cuda()
    gt, kth = exact_topk_kth(x_d, xn2_d, qv, k)
    gt_f, kth_f = exact_topk_kth(x_d, xn2_d, qv, k, mask_d)
    del x_d, xn2_d, mask_d
    torch.cuda.empty_cache()

    # the bars come from the reference's CPU build, which multiplies in f32
    # (the card's default is the bf16 of the reference's TPU build)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tbl.create_index(config=IvfPq(num_partitions=TS_PARTITIONS, num_sub_vectors=TS_SUBVECTORS,
                                  num_bits=8, build_precision="float32"))
    torch.cuda.synchronize()
    rec["ivf_pq_build_s"] = time.perf_counter() - t0
    rec["build_peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    tbl.create_fts_index("text", with_position=False)
    rec["fts_build_s"] = time.perf_counter() - t0
    print(f"[table_surface] IVF_PQ build {rec['ivf_pq_build_s']:.3f} s (peak "
          f"{rec['build_peak_mem_bytes']} bytes), FTS build {rec['fts_build_s']:.3f} s "
          f"({card})", flush=True)

    rec["text_search"], hits = ts_text_searches(tbl, fn, queries, k, card)
    for mode, truth, kk in (("raw", gt, kth), ("refined", gt, kth), ("filtered", gt_f, kth_f)):
        rec["text_search"][mode]["recall@10_ids"] = recall(hits[mode], truth)
        rec["text_search"][mode]["recall@10"] = tie_recall(hits[mode], qv, x, kk)
    del x
    print(f"[table_surface] recall@10, ties counted (by ids) ({card}): " + json.dumps(
        {m: (rec["text_search"][m]["recall@10"], rec["text_search"][m]["recall@10_ids"])
         for m in hits}), flush=True)
    for mode, bar in TS_BARS.items():
        if rec["text_search"][mode]["recall@10"] < bar:
            raise AssertionError(f"path j {mode} recall {rec['text_search'][mode]['recall@10']} "
                                 f"< {bar}")
    rec["hybrid"] = ts_hybrid(tbl, fn, queries[:TS_HYBRID], k, card)
    got = tbl.search(queries[0], query_type="vector").nprobes(TS_NPROBES).limit(1).to_pydantic(Doc)
    if not (isinstance(got[0], Doc) and got[0].id == hits["raw"][0, 0]
            and len(got[0].vector) == fn.ndims()):
        raise AssertionError(f"path j to_pydantic: {got}")
    searcher = next(tbl._get_searcher(ix) for ix in tbl._dataset.manifest.indices
                    if ix.index_type == "IVF_PQ")
    krec = check_adc(searcher_adc_args(searcher, qv), "path j text-search shapes")
    krec["launches"] = sum(rec["text_search"][m]["b1_launches"] for m in hits) + \
        rec["hybrid"]["single_launches_b1"] + rec["hybrid"]["batched_launches_b1"]
    del searcher
    rec["lsm"] = ts_lsm(tbl, fn, k, card)
    krec["launches"] += (rec["lsm"]["delta_merge"]["b1_launches"]
                         + rec["lsm"]["after_optimize"]["b1_launches"])
    rec["blobs"] = ts_blobs(db, card)
    return rec, krec


def table_surface_phase(card: str) -> tuple[dict, list[dict]]:
    """Path j on a database of its own."""
    import lancedb_tpu_torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ts_") as tmp:
        results, krec = table_surface_path(lancedb_tpu_torch.connect(tmp), card)
    print(f"card: {card}", flush=True)
    return results, [krec]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "large_d", "hnsw", "fts", "vector_family",
                             "lifecycle", "mesh", "table_surface"),
                    default="all", help="kernels: the kernel checks only; large_d, hnsw, fts, "
                    "vector_family, lifecycle, mesh, table_surface: that path only")
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
    if a.phase in ("large_d", "hnsw", "fts", "vector_family", "lifecycle", "mesh",
                   "table_surface"):
        if a.phase == "large_d":
            summary["large_d"], kernels = large_d_path(card)
        elif a.phase == "mesh":
            summary["mesh"], kernels = mesh_phase(card)
        elif a.phase == "lifecycle":
            summary["lifecycle"], kernels = lifecycle_phase(card)
        elif a.phase == "table_surface":
            summary["table_surface"], kernels = table_surface_phase(card)
        elif a.phase == "fts":
            summary["fts"], kernels = fts_phase(card)
        elif a.phase == "vector_family":
            summary["vector_family"], kernels = vector_family_only(card)
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
