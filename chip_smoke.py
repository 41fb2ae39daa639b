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
  3. main path, at SIFT1M scale: connect() on the default device →
     create_table with 1,000,000 rows of 128-d clustered vectors (seed 0)
     plus id and category = id % 10 → create_index(IVF_PQ, 1024
     partitions) → search 256 queries at nprobes 20, raw and with
     refine_factor 10, then again with where("category < 5"); first for
     8-bit x16 codes, then 4-bit x32. Ground truth is exact f32 on the
     card. After each index the kernel is also checked and timed on the
     inputs the searcher gives it for the first 128 queries, and one
     batch's time is broken down by layer (searcher, prefilter, slot
     penalty, device busy time under torch.profiler).

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
# the reference's recall@10 at 1M x 128, 1024 partitions, nprobes 20
# (bench_details.json ivf_pq_8bit_np20 / ivf_pq_4bit_np20)
RAW_RECALL_BARS = {8: 0.7656, 4: 0.7375}


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


def check_adc(args, label: str) -> dict:
    """Hold the CUDA ADC kernel against the plain version on ``args``,
    time both, and compute the bound. Raises on disagreement."""
    import torch

    from lancedb_tpu_torch.ops import adc

    probe_ids, dlut, codes, rnorms, qc, qn2 = args
    saved = dict(adc.launch_counts)  # comparison launches do not count
    got = adc.ivf_pq_adc_scan(*args)
    want = adc.ivf_pq_adc_scan_reference(*args)
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        searcher.search(queries, raw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kern = {}
    for e in prof.key_averages():  # device-side events only: kernels, copies, fills
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kern[e.key] = kern.get(e.key, 0.0) + e.device_time_total
    busy_us = sum(kern.values())
    out["profiled_searcher_raw"] = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in
                           sorted(kern.items(), key=lambda kv: -kv[1])[:6]},
    }
    return out


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
    summary: dict = {"synthetic_kernels": synthetic}
    kernels = synthetic
    if a.phase == "all":
        results, kernels = main_path(card)
        summary["main_path"] = results
    summary["seconds"] = time.perf_counter() - t_start
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(summary, indent=1))
    print(f"card: {card}", flush=True)
    print('kernels: ["B1 ivf_pq_adc_scan"]', flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
