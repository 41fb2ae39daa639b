"""The one-card capacity point: 30,000,000 x 128 rows built into IVF_PQ
and searched through the table API, the port of the reference's
scripts/probe_scale_30m.py.

    python -m lancedb_tpu_torch.probes.probe_scale_30m [--n N] [--workdir DIR]

The script's data, drawn exactly as it draws them: 10,000 centres from
``default_rng(0)`` scaled by 2.0, chunk ``s`` of CH rows from
``default_rng(1000 + s // CH)`` (centre ids, then unit normal noise), the
32 query rows from ``default_rng(7)`` plus 0.05 x ``default_rng(8)``
noise. Each chunk is generated, appended (``create_table`` from the
first, ``tbl.add`` of the rest) and fed to the exact f32 ground truth on
the device (TF32 off), then dropped: the host holds one chunk. Then
``create_index(IvfPq(4096, 16 x 8-bit, l2))`` (256 partitions below
8,000,000 rows, the script's smoke branch), which at 30M x 128 takes the
build's residual-free capacity mode, and ``search(Q).nprobes(20)`` raw
and with ``refine_factor(10)``, the refine through the fused f16 table on
the device once ``LANCEDB_TPU_DEVICE_REFINE_BUDGET`` admits it (set here
with ``setdefault``, as the script sets it).

It prints and returns one record: data, append and build seconds, the
build's mode, blocks and pmax, its peak device memory, the device memory
with the index resident and with the refine table, the host's peak
anonymous memory (``common.HostAnonPeak``, sampled every 0.2 s) and peak
RSS (which also counts the table's memory-mapped fragments), and
recall@10, qps and B1's launches raw and refined, through the table API
(``to_arrow()``, hydration included) and through
``VectorSearcher.search`` alone, each a median of REPS host-clock times
after one warm call. It never writes the reference's SCALE_PROOF.json.

Standalone it works under ``.bench_cache/`` with the script's DONE-marker
resume (a killed run does not generate the 15.4 GB table again); at 30M
rows it needs about 17 GB of disk (checked before generating); the build
and the refine table stream the column a block at a time, so the host
never holds it whole. Like every entry point of the port it runs on the
card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import torch

N, D, NSUB, NBITS = 30_000_000, 128, 16, 8
NPROBES, NQ, TOP_K, REFINE = 20, 32, 10, 10
CH = 1_000_000  # rows a chunk: generated, appended and scanned for the truth at once
N_CENTRES = 10_000
REPS = 8  # timed calls of each search, after one warm call
HOST_ANON_BAR = 24_000_000_000  # anonymous bytes: a quarter of the card machine's 101 GB
INDEX_NAME = "scale_pq"
REPO = Path(__file__).resolve().parents[2]


def num_partitions(n: int) -> int:
    """The script's partitions: 4096, or 256 below 8,000,000 rows."""
    return 4096 if n >= 8_000_000 else 256


def centres() -> np.ndarray:
    return (np.random.default_rng(0).standard_normal((N_CENTRES, D)) * 2.0).astype(np.float32)


def chunk_rows(cents: np.ndarray, s: int, n: int, ch: int) -> np.ndarray:
    """Rows s .. min(s + ch, n) as the script draws them."""
    e = min(s + ch, n)
    crng = np.random.default_rng(1000 + s // ch)
    a = crng.integers(0, N_CENTRES, e - s)
    return cents[a] + crng.standard_normal((e - s, D), dtype=np.float32)


def queries(cents: np.ndarray, n: int, ch: int) -> np.ndarray:
    """The script's 32 queries: rows of ``default_rng(7).integers(0, n,
    32)`` plus 0.05 x ``default_rng(8)`` noise. A chunk's noise is drawn
    in row order, so a query row needs only the prefix of its chunk's
    noise up to it, not the whole chunk."""
    qi = np.random.default_rng(7).integers(0, n, NQ)
    q = np.empty((NQ, D), np.float32)
    for s in sorted({int(r) // ch * ch for r in qi}):
        e = min(s + ch, n)
        crng = np.random.default_rng(1000 + s // ch)
        a = crng.integers(0, N_CENTRES, e - s)
        mine = [j for j in range(NQ) if s <= qi[j] < e]
        noise = crng.standard_normal((max(int(qi[j]) for j in mine) - s + 1, D),
                                     dtype=np.float32)
        for j in mine:
            r = int(qi[j]) - s
            q[j] = cents[a[r]] + noise[r]
    q += 0.05 * np.random.default_rng(8).standard_normal((NQ, D)).astype(np.float32)
    return q


class ExactTopK:
    """Exact f32 top-k l2 ids of the queries over rows fed a chunk at a
    time on ``device`` (TF32 off on the card)."""

    def __init__(self, q: np.ndarray, device: torch.device, k: int = TOP_K):
        self.q = torch.from_numpy(q).to(device)
        self.qn2 = torch.sum(self.q * self.q, dim=1, keepdim=True)
        self.k = k
        self.best_v = self.best_i = None

    def add(self, rows: np.ndarray, offset: int) -> None:
        x = torch.from_numpy(rows).to(self.q.device)
        d = self.qn2 - 2.0 * (self.q @ x.T) + torch.sum(x * x, dim=1)[None, :]
        v, i = torch.topk(d, min(self.k, d.shape[1]), dim=1, largest=False)
        i = i + offset
        if self.best_v is not None:
            v, pos = torch.topk(torch.cat([self.best_v, v], 1), self.k, dim=1, largest=False)
            i = torch.gather(torch.cat([self.best_i, i], 1), 1, pos)
        self.best_v, self.best_i = v, i

    def ids(self) -> np.ndarray:
        return self.best_i.cpu().numpy()


def disk_needed(n: int) -> int:
    """Bytes the table (vector and id) and its index take: about 17 GB at 30M."""
    index = int(n * (NSUB + 4 + 8) * 1.25)  # codes, rnorms, row ids; blocks padded
    return n * (D * 4 + 8) + index


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_table(db, n: int, ch: int, workdir: Path, device: torch.device) -> dict:
    """Generate, append and scan the rows a chunk at a time; writes
    queries.npy, gt.npy and data.json, then the DATA_DONE marker."""
    free = shutil.disk_usage(workdir).free
    if free < disk_needed(n):
        raise RuntimeError(f"{n} x {D} rows need about {disk_needed(n):,} bytes of disk "
                           f"under {workdir}; {free:,} are free")
    times = {"data_s": 0.0, "append_s": 0.0, "gt_s": 0.0}
    t0 = time.perf_counter()
    cents = centres()
    q = queries(cents, n, ch)
    times["data_s"] += time.perf_counter() - t0
    truth = ExactTopK(q, device)
    tbl = None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, n, ch):
            t0 = time.perf_counter()
            rows = chunk_rows(cents, s, n, ch)
            part = pa.table({
                "id": pa.array(np.arange(s, s + rows.shape[0], dtype=np.int64)),
                "vector": pa.FixedSizeListArray.from_arrays(pa.array(rows.reshape(-1)), D),
            })
            t1 = time.perf_counter()
            if tbl is None:
                tbl = db.create_table("data", part, mode="overwrite")
            else:
                tbl.add(part)
            t2 = time.perf_counter()
            truth.add(rows, s)
            _sync(device)
            t3 = time.perf_counter()
            times["data_s"] += t1 - t0
            times["append_s"] += t2 - t1
            times["gt_s"] += t3 - t2
            if (s // ch) % 5 == 0:
                print(f"[scale] rows {s + rows.shape[0]:,} / {n:,}: {json.dumps(times)}",
                      flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.save(workdir / "queries.npy", q)
    np.save(workdir / "gt.npy", truth.ids())
    (workdir / "data.json").write_text(json.dumps(times))
    (workdir / "DATA_DONE").write_text("ok")
    return times


def build_index(tbl, n: int, device: torch.device, workdir: Path) -> dict:
    """create_index(IVF_PQ) with the build's peak device memory; writes
    build.json."""
    from ..index import IvfPq

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tbl.create_index(config=IvfPq(num_partitions=num_partitions(n), num_sub_vectors=NSUB,
                                  num_bits=NBITS, distance_type="l2"), name=INDEX_NAME)
    _sync(device)
    rec = {"build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else None}
    (workdir / "build.json").write_text(json.dumps(rec))
    return rec


def hit_ids(out: pa.Table) -> np.ndarray:
    """A batch's result table → ids (NQ, TOP_K), -1 where a query has fewer hits."""
    qi = np.asarray(out.column("query_index"))
    ids = np.asarray(out.column("id"))
    hits = np.full((NQ, TOP_K), -1, np.int64)
    for j in range(NQ):
        h = ids[qi == j][:TOP_K]
        hits[j, : len(h)] = h
    return hits


def rowids_to_ids(ds, rids: np.ndarray) -> np.ndarray:
    """The searcher's row addresses → the table's ``id`` column (-1 for none)."""
    valid = rids != np.uint64(np.iinfo(np.uint64).max)
    uniq, inv = np.unique(rids[valid], return_inverse=True)
    ids = np.asarray(ds.take_rows(uniq, columns=["id"]).column("id"))
    out = np.full(rids.shape, -1, np.int64)
    out[valid] = ids[inv]
    return out


def recall(hits: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / TOP_K
                          for a, b in zip(hits, gt)]))


def timed(fn, device: torch.device) -> tuple[object, dict]:
    """One warm call, then REPS calls, each on the host clock after a
    synchronize with B1's launches counted from 0 around it → (the last
    result, {"ms", "qps", "b1_launches"}); ``ms`` is the median."""
    from ..ops import adc

    fn()
    _sync(device)
    times, launches = [], []
    for _ in range(REPS):
        adc.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
        launches.append(adc.launch_counts["ivf_pq_adc_scan"])
    ms = float(np.median(times)) * 1e3
    return res, {"ms": ms, "qps": NQ / (ms / 1e3), "b1_launches": launches}


def searches(tbl, q: np.ndarray, gt: np.ndarray, device: torch.device) -> dict:
    """Raw, then refined: through to_arrow() and through the searcher alone."""
    from ..index.vector import SearchParams

    meta = next(ix for ix in tbl._dataset.manifest.indices if ix.name == INDEX_NAME)
    rec: dict = {}

    def table_search(rf):
        s = tbl.search(q).nprobes(NPROBES).limit(TOP_K).select(["id"])
        return (s if rf is None else s.refine_factor(rf)).to_arrow()

    for tag, rf in (("raw", None), ("refine10", REFINE)):
        if rf is not None:
            # the script's budget: the f16 table (N x D x 2 bytes) on the device
            os.environ.setdefault("LANCEDB_TPU_DEVICE_REFINE_BUDGET",
                                  str(int(tbl.count_rows() * D * 2 + 2**30)))
            t0 = time.perf_counter()
            table_search(rf)  # the first refined call uploads the refine table
            _sync(device)
            rec["refine_first_call_s"] = time.perf_counter() - t0
        sp = tbl._get_searcher(meta)
        if rf is None:
            rec["blocks"], rec["pmax"] = sp.nparts, sp.pmax
            rec["block_nprobes"] = sp._block_nprobes(NPROBES)
        else:
            vecs = sp._device.get("refine_vecs")
            rec["refine_mode"] = ("host" if vecs is None else
                                  f"fused_device_{str(vecs.dtype).removeprefix('torch.')}")
        if device.type == "cuda":
            rec[f"memory_allocated_{tag}"] = torch.cuda.memory_allocated(device)
        out, stats = timed(lambda rf=rf: table_search(rf), device)
        rec[f"table_{tag}"] = {"recall@10": recall(hit_ids(out), gt), **stats}
        params = SearchParams(k=TOP_K, nprobes=NPROBES, refine_factor=rf)
        (_, rids), stats = timed(lambda params=params: sp.search(q, params), device)
        rec[f"searcher_{tag}"] = {
            "recall@10": recall(rowids_to_ids(tbl._dataset, rids), gt), **stats}
    return rec


def default_workdir(n: int) -> Path:
    return REPO / ".bench_cache" / f"scale{n}-torch-v1"


def run(n: int = N, ch: int = CH, device=None, workdir=None) -> dict:
    """The whole probe in ``workdir`` (default ``default_workdir(n)``),
    resuming from its DONE markers → the record."""
    import lancedb_tpu_torch

    from ..ops.util import resolve_device
    from .common import HostAnonPeak

    dev = resolve_device(device)
    workdir = Path(workdir) if workdir is not None else default_workdir(n)
    workdir.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    db = lancedb_tpu_torch.connect(str(workdir / "db"), device=dev)
    rec: dict = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                 "n": n, "d": D, "npart": num_partitions(n), "nsub": NSUB, "nbits": NBITS,
                 "nprobes": NPROBES, "nq": NQ, "chunk_rows": ch}
    with HostAnonPeak() as anon:
        if (workdir / "DATA_DONE").exists():
            tbl = db.open_table("data")
            rec.update(json.loads((workdir / "data.json").read_text()), data_cached=True)
        else:
            rec.update(make_table(db, n, ch, workdir, dev))
            tbl = db.open_table("data")
        q, gt = np.load(workdir / "queries.npy"), np.load(workdir / "gt.npy")
        if any(ix.name == INDEX_NAME for ix in tbl._dataset.manifest.indices):
            rec.update(json.loads((workdir / "build.json").read_text()), index_cached=True)
        else:
            rec.update(build_index(tbl, n, dev, workdir))
        meta = next(ix for ix in tbl._dataset.manifest.indices if ix.name == INDEX_NAME)
        ds = tbl._dataset
        rec["build_mode"] = json.loads(
            ds.store.read_bytes(f"{ds.index_dir(meta.uuid)}/meta.json"))["build_mode"]
        rec.update(searches(tbl, q, gt, dev))
    # the anonymous peak counts the copies the process made; VmRSS and
    # ru_maxrss also the table's memory-mapped fragments it read
    rec["host_anon_peak_bytes"] = anon.peak_bytes
    rec["host_anon_source"], rec["host_vmrss_peak_bytes"] = anon.source, anon.rss_peak_bytes
    rec["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec["seconds"] = time.perf_counter() - t_start
    print(f"[probe_scale_30m] {json.dumps(rec)}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="rows (the script's 30,000,000)")
    ap.add_argument("--ch", type=int, default=CH, help="rows a chunk")
    ap.add_argument("--workdir", help="the database and the caches (default: under "
                    ".bench_cache/, resumed from its DONE markers)")
    ap.add_argument("--device", help="cuda (the default) or cpu")
    a = ap.parse_args()
    run(a.n, a.ch, a.device, a.workdir)
    if torch.cuda.is_available() and a.device in (None, "cuda"):
        from .common import card_line

        print(f"card (nvidia-smi name, power.limit): {card_line()}", flush=True)


if __name__ == "__main__":
    main()
