"""BASELINE config #5 at its published scale: 100,000,000 x 96 rows
(Deep1B's widths, big-ann-benchmarks' 100M subset) built into IVF_PQ
(4096 partitions, 8-bit x12) and served through the table API on one
device, then over a 4-shard mesh of that device.

    python -m lancedb_tpu_torch.probes.probe_deep100m [--n N] [--ch CH]
        [--workdir DIR] [--device cpu]

The DEEP files are not in the repository, so seeded clustered rows take
their place, at DEEP's width. ``make_clustered``'s hierarchy comes from
``default_rng(0)`` as it draws it (``common.clustered_hierarchy``: the
spectrum, 4096 coarse centres, 65,536 parents at 0.45), and the 256
queries are its next draws (``common.clustered_rows``: parents, 0.18 x
normal noise, the spectrum), drawn before any row rather than after all
of them. Chunk ``c`` of CH rows draws its parent ids, then its noise, from
a ``torch.Generator`` on the device seeded ``1000 + c``, at the same
scales: 100M rows drawn on the host would take about 565 s. On the CPU
the same function draws from a CPU generator (other bits, same law).
``id`` is the row's index and ``category = id % 10``.

Each chunk is drawn on the device, fed to three exact f32 top-10 truths
there (TF32 off: all rows, ``category = 3``, ``id % 1000 != 0``), copied
off the device once and appended (``create_table`` from chunk 0,
``tbl.add`` of the rest): the host holds one chunk. Then
``create_index(IvfPq(4096, 12 x 8-bit))``, which at 100M x 96 takes the
residual-free build mode, and 256-query batches at nprobes 20, each the
median of REPS host-clock times after one warm call with B1's launches
counted from 0: raw, ``refine_factor(10)`` through the fused f16 table
(``LANCEDB_TPU_DEVICE_REFINE_BUDGET`` set with ``setdefault`` to admit
it, as path n's probe does) and ``where("category = 3")``; then the same
table through ``enable_sharded_serving`` on ``[device] * 4``, beside the
one-device searcher and its refine table: raw, refined (the sharded f16
table) and filtered, then ``disable_sharded_serving()``; then
``delete("id % 1000 = 0")`` and raw again on one device.

The bars raise: the residual-free build, the fused f16 refine on one
device and on the mesh, each refined recall at or above its raw, the
mesh's recall at or above one device's less 0.01 on the same table,
every filtered hit in category 3, no deleted id after the deletion, and
the host's anonymous memory at most HOST_ANON_BAR; on the card also B1
launched by every search, 4x one device's launches on the mesh, and
device memory back within one searcher (its index, without the refine
table) after ``disable_sharded_serving()``. It prints and
returns one record: every stage's seconds, the device peaks, the host's
anonymous-memory peak (``common.HostAnonPeak``: ``RssAnon``, or
``VmData`` where the kernel reports no ``RssAnon``; ``VmRSS`` and
``ru_maxrss`` beside it count the table's memory-mapped fragments), each
search's recall, ms and launches, and the probe coverage
(the share of each query's exact top-10 that lies in its probed blocks:
the ceiling of any answer at nprobes 20).

At 100M rows it needs about 45 GB of disk under the work directory (it
checks for DISK_BYTES free) and about 60 GB of device memory. Like every
entry point of the port it runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import torch

N, D, NPART, NSUB, NBITS = 100_000_000, 96, 4096, 12, 8
NPROBES, NQ, TOP_K, REFINE = 20, 256, 10, 10
CH = 1_000_000  # rows a chunk: drawn, fed to the truths and appended at once
SHARDS = 4
REPS = 3  # timed calls of each search, after one warm call
DISK_BYTES = 50_000_000_000  # at N: the 38.4 GB table, the index and the deletions
HOST_ANON_BAR = 24_000_000_000  # a quarter of the card machine's 101 GB
FILTER, DELETE = "category = 3", "id % 1000 = 0"


def num_partitions(n: int) -> int:
    """The config's 4096 partitions; 64 below 8,000,000 rows (small runs)."""
    return NPART if n >= 8_000_000 else 64


def hierarchy() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(spectrum, parents, the NQ queries): make_clustered's draws from
    ``default_rng(0)`` at D, the queries right after the parents."""
    from .common import clustered_hierarchy, clustered_rows

    rng = np.random.default_rng(0)
    spectrum, parents = clustered_hierarchy(rng, D)
    q = clustered_rows(rng, spectrum, parents, NQ).astype(np.float32)
    return spectrum, parents, q


def chunk_rows(spectrum_d: torch.Tensor, parents_d: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """Chunk ``c``'s m rows on the parents' device: parent ids, then
    noise, from a generator seeded 1000 + c there."""
    g = torch.Generator(device=parents_d.device)
    g.manual_seed(1000 + c)
    p = torch.randint(0, parents_d.shape[0], (m,), generator=g, device=parents_d.device)
    noise = torch.randn((m, D), generator=g, device=parents_d.device)
    return (parents_d[p] + 0.18 * noise) * spectrum_d


class RunningTopK:
    """Exact f32 top-k l2 ids of the queries over rows fed a chunk at a
    time, optionally over a row mask (TF32 off on the card)."""

    def __init__(self, q: torch.Tensor, k: int = TOP_K):
        self.q, self.k = q, k
        self.best_v = self.best_i = None

    def add(self, x: torch.Tensor, xn2: torch.Tensor, offset: int, mask=None) -> None:
        d = xn2[None, :] - 2.0 * (self.q @ x.T)
        if mask is not None:
            d = torch.where(mask[None, :], d, float("inf"))
        v, i = torch.topk(d, min(self.k, d.shape[1]), dim=1, largest=False)
        i = i + offset
        if self.best_v is not None:
            v, pos = torch.topk(torch.cat([self.best_v, v], 1), self.k, dim=1, largest=False)
            i = torch.gather(torch.cat([self.best_i, i], 1), 1, pos)
        self.best_v, self.best_i = v, i

    def ids(self) -> np.ndarray:
        return self.best_i.cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_table(db, n: int, ch: int, device: torch.device) -> tuple[object, np.ndarray, dict, dict]:
    """Draw, feed the truths and append a chunk at a time → (table,
    queries, {truth name: (NQ, TOP_K) ids}, seconds by stage)."""
    secs = {"data_s": 0.0, "truth_s": 0.0, "append_s": 0.0}
    t0 = time.perf_counter()
    spectrum, parents, q = hierarchy()
    spectrum_d = torch.from_numpy(spectrum).to(device)
    parents_d = torch.from_numpy(parents).to(device)
    secs["data_s"] += time.perf_counter() - t0
    qd = torch.from_numpy(q).to(device)
    truths = {"raw": RunningTopK(qd), "filtered": RunningTopK(qd),
              "after_delete": RunningTopK(qd)}
    tbl = None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c, s in enumerate(range(0, n, ch)):
            m = min(ch, n - s)
            t0 = time.perf_counter()
            x = chunk_rows(spectrum_d, parents_d, c, m)
            _sync(device)
            t1 = time.perf_counter()
            ids_d = torch.arange(s, s + m, device=device)
            xn2 = torch.sum(x * x, dim=1)
            truths["raw"].add(x, xn2, s)
            truths["filtered"].add(x, xn2, s, ids_d % 10 == 3)
            truths["after_delete"].add(x, xn2, s, ids_d % 1000 != 0)
            _sync(device)
            t2 = time.perf_counter()
            rows = x.cpu().numpy()  # the chunk's one copy off the device
            del x, xn2, ids_d
            ids = np.arange(s, s + m, dtype=np.int64)
            part = pa.table({
                "id": ids, "category": ids % 10,
                "vector": pa.FixedSizeListArray.from_arrays(pa.array(rows.reshape(-1)), D),
            })
            if tbl is None:
                tbl = db.create_table("deep", part, mode="overwrite")
            else:
                tbl.add(part)
            del part, rows
            t3 = time.perf_counter()
            secs["data_s"] += t1 - t0
            secs["truth_s"] += t2 - t1
            secs["append_s"] += t3 - t2
            if c % 10 == 0:
                print(f"[deep100m] rows {s + m:,} / {n:,}: {json.dumps(secs)}", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return tbl, q, {k: t.ids() for k, t in truths.items()}, secs


def batch_hits(out: pa.Table) -> tuple[np.ndarray, np.ndarray]:
    """A batch's result table → (ids (NQ, TOP_K), -1 where a query has
    fewer hits; the categories of every hit)."""
    qi = np.asarray(out.column("query_index"))
    ids = np.asarray(out.column("id"))
    hits = np.full((NQ, TOP_K), -1, np.int64)
    for j in range(NQ):
        h = ids[qi == j][:TOP_K]
        hits[j, : len(h)] = h
    return hits, np.asarray(out.column("category"))


def recall(hits: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / TOP_K
                          for a, b in zip(hits, gt)]))


def searches(tbl, q: np.ndarray, cases, truths: dict, device: torch.device) -> dict:
    """Each case (name, truth, refine_factor, where): one warm call (which
    loads the searcher and any refine table), then REPS calls, each on the
    host clock after a synchronize, with B1's count set to 0 before the
    warm call and read after the last; recall@10 of the last result."""
    from ..ops import adc

    out = {}
    for name, truth, rf, where in cases:
        def call():
            s = tbl.search(q).nprobes(NPROBES).limit(TOP_K).select(["id", "category"])
            if rf is not None:
                s = s.refine_factor(rf)
            if where is not None:
                s = s.where(where)
            t0 = time.perf_counter()
            res = s.to_arrow()
            _sync(device)
            return res, time.perf_counter() - t0

        adc.reset_launch_counts()
        _, first_s = call()
        reps = [call() for _ in range(REPS)]
        hits, cats = batch_hits(reps[-1][0])
        out[name] = {"recall@10": recall(hits, truths[truth]), "first_call_s": first_s,
                     "ms": float(np.median([r[1] for r in reps])) * 1e3,
                     "b1_launches": adc.launch_counts["ivf_pq_adc_scan"],
                     "calls": 1 + REPS, "ids": hits, "categories": cats}
        print(f"[deep100m] {name}: " + json.dumps(
            {k: v for k, v in out[name].items() if k not in ("ids", "categories")}), flush=True)
    return out


def probe_coverage(searcher, q: np.ndarray, gt_ids: np.ndarray, ds) -> float:
    """The share of each query's exact top-10 whose rows lie in the
    blocks the one-device searcher probes for it at NPROBES."""
    from ..index.vector import _select_probes

    dev = searcher.device
    want = np.unique(gt_ids)
    rid_of = {}
    for _, t in ds.scan_fragments(columns=["id"], with_row_id=True):
        col = t.column("id").to_numpy()
        hit = np.isin(col, want)
        rid_of.update(zip(col[hit].tolist(), t.column("_rowid").to_numpy()[hit].tolist()))
    truth_rid = torch.from_numpy(
        np.vectorize(rid_of.__getitem__, otypes=[np.uint64])(gt_ids).view(np.int64)).to(dev)
    slot_rid = torch.from_numpy(np.array(searcher.row_ids_flat.view(np.int64))).to(dev)
    slots = torch.nonzero(torch.isin(slot_rid, truth_rid)).squeeze(1)
    order = torch.argsort(slot_rid[slots])
    at = torch.searchsorted(slot_rid[slots][order], truth_rid.reshape(-1))
    block = (slots[order][at] // searcher.pmax).reshape(truth_rid.shape)
    qd = torch.from_numpy(q).to(dev)
    probe_ids, _ = _select_probes(qd, searcher._device["centroids"],
                                  searcher._block_nprobes(NPROBES), searcher.metric)
    covered = (probe_ids[:, :, None] == block[:, None, :]).any(dim=1)
    return float(covered.float().mean())


def _mem(device: torch.device):
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else None


def check(rec: dict, device: torch.device) -> None:
    """The bars; raises AssertionError on the first it misses."""
    one, mesh = rec["single"], rec["mesh4"]
    if rec["build_mode"] != "res_free":
        raise AssertionError(f"build mode {rec['build_mode']}, not res_free")
    for label, mode in (("one device", rec["refine_mode"]), ("mesh", rec["mesh_refine_mode"])):
        if mode != "fused_device_float16":
            raise AssertionError(f"{label}: refine {mode}, not the fused f16 table")
    for level in (one, mesh):
        if level["refined"]["recall@10"] < level["raw"]["recall@10"]:
            raise AssertionError(f"refined recall below raw: {public(level)}")
    for name in ("raw", "refined", "filtered"):
        if mesh[name]["recall@10"] < one[name]["recall@10"] - 0.01:
            raise AssertionError(f"mesh {name}: recall {mesh[name]['recall@10']} < "
                                 f"{one[name]['recall@10']} - 0.01")
    for label, level in (("one device", one), ("mesh", mesh)):
        if not np.all(level["filtered"]["categories"] == 3):
            raise AssertionError(f"{label}: a filtered hit has category != 3")
    after = one["raw_after_delete"]["ids"]
    if np.any((after % 1000 == 0) & (after >= 0)):
        raise AssertionError("a deleted id was returned after the deletion")
    if rec["host_anon_peak_bytes"] > HOST_ANON_BAR:
        raise AssertionError(f"host {rec['host_anon_source']} peak "
                             f"{rec['host_anon_peak_bytes']:,} bytes > "
                             f"{HOST_ANON_BAR:,}")
    if device.type != "cuda":
        return  # no kernel launches and no device memory on the CPU
    for name, r in one.items():
        if r["b1_launches"] < r["calls"]:
            raise AssertionError(f"one device {name}: {r['b1_launches']} B1 launches for "
                                 f"{r['calls']} searches")
    for name in ("raw", "refined", "filtered"):
        if mesh[name]["b1_launches"] != SHARDS * one[name]["b1_launches"]:
            raise AssertionError(f"mesh {name}: {mesh[name]['b1_launches']} B1 launches, not "
                                 f"{SHARDS} x {one[name]['b1_launches']}")
    mem = rec["memory"]
    if abs(mem["after_disable_bytes"] - mem["with_single_searcher_bytes"]) > mem[
            "one_searcher_bytes"]:
        raise AssertionError(f"device memory not released after the mesh: {mem}")


def public(res: dict) -> dict:
    """A level's searches without their hit arrays."""
    return {name: {k: v for k, v in r.items() if k not in ("ids", "categories")}
            for name, r in res.items()}


def run(n: int = N, ch: int = CH, device=None, workdir=None) -> dict:
    """The whole probe in ``workdir`` (default: a temporary directory,
    deleted after) → the record. Raises on a missed bar."""
    import lancedb_tpu_torch

    from ..index import IvfPq
    from ..ops.util import resolve_device
    from ..parallel import make_mesh
    from ..session import _searcher_nbytes
    from .common import HostAnonPeak

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # the mesh names it 4 times
    own = workdir is None
    work = Path(tempfile.mkdtemp(prefix="deep100m-") if own else workdir)
    work.mkdir(parents=True, exist_ok=True)
    disk = DISK_BYTES * n // N
    free = shutil.disk_usage(work).free
    if free < disk:
        raise RuntimeError(f"{n:,} x {D} rows need about {disk:,} bytes of disk under {work}; "
                           f"{free:,} are free")
    rec: dict = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                 "n": n, "d": D, "npart": num_partitions(n), "nsub": NSUB, "nbits": NBITS,
                 "nprobes": NPROBES, "nq": NQ, "chunk_rows": ch, "shards": SHARDS}
    t_start = time.perf_counter()
    try:
        with HostAnonPeak() as anon:
            db = lancedb_tpu_torch.connect(str(work / "db"), device=dev)
            tbl, q, truths, secs = make_table(db, n, ch, dev)
            rec.update(secs)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            tbl.create_index(config=IvfPq(num_partitions=num_partitions(n),
                                          num_sub_vectors=NSUB, num_bits=NBITS))
            _sync(dev)
            rec["build_s"] = time.perf_counter() - t0
            rec["build_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else None)
            ds = tbl._dataset
            meta = ds.manifest.indices[0]
            rec["build_mode"] = meta.params["build_mode"]
            sp = tbl._get_searcher(meta)
            rec.update(blocks=sp.nparts, pmax=sp.pmax, block_nprobes=sp._block_nprobes(NPROBES),
                       memory_index_bytes=_mem(dev))
            index_bytes = _searcher_nbytes(sp)  # the searcher before its refine table
            rec["probe_coverage"] = probe_coverage(sp, q, truths["raw"], ds)
            print(f"[deep100m] built: {json.dumps(rec)}", flush=True)

            anon.mark("data_and_build")
            # one device
            os.environ.setdefault("LANCEDB_TPU_DEVICE_REFINE_BUDGET", str(int(n * D * 2 + 2**30)))
            single = searches(tbl, q, [("raw", "raw", None, None),
                                       ("refined", "raw", REFINE, None),
                                       ("filtered", "filtered", None, FILTER)], truths, dev)
            vecs = sp._device.get("refine_vecs")
            rec["refine_mode"] = ("host" if vecs is None else
                                  f"fused_device_{str(vecs.dtype).removeprefix('torch.')}")
            rec["refine_table_s"] = single["refined"]["first_call_s"]
            rec["memory_refine_bytes"] = mem_single = _mem(dev)
            del vecs
            anon.mark("one_device")

            # the mesh, beside the one-device searcher and its refine table
            tbl.enable_sharded_serving(make_mesh(devices=[dev] * SHARDS))
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            mesh = searches(tbl, q, [("raw", "raw", None, None),
                                     ("refined", "raw", REFINE, None),
                                     ("filtered", "filtered", None, FILTER)], truths, dev)
            sharded = next(s for k, s in tbl._searchers.items() if k.startswith("sharded:"))
            dtype = sharded._sharded.refine_dtype
            rec["mesh_refine_mode"] = ("host" if dtype is None else
                                       f"fused_device_{str(dtype).removeprefix('torch.')}")
            rec["mesh_refine_table_s"] = mesh["refined"]["first_call_s"]
            rec["mesh_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None)
            del sharded
            tbl.disable_sharded_serving()
            gc.collect()
            rec["memory"] = {"with_single_searcher_bytes": mem_single,
                             "after_disable_bytes": _mem(dev),
                             "one_searcher_bytes": index_bytes}
            del sp
            anon.mark("mesh")

            # the deletion, then one device again
            t0 = time.perf_counter()
            tbl.delete(DELETE)
            rec["delete_s"] = time.perf_counter() - t0
            gc.collect()
            single.update(searches(tbl, q, [("raw_after_delete", "after_delete", None, None)],
                                   truths, dev))
            anon.mark("after_delete")
        rec["single"], rec["mesh4"] = single, mesh
        rec["queries"], rec["truths"] = q, truths
        rec["host_anon_peak_bytes"] = anon.peak_bytes
        rec["host_anon_source"], rec["host_vmrss_peak_bytes"] = anon.source, anon.rss_peak_bytes
        rec["host_anon_stage_peak_bytes"] = anon.stages
        rec["host_ru_maxrss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        rec["seconds"] = time.perf_counter() - t_start
        check(rec, dev)
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    out = {k: v for k, v in rec.items() if k not in ("single", "mesh4", "queries", "truths")}
    out["single"], out["mesh4"] = public(rec["single"]), public(rec["mesh4"])
    print(f"[deep100m] {json.dumps(out)}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="rows (the config's 100,000,000)")
    ap.add_argument("--ch", type=int, default=CH, help="rows a chunk")
    ap.add_argument("--workdir", help="the database (default: a temporary directory, deleted "
                    "after)")
    ap.add_argument("--device", help="cuda (the default) or cpu")
    a = ap.parse_args()
    run(a.n, a.ch, a.device, a.workdir)
    if torch.cuda.is_available() and a.device in (None, "cuda"):
        from .common import card_line

        print(f"card (nvidia-smi name, power.limit): {card_line()}", flush=True)


if __name__ == "__main__":
    main()
