"""The column reaches the device one block at a time (the build's upload,
the one-device and the sharded refine tables), and BASELINE config #5's
probe (lancedb_tpu_torch/probes/probe_deep100m.py) at a small size on the
CPU.

- ``_upload_vectors`` gives the tensor the whole-column read gave: the
  fragments' rows concatenated in scan order (unit rows for cosine), cast
  to the build dtype, bit for bit; also with deletions and after
  ``compact_files()``, and a block at a time across fragment boundaries.
- The one-device refine table equals the whole-column formula it
  replaces (written out below in numpy): the slot map and the f16
  residuals (or f32 rows) exactly; the f32 norms to 1 f32 ulp, because
  the device's f64 sum and numpy's pairwise f64 sum may round the last
  f32 bit apart. Also with deletions and rows added after the build, and
  with the fragments scanned out of row-id order (as after a compaction
  that renumbers rows).
- The sharded refine table on meshes of ``cpu`` x 1 and x 4 equals the
  whole-column slot-order formula dealt as the blocks are, the same way.
- Under ``tracemalloc`` (numpy reports its buffers to it; torch's CPU
  tensors and Arrow's memory maps are not traced) an IVF_PQ build over a
  multi-fragment table and its first refined search hold less than half
  the column's f32 bytes in numpy at their peak: the whole-column reads
  held all of it and more.
- The probe's ``run`` at 12,000 rows, with the port's RES_FREE_BYTES at 0
  and the f32 refine budget at 0 so that it takes the residual-free build
  and the f16 tables the 100M run takes; the reference builds the same
  table (after the probe's deletion) in its buffered mode, which on the
  CPU gives the residual-free files. Raw recall@10 within 0.03, each
  package's searcher on the other's index gives the builder's own top-10,
  and the 4-shard mesh's hits are one device's (the 1-shard bar).
"""

import shutil
import tracemalloc

import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu.index import vector as ref_vector
from lancedb_tpu_torch.index import IvfPq
from lancedb_tpu_torch.index import vector as port_vector
from lancedb_tpu_torch.parallel import make_mesh
from lancedb_tpu_torch.probes import probe_deep100m as probe
from lancedb_tpu_torch.probes.common import make_clustered

D, K = 96, 10
CPU = torch.device("cpu")


def _rows(n: int, seed: int = 0, dim: int = D) -> np.ndarray:
    return make_clustered(np.random.default_rng(seed), n, dim, n_coarse=64, n_parents=512)[0]


def _part(ids: np.ndarray, x: np.ndarray) -> pa.Table:
    return pa.table({"id": ids, "category": ids % 10, "vector":
                     pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), x.shape[1])})


def _table(path, sizes=(1500, 700, 2300, 900, 1600), seed: int = 0, dim: int = D):
    """A table of one fragment per size, ids in order."""
    x = _rows(sum(sizes), seed, dim)
    db = lancedb_tpu_torch.connect(str(path), device="cpu")
    tbl = db.create_table("t", _part(np.arange(sizes[0]), x[: sizes[0]]))
    for s, m in zip(np.cumsum(sizes)[:-1], sizes[1:]):
        tbl.add(_part(np.arange(s, s + m), x[s : s + m]))
    return tbl


def _whole_column(ds, metric: str):
    """The whole-column read: (rows in scan order, their row ids), unit
    rows for cosine, as _collect_vectors and the build's formula gave them."""
    mats, rids = [], []
    for _, t in ds.scan_fragments(columns=["vector"], with_row_id=True):
        mats.append(np.asarray(t.column("vector").combine_chunks().flatten()).reshape(-1, D))
        rids.append(t.column("_rowid").to_numpy().astype(np.uint64))
    x = np.concatenate(mats).astype(np.float32)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    return x, np.concatenate(rids)


def _mutate(tbl, case: str) -> None:
    if case == "deleted":
        tbl.delete("id % 7 = 3 OR id < 40")
    elif case == "compacted":
        tbl.delete("id % 5 = 1")
        tbl.compact_files()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["l2", "cosine", "deleted", "compacted"])
def test_streamed_build_tensor(tmp_path, case, dtype):
    """The build's device tensor is the concatenated fragments cast to the
    build dtype, bit for bit, with the same row ids and fragment ids."""
    tbl = _table(tmp_path)
    _mutate(tbl, case)
    ds = tbl._dataset
    metric = "cosine" if case == "cosine" else "l2"
    want, want_rid = _whole_column(ds, metric)
    rid, frag_ids, x = port_vector._upload_vectors(ds, "vector", metric, CPU,
                                                   getattr(torch, dtype))
    assert x.dtype == getattr(torch, dtype) and x.shape == want.shape
    assert torch.equal(x, torch.from_numpy(want).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(rid, want_rid)
    assert frag_ids == [f.id for f in ds.manifest.fragments if f.num_rows]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_column_blocks_cross_fragments(tmp_path, metric):
    """Blocks smaller than a fragment (ragged at each fragment's end) cover
    the scan in order with the whole-column rows."""
    tbl = _table(tmp_path)
    tbl.delete("id % 3 = 0")
    want, _ = _whole_column(tbl._dataset, metric)
    got, starts = [], []
    for start, blk in port_vector._column_blocks(tbl._dataset, "vector", metric, CPU,
                                                 block_rows=333):
        starts.append(start)
        got.append(blk.clone())
    assert starts == np.cumsum([0] + [len(b) for b in got[:-1]]).tolist()
    assert max(len(b) for b in got) == 333
    assert torch.equal(torch.cat(got), torch.from_numpy(want))


def _index(tbl, metric: str = "l2"):
    tbl.create_index(config=IvfPq(num_partitions=8, num_sub_vectors=12, num_bits=4,
                                  distance_type=metric))
    return tbl._dataset.manifest.indices[0]


def _rowid_sorted(ds, metric: str):
    """The whole-column refine read: the live rows sorted by row id."""
    x, rid = _whole_column(ds, metric)
    order = np.argsort(rid)
    return x[order], rid[order]


def _slots(rid_sorted: np.ndarray, slot_rid: np.ndarray):
    pos = np.clip(np.searchsorted(rid_sorted, slot_rid), 0, len(rid_sorted) - 1)
    return pos, rid_sorted[pos] == slot_rid


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in f32 units of the last place (values >= 0)."""
    return int(np.max(np.abs(got.view(np.int32).astype(np.int64)
                             - want.view(np.int32).astype(np.int64))))


@pytest.mark.parametrize("precision", ["float16", "float32"])
@pytest.mark.parametrize("case", ["l2", "cosine", "deleted", "reordered"])
def test_one_device_refine_table(tmp_path, case, precision):
    """The streamed refine table equals the whole-column formula: slot
    map, residuals (or rows) exactly, norms within 1 f32 ulp."""
    metric = "cosine" if case == "cosine" else "l2"
    tbl = _table(tmp_path)
    meta = _index(tbl, metric)
    ds = tbl._dataset
    if case == "deleted":  # dead slots, and rows no slot holds
        tbl.delete("id % 7 = 3 OR id < 40")
        tbl.add(_part(np.arange(10_000, 10_500), _rows(500, seed=3)))
        ds = tbl._dataset
    if case == "reordered":
        # the scan yields the fragments out of row-id order (as after a
        # compaction that renumbers rows): positions still follow row ids
        ds.manifest.fragments.reverse()
        assert port_vector._rowid_order(port_vector._scan_row_ids(ds)[0])[1] is not None
    sp = port_vector.load_searcher(ds, meta, "cpu")
    assert sp.prepare_device_refine(ds, "vector", precision=precision)

    mat, rid = _rowid_sorted(ds, metric)
    pos, found = _slots(rid, sp.row_ids_flat)
    valid = found & sp.row_ids_valid
    np.testing.assert_array_equal(sp._device["refine_slotmap"].numpy(), np.where(valid, pos, 0))
    vecs = orig = mat
    if precision == "float16":
        part_of_row = np.zeros(len(rid), np.int32)
        part_of_row[pos[valid]] = (np.arange(sp.num_slots) // sp.pmax)[valid]
        c = sp._device["centroids"].numpy()[part_of_row]
        vecs = mat - c
        orig = vecs + c
    assert torch.equal(sp._device["refine_vecs"], torch.from_numpy(vecs).to(getattr(torch,
                                                                                  precision)))
    if metric == "l2":
        want = np.sum(orig.astype(np.float64) ** 2, axis=1).astype(np.float32)
        assert _ulps(sp._device["refine_norms2"].numpy(), want) <= 1
    else:
        assert "refine_norms2" not in sp._device


@pytest.mark.parametrize("metric,shards,precision", [
    ("l2", 1, "float16"), ("l2", 4, "float16"), ("l2", 1, "float32"), ("l2", 4, "float32"),
    ("cosine", 4, "float16"),
])
def test_sharded_refine_table(tmp_path, metric, shards, precision):
    """The sharded table equals the whole-column slot-order formula
    (zeros on padding and dead slots, residuals against each slot's block
    centroid for f16, f32 norms of the original rows) dealt as the blocks
    are: rows exactly, norms within 1 f32 ulp."""
    tbl = _table(tmp_path)
    meta = _index(tbl, metric)
    tbl.delete("id % 11 = 2")
    tbl.enable_sharded_serving(make_mesh(devices=["cpu"] * shards))
    ss = tbl._get_searcher(meta)
    assert ss.prepare_device_refine(tbl._dataset, "vector", precision=precision)
    sh = ss._sharded
    assert sh.refine_dtype == getattr(torch, precision)

    mat, rid = _rowid_sorted(tbl._dataset, metric)
    pos, found = _slots(rid, sh.row_ids)
    vecs = np.where(found[:, None], mat[pos], 0.0).astype(np.float32)
    norms2 = np.sum(vecs.astype(np.float64) ** 2, axis=1).astype(np.float32)
    if precision == "float16":
        cents = sh._centroids[0][0].numpy()
        vecs = np.where(found[:, None], vecs - cents[np.arange(sh.num_slots) // sh.pmax], 0.0)
    want_v = torch.from_numpy(vecs.reshape(sh.nblocks, sh.pmax, D)[sh._deal].astype(np.float32))
    want_n = norms2.reshape(sh.nblocks, sh.pmax)[sh._deal]
    per = sh.nblocks // shards
    for j in range(shards):
        got_v = sh._refine_vecs[0][j]
        assert torch.equal(got_v, want_v[j * per : (j + 1) * per].to(getattr(torch, precision)))
        assert _ulps(sh._refine_norms2[0][j].numpy(), want_n[j * per : (j + 1) * per]) <= 1


@pytest.mark.parametrize("f32_budget", [None, "0"], ids=["f32_table", "f16_table"])
def test_no_column_copy_on_the_host(tmp_path, monkeypatch, f32_budget):
    """numpy's traced peak during create_index(IVF_PQ) and during the
    first refined search stays below half the column's f32 bytes. The
    rows are 384 wide, so that what the build keeps per row (row ids,
    codes, the layout's order: tens of bytes) stays far below half a
    row's 1,536."""
    if f32_budget is not None:
        monkeypatch.setenv("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", f32_budget)
    sizes, dim = (2500,) * 8, 384
    tbl = _table(tmp_path, sizes=sizes, dim=dim)
    half = sum(sizes) * dim * 4 // 2
    q = _rows(64, seed=9, dim=dim)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        tbl.create_index(config=IvfPq(num_partitions=16, num_sub_vectors=12, num_bits=4))
        build_peak = tracemalloc.get_traced_memory()[1] - base
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        out = tbl.search(q).nprobes(4).refine_factor(5).limit(K).select(["id"]).to_arrow()
        search_peak = tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()
    sp = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    assert sp.device_refine_active and out.num_rows == 64 * K
    assert build_peak < half, (build_peak, half)
    assert search_peak < half, (search_peak, half)


# ------------------------------------------------------------ the probe
N, CH = 12_000, 3_000


def _recall(hits: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(hits, gt)]))


@pytest.fixture(scope="module")
def deep_run(tmp_path_factory):
    """The probe's run in the port (res_free, f16 tables), then the
    reference's build on a copy of the table after the probe's deletion
    → (record, the port's db, the copy's path)."""
    work = tmp_path_factory.mktemp("deep")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vector, "RES_FREE_BYTES", 0)
        mp.setenv("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", "0")
        # the probe's budget, set here so that it is undone after the run
        mp.setenv("LANCEDB_TPU_DEVICE_REFINE_BUDGET", str(int(N * D * 2 + 2**30)))
        rec = probe.run(n=N, ch=CH, device="cpu", workdir=work)
    ref_root = work / "ref_db"
    shutil.copytree(work / "db", ref_root)
    ref_tbl = lancedb_tpu.connect(str(ref_root)).open_table("deep")
    ref_tbl.drop_index(ref_tbl._dataset.manifest.indices[0].name)
    ref_tbl.create_index(config=RefIvfPq(num_partitions=probe.num_partitions(N),
                                         num_sub_vectors=probe.NSUB, num_bits=probe.NBITS),
                         name="ref_pq")
    return rec, work / "db", ref_root


def test_probe_record_and_table(deep_run):
    """The record's modes and settings; the table holds the probe's rows
    (chunk c drawn from its generator seeded 1000 + c) in id order less
    the deleted ids; the truths are a numpy brute force's top-10."""
    rec, root, _ = deep_run
    assert (rec["n"], rec["d"], rec["npart"], rec["nsub"], rec["nq"]) == (N, D, 64, 12, 256)
    assert rec["build_mode"] == "res_free"
    assert rec["refine_mode"] == rec["mesh_refine_mode"] == "fused_device_float16"
    assert 0.0 < rec["probe_coverage"] <= 1.0
    assert set(rec["host_anon_stage_peak_bytes"]) == {"data_and_build", "one_device", "mesh",
                                                      "after_delete"}
    spectrum, parents, q = probe.hierarchy()
    np.testing.assert_array_equal(rec["queries"], q)
    x = torch.cat([probe.chunk_rows(torch.from_numpy(spectrum), torch.from_numpy(parents), c,
                                    CH) for c in range(N // CH)]).numpy()
    out = lancedb_tpu_torch.connect(str(root), device="cpu").open_table("deep").to_arrow()
    ids = np.asarray(out["id"])
    np.testing.assert_array_equal(ids, np.arange(N)[np.arange(N) % 1000 != 0])
    np.testing.assert_array_equal(np.asarray(out["category"]), ids % 10)
    np.testing.assert_array_equal(
        np.asarray(out["vector"].combine_chunks().flatten()).reshape(-1, D), x[ids])
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    d = (x64 * x64).sum(1)[None, :] - 2.0 * (q64 @ x64.T)
    for name, keep in (("raw", np.ones(N, bool)), ("filtered", np.arange(N) % 10 == 3),
                       ("after_delete", np.arange(N) % 1000 != 0)):
        want = np.argsort(np.where(keep[None, :], d, np.inf), axis=1, kind="stable")[:, :K]
        assert _recall(rec["truths"][name], want) == 1.0, name


def test_raw_recall_matches_reference_build(deep_run):
    """The port's build (res_free, before the deletion) and the
    reference's (after it) reach raw recall@10 within 0.03 of each other
    on the table after the deletion."""
    rec, _, ref_root = deep_run
    out = (lancedb_tpu.connect(str(ref_root)).open_table("deep").search(rec["queries"])
           .nprobes(probe.NPROBES).limit(K).select(["id", "category"]).to_arrow())
    ref_recall = _recall(probe.batch_hits(out)[0], rec["truths"]["after_delete"])
    port_recall = rec["single"]["raw_after_delete"]["recall@10"]
    assert abs(port_recall - ref_recall) <= 0.03, (port_recall, ref_recall)


@pytest.mark.parametrize("builder", ["reference", "port"])
def test_cross_loaded_top10(deep_run, builder):
    """Each package's searcher on the other's index gives the builder's
    own top-10 exactly (raw, nprobes 20), distances to rtol 1e-5."""
    rec, root, ref_root = deep_run
    name = "ref_pq" if builder == "reference" else "vector_idx"
    path = ref_root if builder == "reference" else root
    ref_ds = lancedb_tpu.connect(str(path)).open_table("deep")._dataset
    port_ds = lancedb_tpu_torch.connect(str(path), device="cpu").open_table("deep")._dataset
    ref_sp = ref_vector.load_searcher(
        ref_ds, next(ix for ix in ref_ds.manifest.indices if ix.name == name))
    port_sp = port_vector.load_searcher(
        port_ds, next(ix for ix in port_ds.manifest.indices if ix.name == name), "cpu")
    q = rec["queries"]
    want_d, want_r = ref_sp.search(q, ref_vector.SearchParams(k=K, nprobes=probe.NPROBES))
    got_d, got_r = port_sp.search(q, port_vector.SearchParams(k=K, nprobes=probe.NPROBES))
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


@pytest.mark.parametrize("name", ["raw", "filtered"])
def test_mesh_hits_are_one_devices(deep_run, name):
    """The 4-shard mesh's hits against one device's on the same table: at
    least 9 of 10 ids a query and a mean overlap of at least 0.99."""
    rec = deep_run[0]
    got, want = rec["mesh4"][name]["ids"], rec["single"][name]["ids"]
    per_q = np.array([len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got, want)])
    assert per_q.min() >= 9 and per_q.mean() / K >= 0.99, per_q
