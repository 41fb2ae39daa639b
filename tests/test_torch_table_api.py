"""The table lifecycle of lancedb_tpu_torch (device="cpu") against
lancedb_tpu: update and merge_insert, index management and background
jobs, optimize (compaction and the rebuild of stale indexes), versions,
tags and branches, schema evolution and the table's outputs, plain scans,
the builders' shared setters and outputs, explain_plan / analyze_plan,
connection management and read consistency.

Each test runs one sequence of operations on both packages, on two copies
of one table made from seeded numpy data (with a reference-built IVF_PQ
index where the test searches). Table contents are compared sorted by id,
exactly; the stats the operations return exactly; search results row for
row: the same ids in the same order, distances to rtol 1.3e-5 (the two
searchers sum in other orders; PERF.md §7) with an atol of 1e-5 |q|²,
the size of the l2 expansion's terms. optimize() rebuilds IVF_PQ in each
package from the same seed, and the rebuilt arrays are held to the
tolerances of test_torch_capacity.py's whole-build test. Every thread a
test starts is joined with a timeout and checked to have ended.
"""

import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pydantic
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu_torch.index import vector as port_vector

N, DIM, NQ, PARTS, NSUB = 2000, 32, 8, 8, 8
_RNG = np.random.default_rng(7)
_CENT = _RNG.standard_normal((24, DIM)).astype(np.float32) * 3.0
X = (_CENT[_RNG.integers(0, 24, N)] + _RNG.standard_normal((N, DIM))).astype(np.float32)
Q = (_CENT[_RNG.integers(0, 24, NQ)] + _RNG.standard_normal((NQ, DIM))).astype(np.float32)
_WORDS = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"])


def _rows(ids: np.ndarray, vecs: np.ndarray, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    price = rng.uniform(0, 100, len(ids))
    return pa.table({
        "id": ids.astype(np.int64),
        "category": (ids % 10).astype(np.int64),
        "price": pa.array(price, mask=ids % 13 == 0),  # nulls for the null ordering
        "label": [f"item-{i % 7}" for i in ids],
        "text": [" ".join(_WORDS[rng.integers(0, 6, 4)]) for _ in ids],
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), DIM),
    })


TABLE = _rows(np.arange(N), X, 1)
# 100 existing ids with new vectors near the queries, and 100 new ids
_UPSERT_IDS = np.concatenate([np.arange(0, 200, 2), np.arange(N, N + 100)])
_UPSERT_VECS = (Q[np.arange(200) % NQ] + 0.05 * np.random.default_rng(3).standard_normal(
    (200, DIM))).astype(np.float32)
UPSERT = _rows(_UPSERT_IDS, _UPSERT_VECS, 2).set_column(
    1, "category", pa.array((_UPSERT_IDS % 7).astype(np.int64)))
QN2 = float(np.max((Q.astype(np.float64) ** 2).sum(1)))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A reference-built table with an IVF_PQ index on ``vector``."""
    path = tmp_path_factory.mktemp("lifecycle_base")
    t = lancedb_tpu.connect(str(path)).create_table("t", TABLE)
    t.create_index(config=RefIvfPq(num_partitions=PARTS, num_sub_vectors=NSUB,
                                   max_iterations=10))
    return path


@pytest.fixture()
def pair(base, tmp_path):
    """(port, reference) handles on two copies of the base table."""
    for side in ("port", "ref"):
        shutil.copytree(base, tmp_path / side)
    return (lancedb_tpu_torch.connect(str(tmp_path / "port"), device="cpu").open_table("t"),
            lancedb_tpu.connect(str(tmp_path / "ref")).open_table("t"))


@pytest.fixture()
def plain_pair(tmp_path):
    """(port, reference) tables made by each package from TABLE, no index."""
    return (lancedb_tpu_torch.connect(str(tmp_path / "port"), device="cpu")
            .create_table("t", TABLE),
            lancedb_tpu.connect(str(tmp_path / "ref")).create_table("t", TABLE))


def _same_rows(got: pa.Table, want: pa.Table, key: str = "id") -> None:
    assert got.column_names == want.column_names
    assert got.sort_by(key).equals(want.sort_by(key)), (got.sort_by(key), want.sort_by(key))


def _same_hits(got: pa.Table, want: pa.Table) -> None:
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for col in ("id", "query_index"):
        if col in want.column_names:
            np.testing.assert_array_equal(np.asarray(got[col]), np.asarray(want[col]), col)
    np.testing.assert_allclose(np.asarray(got["_distance"]), np.asarray(want["_distance"]),
                               rtol=1.3e-5, atol=1e-5 * QN2)


def _package(t):
    return lancedb_tpu_torch if isinstance(t, lancedb_tpu_torch.Table) else lancedb_tpu


def _without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


# ------------------------------------------------------------ 1. CRUD


MUTATIONS = {
    "upsert": lambda t: t.merge_insert("id").when_matched_update_all()
    .when_not_matched_insert_all().execute(UPSERT),
    "upsert_condition": lambda t: t.merge_insert("id").when_matched_update_all(
        where="target.category < source.category").when_not_matched_insert_all().execute(UPSERT),
    "delete_missing": lambda t: t.merge_insert("id").when_not_matched_by_source_delete(
        "id < 1000").when_not_matched_insert_all().execute(UPSERT),
    "update_values": lambda t: t.update(where="category = 3", values={"category": 42}),
    "update_quoted_null": lambda t: t.update(where="id < 30",
                                             values={"label": "it's", "price": None}),
    "update_sql": lambda t: t.update(values_sql={"price": "price + 1"}, where="id >= 1900"),
    "delete": lambda t: t.delete("id < 100 OR category = 9"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_matches_reference(plain_pair, case):
    port, ref = plain_pair
    got, want = MUTATIONS[case](port), MUTATIONS[case](ref)
    assert got == want
    assert port.count_rows() == ref.count_rows()
    _same_rows(port.to_arrow(), ref.to_arrow())
    assert port.count_rows("category = 42") == ref.count_rows("category = 42")


def test_use_lsm_stays_refused(plain_pair):
    """The LSM write path is served now (it was refused before its slice):
    an upsert through the WAL scans as the reference's, and a search still
    refuses use_lsm, as the reference's does."""
    port, ref = plain_pair
    for t in plain_pair:
        t.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=3)
        stats = (t.merge_insert("id").when_matched_update_all().when_not_matched_insert_all()
                 .use_lsm().execute(UPSERT))
        assert stats["num_rows"] == UPSERT.num_rows and t.count_rows() == N
    _same_rows(port.query().use_lsm().to_arrow(), ref.query().use_lsm().to_arrow())
    with pytest.raises(lancedb_tpu_torch.InvalidInputError, match="use_lsm"):
        port.search(Q[0]).use_lsm().to_arrow()
    for t in plain_pair:
        t.flush_lsm()
    _same_rows(port.to_arrow(), ref.to_arrow())


# ------------------------------------------------- search after mutations


SEARCH_AFTER = {
    "upsert": MUTATIONS["upsert"],
    "update": MUTATIONS["update_values"],
    "delete": MUTATIONS["delete"],
    "add": lambda t: t.add(_rows(np.arange(N, N + 50), X[:50] + 0.01, 4)),
    "upsert_then_delete": lambda t: (MUTATIONS["upsert"](t), t.delete("id < 1000")),
}


@pytest.mark.parametrize("case", sorted(SEARCH_AFTER))
def test_search_after_mutation_matches_reference(pair, case):
    """The shared index, its deletion mask and the delta fragments' brute
    force: the port's hits are the reference's; no id is returned twice,
    and an upserted row is found at its new vector, never at its old."""
    port, ref = pair
    SEARCH_AFTER[case](port)
    SEARCH_AFTER[case](ref)
    for build in (lambda t: t.search(Q).nprobes(4).limit(10),
                  lambda t: t.search(Q).nprobes(4).refine_factor(5).where("category < 5").limit(5),
                  lambda t: t.search(Q[0]).nprobes(8).select(["id", "category"]).limit(20)):
        got = build(port).to_arrow()
        _same_hits(got, build(ref).to_arrow())
        qi = np.asarray(got["query_index"]) if "query_index" in got.column_names else None
        ids = np.asarray(got["id"])
        for q in (np.unique(qi) if qi is not None else [None]):
            sel = ids if q is None else ids[qi == q]
            assert len(np.unique(sel)) == len(sel)
    if case.startswith("upsert"):
        hits = port.search(_UPSERT_VECS).nprobes(PARTS).limit(1).to_arrow()
        alive = set(np.asarray(port.to_arrow()["id"]).tolist())
        want = [i if i in alive else None for i in _UPSERT_IDS]
        got = dict(zip(np.asarray(hits["query_index"]), np.asarray(hits["id"])))
        assert all(got[j] == w for j, w in enumerate(want) if w is not None)


def test_update_of_vector_column_is_searched_in_the_delta(pair):
    port, ref = pair
    new = (Q[:4] + 0.001).astype(np.float32)
    rows = _rows(np.array([5, 6, 7, 8]), new, 9)
    for t in pair:
        t.merge_insert("id").when_matched_update_all().execute(rows)
    got = port.search(new).nprobes(2).limit(1).to_arrow()
    _same_hits(got, ref.search(new).nprobes(2).limit(1).to_arrow())
    assert np.asarray(got["id"]).tolist() == [5, 6, 7, 8]
    # the old vectors no longer find their rows
    old = port.search(X[5:9]).nprobes(PARTS).limit(1).to_arrow()
    assert not set(np.asarray(old["id"]).tolist()) & {5, 6, 7, 8}


# ------------------------------------------------- 2. index management


def test_index_management_matches_reference(pair):
    port, ref = pair
    for t in pair:
        t.add(_rows(np.arange(N, N + 50), X[:50], 4))
        t.create_scalar_index("category", index_type="BITMAP")
        t.create_fts_index("text")
    assert port.list_indices() == ref.list_indices()
    for ix in ref.list_indices():
        got, want = port.index_stats(ix["name"]), ref.index_stats(ix["name"])
        assert _without(got, "params") == _without(want, "params")
        assert (_without(got["params"], "build_seconds")
                == _without(want["params"], "build_seconds"))
    assert port.index_stats("nope") is None and ref.index_stats("nope") is None
    port.prewarm_index("vector_idx")
    assert "vector_idx" not in port._searchers and len(port._searchers) == 1
    port.prewarm_index("text_fts_idx")
    with pytest.raises(lancedb_tpu_torch.IndexNotFoundError):
        port.prewarm_index("nope")
    port.wait_for_index(["vector_idx", "text_fts_idx"], timeout=1)
    with pytest.raises(TimeoutError):
        port.wait_for_index(["nope"], timeout=0.2)
    for t in pair:
        t.drop_index("category_idx")
    assert port.list_indices() == ref.list_indices()


def test_create_index_async_and_jobs(tmp_path):
    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu")
    t = db.create_table("t", TABLE)
    job = t.create_index_async(config=lancedb_tpu_torch.IvfFlat(num_partitions=4,
                                                                 max_iterations=5))
    job.wait(timeout=60)
    assert job.done() and job.status().value == "SUCCEEDED"
    assert t.list_indices()[0]["index_type"] == "IVF_FLAT"
    assert db.get_job(job.id) is job and db.job(job.id) is job
    assert [j["id"] for j in db.list_jobs()] == [job.id] == [j["id"] for j in db.job_history()]
    assert db.list_jobs(include_finished=False) == []
    assert db.cancel_job("nope") is False
    bad = t.create_index_async(index_type="NOPE")
    with pytest.raises(lancedb_tpu_torch.errors.JobFailureError):
        bad.wait(timeout=60)
    assert db.get_job(bad.id).status().value == "FAILED"


# ---------------------------------------------------------- 3. optimize


def _index_arrays(tbl, names) -> dict:
    meta = next(ix for ix in tbl._dataset.manifest.indices if ix.index_type == "IVF_PQ")
    prefix = tbl._dataset.index_dir(meta.uuid)
    return {n: port_vector._load_npy(tbl._dataset.store, f"{prefix}/{n}.npy") for n in names}


def test_optimize_rebuilds_the_reference_index(pair, tmp_path):
    """optimize() after a merge_insert: the same compaction, and an IVF_PQ
    rebuild (the port's on its device) equal to the reference's array by
    array, at test_torch_capacity.py's whole-build tolerances."""
    port, ref = pair
    for t in pair:
        MUTATIONS["upsert"](t)
        t.create_scalar_index("category")
        t.create_fts_index("text")
        t.add(_rows(np.arange(N + 100, N + 150), X[100:150], 5))
    # 100 rewritten and 100 inserted by the upsert, 50 added
    assert port.index_stats("vector_idx")["num_unindexed_rows"] == 250
    got, want = port.optimize(), ref.optimize()
    assert got == want
    assert port.index_stats("vector_idx")["num_unindexed_rows"] == 0
    _same_rows(port.to_arrow(), ref.to_arrow())
    names = ("row_ids", "counts", "centroids", "codebooks", "codes")
    a = _index_arrays(port, names)
    b = _index_arrays(lancedb_tpu_torch.connect(str(tmp_path / "ref"), device="cpu")
                      .open_table("t"), names)
    for n in ("row_ids", "counts"):
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=1e-4, atol=1e-4)
    close = np.all(np.isclose(a["codebooks"], b["codebooks"], rtol=1e-4, atol=1e-4), axis=(1, 2))
    assert np.sum(~close) <= 1
    assert np.mean(a["codes"] == b["codes"]) >= 0.999
    for ix in ref.list_indices():
        assert port.index_stats(ix["name"])["num_unindexed_rows"] == 0
    # FTS and scalar indexes are rebuilt on the host from the same rows
    q = lambda t: t.search("gamma delta", query_type="fts").where("category = 3").limit(10)
    np.testing.assert_array_equal(np.asarray(q(port).to_arrow()["id"]),
                                  np.asarray(q(ref).to_arrow()["id"]))


def test_compact_then_search_is_a_full_brute_force(pair):
    """Between compact_files() and a reindex the index covers no live
    fragment: the port masks every row it holds and brute-forces the
    table, giving the reference's bypass_vector_index() hits. The
    reference's own search raises there (ROADMAP §C)."""
    port, ref = pair
    for t in pair:
        t.add(_rows(np.arange(N, N + 50), X[:50] + 0.01, 4))
        t.delete("id = 7")
        assert t.compact_files() == {"fragments_removed": 2, "fragments_added": 1}
    assert port.index_stats("vector_idx")["num_indexed_rows"] == N
    assert port.index_stats("vector_idx")["num_unindexed_rows"] == N + 49
    assert port.search(Q).explain_plan() == ref.search(Q).explain_plan().replace("MXU ", "")
    assert "KnnFlatExec: delta fragments [2]" in port.search(Q).explain_plan()
    _same_hits(port.search(Q).nprobes(4).limit(10).to_arrow(),
               ref.search(Q).bypass_vector_index().limit(10).to_arrow())
    with pytest.raises(lancedb_tpu.errors.InvalidInputError, match="no fragment 0"):
        ref.search(Q).nprobes(4).limit(10).to_arrow()
    assert port.cleanup_old_versions(older_than_seconds=0) == ref.cleanup_old_versions(
        older_than_seconds=0)
    assert _without(port.stats(), "total_bytes") == _without(ref.stats(), "total_bytes")


@pytest.mark.parametrize("index_type", ["IVF_HNSW_SQ", "IVF_PQ", "IVF_SQ"])
def test_optimize_rebuilds_with_config_from_params(tmp_path, index_type):
    """The reference's _config_from_params, which the port copies (ROADMAP
    §C): an IVF_HNSW_* index comes back as FLAT, the other types keep their
    type with only the metric, partitions (and IVF_PQ's subvectors and
    bits) passed on."""
    from lancedb_tpu_torch.table import _config_from_params

    small = TABLE.slice(0, 600)
    out = {}
    for name, mod, device in (("port", lancedb_tpu_torch, {"device": "cpu"}),
                              ("ref", lancedb_tpu, {})):
        t = mod.connect(str(tmp_path / name), **device).create_table("t", small)
        t.create_index(index_type=index_type, num_partitions=4, num_sub_vectors=8, num_bits=4,
                       metric="cosine")
        t.add(_rows(np.arange(N, N + 20), X[:20], 4))
        t.optimize()
        out[name] = t.list_indices(), t.index_stats("vector_idx")
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1]["distance_type"] == out["ref"][1]["distance_type"] == "cosine"
    want_type = "FLAT" if index_type.startswith("IVF_HNSW") else index_type
    assert out["port"][0][0]["index_type"] == want_type
    cfg = _config_from_params("IVF_PQ", {"metric": "dot", "num_partitions": 4,
                                         "num_sub_vectors": 8, "num_bits": 4, "opq": True})
    assert (cfg.num_bits, cfg.num_sub_vectors, cfg.opq, cfg.distance_type) == (4, 8, False, "dot")


# ------------------------------------------- 4. versions, tags, branches


def _versions(t) -> list:
    return [_without(v, "timestamp") for v in t.list_versions()]


def test_versions_tags_restore_match_reference(pair):
    port, ref = pair
    for t in pair:
        v1 = t.version
        MUTATIONS["upsert"](t)
        t.tags.create("after-upsert")
        t.delete("id < 500")
        t.tags.create("first", v1)
        t.tags.update("first", v1 + 1)
    assert _versions(port) == _versions(ref)
    assert port.tags.list().keys() == ref.tags.list().keys()
    assert port.tags.get_version("first") == ref.tags.get_version("first") == v1 + 1
    for target in (v1, "after-upsert", "first"):
        for t in pair:
            t.checkout(target)
        assert port.version == ref.version
        _same_rows(port.to_arrow(), ref.to_arrow())
        _same_hits(port.search(Q).nprobes(4).limit(10).to_arrow(),
                   ref.search(Q).nprobes(4).limit(10).to_arrow())
        with pytest.raises(Exception):
            port.add(TABLE.slice(0, 1))
    for t in pair:
        t.checkout_latest()
        t.tags.delete("first")
        t.restore(v1)
    assert port.count_rows() == ref.count_rows() == N
    assert _versions(port) == _versions(ref)
    assert port.list_versions()[-1]["metadata"]["op"] == "restore"


def test_checkout_gives_the_same_hits(pair):
    """A search's ids at version v are the ids after checkout(v) of a later
    version whose index was rebuilt, and checkout_latest() returns to it."""
    port, _ = pair
    v = port.version
    before = port.search(Q).nprobes(4).limit(10).to_arrow()
    MUTATIONS["upsert"](port)
    port.optimize()
    latest = port.search(Q).nprobes(4).limit(10).to_arrow()
    for _ in range(2):
        port.checkout(v)
        again = port.search(Q).nprobes(4).limit(10).to_arrow()
        assert again["id"].equals(before["id"])
        np.testing.assert_allclose(np.asarray(again["_distance"]),
                                   np.asarray(before["_distance"]), rtol=0, atol=1e-6)
        port.checkout_latest()
        assert port.search(Q).nprobes(4).limit(10).to_arrow().equals(latest)
    assert port._conn.session.stats()["entries"] == 1  # the other version's searcher is gone


def test_branches_and_primary_key_match_reference(plain_pair):
    port, ref = plain_pair
    out = {}
    for name, t in (("port", port), ("ref", ref)):
        t.declare_primary_key("id")
        t.create_branch("exp")
        t.checkout_branch("exp")
        t.add(_rows(np.arange(N, N + 5), X[:5], 6))
        branch = t.current_branch, t.count_rows()
        t.checkout_branch("main")
        t.delete("id = 1")
        diff = t.diff_branch("exp")
        merged = t.merge_branch("exp")
        t.create_branch("gone")
        t.delete_branch("gone")
        out[name] = (branch, t.count_rows(), t.primary_key, sorted(t.list_branches()),
                     sorted(t.branches), diff, _without(merged, "timestamp"))
        t.set_unenforced_primary_key(["id", "category"])
        out[name] += (t.primary_key,)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ("exp", N + 5)
    _same_rows(port.to_arrow(), ref.to_arrow())


# ------------------------------------ 5. schema evolution and outputs


SCHEMA_OPS = {
    "add_columns": lambda t: t.add_columns({"double_price": "price * 2", "flag": "id > 5"}),
    "alter_columns": lambda t: t.alter_columns({"path": "label", "rename": "tag"},
                                               {"path": "id", "nullable": True}),
    "drop_columns": lambda t: t.drop_columns(["label", "text"]),
    "update_field_metadata": lambda t: t.update_field_metadata("price", {"unit": "usd"}),
    "replace_field_metadata": lambda t: t.replace_field_metadata("label", {"k": "v"}),
}


@pytest.mark.parametrize("case", sorted(SCHEMA_OPS))
def test_schema_evolution_matches_reference(plain_pair, case):
    port, ref = plain_pair
    SCHEMA_OPS[case](port)
    SCHEMA_OPS[case](ref)
    assert port.schema == ref.schema
    assert port.schema.metadata == ref.schema.metadata
    key = "id"
    _same_rows(port.to_arrow(), ref.to_arrow(), key)


@pytest.mark.parametrize("other", ["data", "table"])
def test_merge_matches_reference(tmp_path, other):
    """merge() of rows or of another table (pyarrow's join takes no
    fixed-size-list column, so these tables have no vector)."""
    extra = pa.table({"k": np.arange(0, N, 3), "bonus": np.arange(0, N, 3) * 0.5})
    out = []
    for name, mod, kw in (("port", lancedb_tpu_torch, {"device": "cpu"}), ("ref", lancedb_tpu, {})):
        db = mod.connect(str(tmp_path / name), **kw)
        t = db.create_table("t", TABLE.drop_columns(["vector"]))
        t.merge(db.create_table("o", extra) if other == "table" else extra, left_on="id",
                right_on="k")
        out.append(t.to_arrow())
    _same_rows(*out)


def test_table_outputs_match_reference(plain_pair):
    port, ref = plain_pair
    port.delete("id % 4 = 1")
    ref.delete("id % 4 = 1")
    assert port.head(7).equals(ref.head(7))
    assert port.take_offsets([0, 5, 900]).equals(ref.take_offsets([0, 5, 900]))
    rids = [3, 8, (0 << 32) | 1000]
    assert port.take_row_ids(rids).equals(ref.take_row_ids(rids))
    assert port.to_pandas().equals(ref.to_pandas())
    assert port.to_lance().version == ref.to_lance().version
    assert port.uri.endswith("port/t.lance") and ref.uri.endswith("ref/t.lance")
    assert _without(port.stats(), "total_bytes") == _without(ref.stats(), "total_bytes")
    assert len(port) == len(ref) == port.count_rows()


# ------------------------------------------------------ 6. plain scans


SCANS = {
    "where_select": lambda t: t.query().where("category = 4").select(["id", "price"]),
    "search_none": lambda t: t.search(None).where("id < 7").select(["id", "label"]),
    "filter_alias": lambda t: t.query().filter("price > 50").filter("category < 3"),
    "limit_offset": lambda t: t.query().where("category = 2").offset(5).limit(9),
    "limit_none": lambda t: t.query().limit(None),
    "order_by": lambda t: t.query().order_by("category", ("price", "desc")).limit(40).offset(3),
    "order_nulls_first": lambda t: t.query().order_by(
        _package(t).query.ColumnOrdering("price", ascending=False, nulls_first=True)).limit(30),
    "sql_projection": lambda t: t.query().where("id < 50").select(
        {"id2": "id * 2", "cheap": "price < 20"}),
    "with_row_id": lambda t: t.query().where("id > 1990").with_row_id(True),
    "row_address": lambda t: t.query().where("id < 5").with_row_address(),
    "fragment_ids": lambda t: t.query().fragment_ids([1]).where("id < 10"),
    "with_fragments": lambda t: t.query().with_fragments([0]).limit(4),
}


@pytest.mark.parametrize("case", sorted(SCANS))
def test_plain_scan_matches_reference(plain_pair, case):
    port, ref = plain_pair
    for t in plain_pair:  # two fragments, one with deletions
        t.add(_rows(np.arange(N, N + 30), X[:30], 8))
        t.delete("id % 11 = 0")
    got, want = SCANS[case](port).to_arrow(), SCANS[case](ref).to_arrow()
    assert got.equals(want), (got, want)
    batches = list(SCANS[case](port).to_batches(64))
    assert all(b.num_rows <= 64 for b in batches)
    assert pa.Table.from_batches(batches, got.schema).equals(got)


def test_streaming_scan_equals_to_arrow(plain_pair):
    port, ref = plain_pair
    for t in plain_pair:
        t.add(_rows(np.arange(N, N + 500), X[:500], 8))
    want = ref.to_arrow()
    batches = list(port.query().to_batches(700))
    assert [b.num_rows for b in batches] == [700, 700, 600, 500]
    assert pa.Table.from_batches(batches).equals(want)
    ref_b = list(ref.query().where("category = 1").limit(150).offset(20).to_batches(40))
    got_b = list(port.query().where("category = 1").limit(150).offset(20).to_batches(40))
    assert [b.num_rows for b in got_b] == [b.num_rows for b in ref_b]
    assert pa.Table.from_batches(got_b).equals(pa.Table.from_batches(ref_b))
    with pytest.raises(TimeoutError):
        list(port.query().to_batches(10, timeout=0.0))


# ----------------------------------------- 7. builder setters and outputs


def test_builder_outputs_match_reference(pair):
    port, ref = pair
    b = lambda t: t.search(Q[:3]).nprobes(4).limit(4).select(["id", "category"])
    got, want = b(port).to_list(), b(ref).to_list()
    assert [_without(r, "_distance") for r in got] == [_without(r, "_distance") for r in want]
    np.testing.assert_allclose([r["_distance"] for r in got], [r["_distance"] for r in want],
                               rtol=1.3e-5, atol=1e-5 * QN2)
    assert b(port).to_pandas()["id"].tolist() == b(ref).to_pandas()["id"].tolist()
    assert b(port).to_df().shape == b(ref).to_df().shape
    for out in ("to_table", "to_pyarrow"):
        _same_hits(getattr(b(port), out)(), getattr(b(ref), out)())
    assert [r["id"] for r in b(port).to_json()] == [r["id"] for r in b(ref).to_json()]
    assert b(port).to_reader(5).read_all().equals(b(port).to_arrow())
    assert b(port).output_schema() == b(ref).output_schema()
    assert len(list(b(port).to_batches(5))) == 3
    for make in (b, lambda t: t.query().where("id < 9").limit(3).offset(1),
                 lambda t: t.search("gamma", query_type="fts").limit(3),
                 lambda t: t.search((Q[0], "gamma"), query_type="hybrid").nprobes(3)):
        assert make(port).to_query_object() == make(ref).to_query_object()
    # vector(), column(), nearest_to(), with_row_address and order_by on a search
    s = lambda t: t.search(Q[5]).vector(Q[1]).column("vector").nprobes(4).limit(6)
    _same_hits(s(port).to_arrow(), s(ref).to_arrow())
    n = lambda t: t.query().where("category < 5").select(["id"]).nearest_to(Q[2]).limit(5)
    _same_hits(n(port).to_arrow(), n(ref).to_arrow())
    o = lambda t: t.search(Q[2]).nprobes(4).limit(8).order_by(("id", "desc")).with_row_address()
    got, want = o(port).to_arrow(), o(ref).to_arrow()
    assert got.column_names == want.column_names and got["id"].equals(want["id"])
    with pytest.raises(lancedb_tpu_torch.InvalidInputError):
        port.query().fragment_ids([0]).nearest_to(Q[0]).to_arrow()
    with pytest.raises(ValueError):
        port.search(Q[0]).limit(None)
    class Hit(pydantic.BaseModel):
        id: int
        category: int

    assert port.search(Q[0]).nprobes(4).limit(5).to_pydantic(Hit) == \
        ref.search(Q[0]).nprobes(4).limit(5).to_pydantic(Hit)


def test_nearest_to_text_and_fts_order_by(tmp_path):
    tbls = []
    for name, mod, kw in (("port", lancedb_tpu_torch, {"device": "cpu"}), ("ref", lancedb_tpu, {})):
        t = mod.connect(str(tmp_path / name), **kw).create_table("t", TABLE)
        t.create_fts_index("text")
        tbls.append(t)
    for make in (lambda t: t.query().where("category = 3").nearest_to_text("gamma").limit(5),
                 lambda t: t.search("alpha beta").limit(10).order_by("id")):
        got, want = make(tbls[0]).to_arrow(), make(tbls[1]).to_arrow()
        assert got["id"].equals(want["id"])
        np.testing.assert_allclose(np.asarray(got["_score"]), np.asarray(want["_score"]),
                                   rtol=1e-6)
    assert (tbls[0].search("gamma").limit(4).explain_plan()
            == tbls[1].search("gamma").limit(4).explain_plan())


# ----------------------------------------- 8. explain_plan, analyze_plan


PLANS = {
    "index_and_delta": lambda t: t.search(Q[0]).nprobes(4).limit(5),
    "prefilter_refine": lambda t: t.search(Q).nprobes(2).maximum_nprobes(6).refine_factor(3)
    .where("id < 1500").limit(5),
    "postfilter": lambda t: t.search(Q[1]).nprobes(4).where("category < 5").postfilter()
    .limit(5),
    "bypass": lambda t: t.search(Q[0]).bypass_vector_index().select(["id"]).limit(4),
    "fast_search": lambda t: t.search(Q[0]).nprobes(4).fast_search().limit(5),
    "scan": lambda t: t.query().where("id < 5").select(["id"]),
}


def _strip_metrics(plan: str) -> list[tuple[str, str]]:
    """Each line's text before its metrics, and its output_rows."""
    out = []
    for line in plan.splitlines():
        if line.startswith("elapsed_ms="):
            line = line.split(" ", 1)[1]  # output_rows, iops, bytes_read
        text, _, metrics = line.partition(", metrics=[")
        out.append((text, metrics.split(",")[0]))
    return out


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plans_match_reference(pair, case):
    """The reference's plan text with its one TPU word replaced ("MXU
    matmul scan" is "matmul scan"), and the same operators timed with the
    same output rows."""
    port, ref = pair
    for t in pair:
        t.add(_rows(np.arange(N, N + 40), X[:40] + 0.01, 4))
        t.delete("id = 3")
    want = PLANS[case](ref).explain_plan().replace("MXU matmul scan", "matmul scan")
    assert PLANS[case](port).explain_plan() == want
    if case == "scan":
        return
    got_a = PLANS[case](port).analyze_plan()
    want_a = PLANS[case](ref).analyze_plan().replace("MXU matmul scan", "matmul scan")
    assert _strip_metrics(got_a) == _strip_metrics(want_a)
    timed = [line for line in got_a.splitlines() if "elapsed_compute=" in line]
    assert timed and all("output_rows=" in line for line in timed)
    assert "metrics=[" not in PLANS[case](port).explain_plan()


# --------------------------------------------- 9. connection management


def test_connection_management_matches_reference(tmp_path):
    out = {}
    for name, mod, kw in (("port", lancedb_tpu_torch, {"device": "cpu"}), ("ref", lancedb_tpu, {})):
        with mod.connect(str(tmp_path / name), **kw) as db:
            db.create_table("a", TABLE.slice(0, 20))
            v = db["a"].version
            db["a"].add(TABLE.slice(20, 10))
            db.create_table("b", TABLE.slice(0, 5))
            db.rename_table("b", "c")
            db.clone_table("a", "d", version=v)
            db.open_table("a").tags.create("t1")
            db.clone_table("a", "e", tag="t1")
            rec = [db.table_names(), db.list_tables(), "a" in db, "b" in db, len(db),
                   db.table_exists("c"), db["d"].count_rows(), db["e"].count_rows()]
            db.drop_table("c")
            db.drop_table("c", ignore_missing=True)
            with pytest.raises(mod.errors.TableNotFoundError):
                db.drop_table("c")
            with pytest.raises(mod.errors.TableNotFoundError):
                db.rename_table("zz", "yy")
            with pytest.raises(mod.errors.TableAlreadyExistsError):
                db.rename_table("a", "d")
            rec.append(db.table_names())
            db.drop_all_tables()
            rec.append(db.table_names())
            db.create_table("f", TABLE.slice(0, 3))
            db.drop_database()
            rec += [db.table_names(), db.is_open()]
        rec.append(db.is_open())
        out[name] = rec
    assert out["port"] == out["ref"]
    assert out["port"][-2:] == [True, False]


def test_serialize_carries_the_device(tmp_path):
    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu", read_consistency_interval=0)
    doc = json.loads(db.serialize())
    assert doc["device"] == "cpu" and doc["read_consistency_interval_seconds"] == 0
    copy = lancedb_tpu_torch.deserialize_conn(db.serialize())
    assert copy.device == db.device and copy.read_consistency_interval == 0
    assert copy.uri == db.uri
    with pytest.raises(lancedb_tpu_torch.InvalidInputError, match="device"):
        lancedb_tpu_torch.deserialize_conn(json.dumps(_without(doc, "device")))
    doc["device"] = "cuda"
    if not torch.cuda.is_available():  # a card's connection stays on a card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lancedb_tpu_torch.deserialize_conn(json.dumps(doc))


# ----------------------------------------------- 10. read consistency


@pytest.mark.parametrize("interval", [None, 0])
def test_read_consistency_matches_reference(tmp_path, interval):
    out = {}
    for name, mod, kw in (("port", lancedb_tpu_torch, {"device": "cpu"}), ("ref", lancedb_tpu, {})):
        writer = mod.connect(str(tmp_path / name), **kw).create_table("t", TABLE)
        writer.create_index(index_type="IVF_FLAT", num_partitions=4, max_iterations=5)
        reader = mod.connect(str(tmp_path / name), read_consistency_interval=interval,
                             **kw).open_table("t")
        before = reader.search(Q[0]).nprobes(4).limit(3).to_arrow()
        writer.merge_insert("id").when_matched_update_all().execute(
            _rows(np.array([11]), Q[:1] + 0.001, 3))
        after = reader.search(Q[0]).nprobes(4).limit(3).to_arrow()
        out[name] = (reader.count_rows(), reader.version, np.asarray(before["id"]).tolist(),
                     np.asarray(after["id"]).tolist())
    assert out["port"] == out["ref"]
    assert (out["port"][3][0] == 11) == (interval == 0)


def test_background_refresher_reloads_and_stops(tmp_path):
    path = str(tmp_path)
    writer = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
    db = lancedb_tpu_torch.connect(path, device="cpu", read_consistency_interval=0.2)
    try:
        reader = db.open_table("t")
        thread = db._refresher._thread
        assert thread is not None and thread.daemon
        writer.delete("id < 10")
        deadline = time.monotonic() + 10
        while reader._Table__dataset.version != writer.version and time.monotonic() < deadline:
            time.sleep(0.05)
        assert reader._Table__dataset.version == writer.version
        assert reader.count_rows() == N - 10
    finally:
        db.close()
    thread.join(timeout=5)
    assert not thread.is_alive() and not db.is_open()


def test_concurrent_readers_and_a_writer(tmp_path):
    """More reader threads than cores search one interval-0 handle, the
    switch interval shortened, while a writer commits: every search returns
    ten duplicate-free hits, and the handle ends at the writer's rows."""
    path = str(tmp_path)
    writer = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
    writer.create_index(index_type="IVF_FLAT", num_partitions=4, max_iterations=5)
    table = lancedb_tpu_torch.connect(path, device="cpu", read_consistency_interval=0
                                      ).open_table("t")
    errors, stop = [], threading.Event()

    def read():
        try:
            while not stop.is_set():
                ids = np.asarray(table.search(Q[1]).nprobes(4).limit(10).to_arrow()["id"])
                assert len(ids) == 10 and len(np.unique(ids)) == 10
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=read, daemon=True)
               for _ in range(min(32, (os.cpu_count() or 4) + 1))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(5):
            writer.add(_rows(np.arange(N + 10 * i, N + 10 * i + 10), X[:10], 3))
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert table.count_rows() == N + 50


def test_writer_racing_readers_same_handle():
    """ROADMAP A0's scenario (tests/test_concurrency.py, same name) on the
    port: one writer and three readers share one handle at
    read_consistency_interval=0, the switch interval shortened. Every
    search returns its k hits, every filtered hit passes the filter, and
    nothing raises (the reference's check-then-read caches raised
    ``KeyError`` here, ROADMAP §C C2)."""
    rng = np.random.default_rng(1)
    db = lancedb_tpu_torch.connect("memory://conc-w", device="cpu", read_consistency_interval=0)
    t = db.create_table("w", [
        {"id": i, "cat": i % 5, "vector": list(rng.standard_normal(8).astype(float))}
        for i in range(500)
    ], mode="overwrite")
    t.create_index(index_type="IVF_FLAT", num_partitions=4)
    errs, stop = [], threading.Event()

    def writer():
        wrng = np.random.default_rng(100)
        try:
            nxt = 500
            while not stop.is_set():
                t.add([{"id": nxt + j, "cat": (nxt + j) % 5,
                        "vector": list(wrng.standard_normal(8).astype(float))} for j in range(25)])
                nxt += 25
        except Exception as e:  # reported below
            errs.append(("writer", repr(e)))

    def reader(wid):
        rrng = np.random.default_rng(200 + wid)
        try:
            for _ in range(8):
                q = rrng.standard_normal(8).astype(np.float32)
                assert len(t.search(q).limit(5).to_list()) == 5
                r = t.search(q).where("cat = 1").limit(3).to_list()
                assert all(x["cat"] == 1 for x in r)
        except Exception as e:  # reported below
            errs.append((wid, repr(e)))

    w = threading.Thread(target=writer)
    rs = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        w.start()
        for r in rs:
            r.start()
        for r in rs:
            r.join(timeout=120)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    w.join(timeout=60)
    assert not any(th.is_alive() for th in [w, *rs])
    assert not errs, errs[:3]
    assert t.count_rows() >= 500


@pytest.mark.parametrize("source", ["generator", "reader", "dataset", "table"])
def test_add_streams_and_reports_progress(plain_pair, source):
    """add() of a batch stream appends in one commit, reporting the
    reference's progress dicts; the rows are the reference's."""
    import pyarrow.dataset as pads

    extra = _rows(np.arange(N, N + 300), X[:300], 12).combine_chunks()

    def data():
        if source == "generator":
            return (b for b in extra.to_batches(max_chunksize=100))
        if source == "reader":
            return pa.RecordBatchReader.from_batches(extra.schema, extra.to_batches(100))
        return pads.dataset(extra) if source == "dataset" else extra

    events = []
    for t in plain_pair:
        seen = []
        t.add(data(), progress=seen.append)
        events.append([_without(e, "elapsed_seconds") for e in seen])
    assert events[0] == events[1] and events[0][-1]["done"]
    assert events[0][-1]["output_rows"] == 300
    assert plain_pair[0].list_versions()[-1]["version"] == plain_pair[1].version
    _same_rows(plain_pair[0].to_arrow(), plain_pair[1].to_arrow())


def test_table_identity_and_storage_options(tmp_path):
    calls = []
    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu", storage_options={"a": "1"},
                                   storage_options_provider=lambda: calls.append(1) or {"b": "2"})
    t = lancedb_tpu_torch.Table.create(db, "t", TABLE.slice(0, 10))
    assert lancedb_tpu_torch.Table.open(db, "t").count_rows() == 10
    assert (t.namespace, t.id) == ([], "t")
    assert t.initial_storage_options() == {"a": "1"}
    assert t.latest_storage_options() == {"a": "1", "b": "2"} and calls == [1]
    t.prewarm_data()
    assert t.migrate_v2_manifest_paths() is None


def test_dataset_caches_survive_a_concurrent_clear(plain_pair):
    """A refresh on another thread may clear the dataset's reader and
    deletion caches between a reader's lookup and its use; a lookup must
    then still return what it found (it raised KeyError when it tested
    membership, then indexed)."""
    port, _ = plain_pair
    port.delete("id < 3")
    ds = port._dataset

    class ClearedAfterLookup(dict):
        def __contains__(self, key):
            found = super().__contains__(key)
            self.clear()
            return found

        def get(self, key, default=None):
            found = super().get(key, default)
            self.clear()
            return found

    meta = ds.manifest.fragments[0]
    ds.reader(meta.id)
    ds._readers = ClearedAfterLookup(ds._readers)
    assert ds.reader(meta.id).meta.id == meta.id
    keep = ds._keep_mask(meta)
    ds._deletion_cache = ClearedAfterLookup(ds._deletion_cache)
    np.testing.assert_array_equal(ds._keep_mask(meta), keep)
    assert not keep[:3].any() and keep[3:].all()
