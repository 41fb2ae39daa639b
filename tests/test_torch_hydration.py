"""Hydration of a vector search's results in lancedb_tpu_torch (device="cpu"):
one ``Dataset.take_rows`` over every query's rows, on the fragment path
(the resident copy capped to nothing) and through the resident copy.

Each case's hydrated table equals, column for column and row for row, the
per-query algorithm: one take a query, its columns appended, the parts
concatenated. The final result matches lancedb_tpu's on the same table and
index: the same ids and query_index in the same order, distances to rtol
1e-5 (atol 1e-5 relative to |q|²). The table has a row deleted after its
index build, the nearest row of the first query. A batch call makes one
take and one ``lancedb.hydrate.takes``, and decides the resident copy in
its first call of 8 or more queries.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu_torch import metrics
from lancedb_tpu_torch import query as port_query
from lancedb_tpu_torch.storage.dataset import ROW_ID_COL

N, DIM, PARTS = 2000, 32, 8
CAP = "LANCEDB_TPU_HYDRATION_CACHE_BYTES"
FAR = np.full(DIM, 50.0, np.float32)  # nearer no row than distance_range's bound


def _data(seed=11):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((24, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 24, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    ids = np.arange(N, dtype=np.int64)
    tbl = pa.table({
        "id": ids, "category": ids % 10,
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM),
    })
    # near copies of 8 rows, each twice: the two copies' result sets share rows
    near = x[rng.choice(N, 8, replace=False)] + 0.01 * rng.standard_normal((8, DIM))
    q = np.concatenate([near, near[::-1] + 0.001]).astype(np.float32)
    return tbl, x, q


TABLE, X, Q = _data()
DELETED = int(np.argmin(((X - Q[0]) ** 2).sum(1)))
Q_RANGE = np.concatenate([Q[:7], FAR[None]])

CASES = {
    "shared_refined": lambda t: t.search(Q).nprobes(4).refine_factor(4).limit(10),
    "prefilter_short": lambda t: t.search(Q).nprobes(2).limit(10).where("id < 8"),
    "range_empty": lambda t: t.search(Q_RANGE).nprobes(4).refine_factor(4).limit(10)
    .distance_range(upper_bound=1.0),
    "with_row_id": lambda t: t.search(Q).nprobes(4).limit(10).with_row_id(True),
    "select_list": lambda t: t.search(Q).nprobes(4).limit(10).select(["id", "category"]),
    "select_dict": lambda t: t.search(Q).nprobes(4).limit(10).select(
        {"id": "id", "twice": "id * 2", "cat1": "category + 1"}),
    "offset": lambda t: t.search(Q).nprobes(4).refine_factor(4).limit(5).offset(3),
    "single": lambda t: t.search(Q[1]).nprobes(4).limit(10),
}


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    """A reference-built table with IVF_PQ on ``vector``; one row deleted
    after the build."""
    path = str(tmp_path_factory.mktemp("hydration"))
    t = lancedb_tpu.connect(path).create_table("t", TABLE)
    t.create_index(config=RefIvfPq(num_partitions=PARTS, num_sub_vectors=8, max_iterations=10))
    t.delete(f"id = {DELETED}")
    return path


def _port(path):
    """A fresh handle: its dataset holds no resident copy yet."""
    return lancedb_tpu_torch.connect(path, device="cpu").open_table("t")


def _per_query(table, req, dists, rowids, multi) -> pa.Table:
    """The oracle: one take a query, its columns appended, then one concat."""
    parts = []
    for qi in range(dists.shape[0]):
        valid = rowids[qi] != port_query._INVALID_ROWID
        rid = rowids[qi][valid]
        data = table._dataset.take_rows(rid, columns=port_query._selected_columns(req))
        if isinstance(req.select, dict):
            data = port_query._project(data, req.select)
        data = data.append_column("_distance", pa.array(dists[qi][valid].astype(np.float32)))
        if req.with_row_id:
            data = data.append_column(ROW_ID_COL, pa.array(rid, type=pa.uint64()))
        if multi:
            data = data.append_column(
                "query_index", pa.array(np.full(len(rid), qi, dtype=np.int32)))
        parts.append(data)
    return pa.concat_tables(parts)


@pytest.fixture
def captured(monkeypatch):
    """Each hydration's arguments and result."""
    calls = []
    real = port_query._hydrate_results

    def spy(table, req, dists, rowids, multi):
        out = real(table, req, dists, rowids, multi)
        calls.append((table, req, dists.copy(), rowids.copy(), multi, out))
        return out

    monkeypatch.setattr(port_query, "_hydrate_results", spy)
    return calls


def _warm_resident(port, case):
    """Searches until the projection's resident copy is built (a call of 8
    or more queries builds it at once; single queries take 8 calls)."""
    for _ in range(8):
        CASES[case](port).to_arrow()
        if any(v != "skip" for v in port._dataset._hydration_cache.values()):
            return
    raise AssertionError("no resident copy after 8 calls")


def _assert_matches_reference(got: pa.Table, want: pa.Table, queries: np.ndarray):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for col in ("id", "query_index", "twice", "cat1", "category"):
        if col in want.column_names:
            np.testing.assert_array_equal(np.asarray(got[col]), np.asarray(want[col]), col)
    atol = 1e-5 * float(np.max((queries.astype(np.float64) ** 2).sum(1)))
    np.testing.assert_allclose(np.asarray(got["_distance"]), np.asarray(want["_distance"]),
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("path", ["fragments", "resident"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_take_equals_the_per_query_takes(table_path, captured, monkeypatch, case, path):
    if path == "fragments":
        monkeypatch.setenv(CAP, "0")
    port = _port(table_path)
    if path == "resident":
        _warm_resident(port, case)
    captured.clear()
    metrics.span_records(clear=True)
    with metrics.tracing():
        got = CASES[case](port).to_arrow()
    takes = [r for r in metrics.span_records(clear=True) if r.name == "dataset.take_rows"]
    (table, req, dists, rowids, multi, out), = captured
    assert len(takes) == 1 and takes[0].attrs["path"] == path

    want = _per_query(table, req, dists, rowids, multi)
    assert out.schema == want.schema
    assert out.equals(want)
    nq = len(req.query_vectors) if multi else 0
    assert got.equals(port_query._postfilter_and_offset(want, req, nq))

    # the case reaches what it is named for
    valid = rowids != port_query._INVALID_ROWID
    assert DELETED not in set(np.asarray(out["id"] if "id" in out.column_names else []))
    if case == "shared_refined":
        flat = rowids[valid]
        assert len(np.unique(flat)) < len(flat)  # rows shared across queries
    if case == "prefilter_short":
        assert valid.sum(1).min() < req.k
    if case == "range_empty":
        assert valid.sum(1).min() == 0 and valid.sum(1).max() > 0
    if case == "with_row_id":
        np.testing.assert_array_equal(np.asarray(out[ROW_ID_COL]), rowids[valid])

    ref = lancedb_tpu.connect(table_path).open_table("t")
    queries = np.stack([np.asarray(v, np.float32).reshape(-1) for v in req.query_vectors])
    _assert_matches_reference(got, CASES[case](ref).to_arrow(), queries)


def test_a_batch_call_makes_one_take(tmp_path, monkeypatch):
    """64 queries over two fragments, past the resident copy: one take span,
    one ``lancedb.hydrate.takes``, one fragment read a fragment touched."""
    monkeypatch.setenv(CAP, "0")
    port = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    port.create_index(metric="l2", num_partitions=PARTS, num_sub_vectors=8, num_bits=8,
                      max_iterations=4, sample_rate=64)
    port.add(TABLE.slice(0, 200).set_column(0, "id", pa.array(np.arange(N, N + 200))))
    queries = np.concatenate([X[:32], X[:32] + 0.01])
    totals = metrics.counter_totals
    t0, f0 = totals["lancedb.hydrate.takes"], totals["lancedb.hydrate.fragment_reads"]
    metrics.span_records(clear=True)
    with metrics.tracing():
        out = port.search(queries).nprobes(4).limit(10).with_row_id(True).to_arrow()
    recs = metrics.span_records(clear=True)
    frags = np.unique(np.asarray(out[ROW_ID_COL]) >> np.uint64(32))
    assert len(frags) == 2  # the first 32 rows have copies in the added fragment
    takes = [r for r in recs if r.name == "dataset.take_rows"]
    assert len(takes) == 1
    assert takes[0].attrs["path"] == "fragments" and takes[0].attrs["fragments"] == 2
    assert [r.attrs["queries"] for r in recs if r.name == "query.hydrate"] == [64]
    assert totals["lancedb.hydrate.takes"] - t0 == 1
    assert totals["lancedb.hydrate.fragment_reads"] - f0 == len(frags)


@pytest.mark.parametrize("cap", [None, "0"])
def test_the_first_call_of_8_queries_decides_the_resident_copy(table_path, monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv(CAP, cap)
    port = _port(table_path)
    ds = port._dataset
    key = (ds.version, ds.branch, None)
    port.search(Q[:7]).nprobes(4).limit(10).to_arrow()
    assert key not in ds._hydration_cache  # 7 lookups: not yet
    port.search(Q[:1]).nprobes(4).limit(10).to_arrow()
    assert key in ds._hydration_cache  # the 8th
    port = _port(table_path)
    ds = port._dataset
    port.search(Q[:8]).nprobes(4).limit(10).to_arrow()
    ent = ds._hydration_cache.get(key)
    if cap == "0":
        assert ent == "skip"
    else:
        rid_sorted, tbl = ent
        assert tbl.num_rows == len(rid_sorted) == N - 1


def test_takes_that_meet_the_resident_copy_being_read_do_not_read_it_too(table_path,
                                                                         monkeypatch):
    """A hybrid call's full-text legs take rows on 8 threads at once. The
    take that crosses the 8th lookup reads the projection for the resident
    copy; takes on other threads meanwhile read the fragments and return,
    and no second thread reads the projection (at 1M x 1536 one read is
    6.4 GB)."""
    ds = _port(table_path)._dataset
    reads, started, release = [], threading.Event(), threading.Event()
    real = ds._resident_copy

    def slow_copy(columns):
        reads.append(threading.get_ident())
        started.set()
        assert release.wait(30)
        return real(columns)

    monkeypatch.setattr(ds, "_resident_copy", slow_copy)
    rid = ds.to_table(columns=["id"], with_row_id=True).column(ROW_ID_COL).to_numpy()
    rid = rid.astype(np.uint64)
    want = [np.asarray(ds.take_rows(rid[i:i + 10], columns=["id"])["id"]) for i in range(0, 70, 10)]
    assert not reads  # 7 lookups: not yet
    first = threading.Thread(target=ds.take_rows, args=(rid[:10], ["id"]))
    first.start()
    assert started.wait(30)
    got = {}

    def take(i):
        got[i] = np.asarray(ds.take_rows(rid[i * 10:i * 10 + 10], columns=["id"])["id"])

    others = [threading.Thread(target=take, args=(i,)) for i in range(7)]
    for th in others:
        th.start()
    for th in others:
        th.join(5)
    assert all(not th.is_alive() for th in others)  # none waited for the read
    release.set()
    first.join(30)
    assert len(reads) == 1
    assert all(np.array_equal(got[i], want[i]) for i in range(7))
    key = (ds.version, ds.branch, ("id",))
    assert ds._hydration_cache[key][1].num_rows == N - 1
