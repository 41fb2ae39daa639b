"""Hybrid search end to end: lancedb_tpu_torch (device="cpu") against
lancedb_tpu through the public API, on IVF_PQ + FTS indexes built by each
package and searched by both.

The vector leg is the IVF_PQ searcher; its distances come from two
implementations that sum in other orders, so they are held to 1e-5 of
the largest distance (RTOL). The fused outputs (RRF, linear combination,
MRR) must give the reference's row ids exactly, single and
add_query-batched, with and without a filter, and with the filter served
by a BITMAP index or by the scan. RRF and MRR relevance depends on ranks
only and is held to 1e-6; linear combination's depends on the min-max
normalised distances, so its bound is 1e-6 plus what RTOL moves it by.
"""

import shutil

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.rerankers as ref_r
import lancedb_tpu_torch
import lancedb_tpu_torch.rerankers as port_r
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu_torch.index import IvfPq

N, DIM, NQ, K = 2000, 16, 6, 10
NQ_SINGLE = 2  # pairs run one call each (the batched form runs all NQ)
RTOL = 1e-5
WEIGHT = 0.6  # the linear combination's vector weight
PKGS = ("ref", "port")


def _data():
    rng = np.random.default_rng(21)
    cent = rng.standard_normal((24, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 24, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    ranks = np.clip(rng.zipf(1.3, size=N * 8), 1, 300) - 1
    text = [" ".join(r) for r in np.char.add("w", ranks.astype("U4")).reshape(N, 8)]
    ids = np.arange(N, dtype=np.int64)
    q = x[rng.integers(0, N, NQ)] + 0.3 * rng.standard_normal((NQ, DIM)).astype(np.float32)
    texts = [f"w{a} w{a + 3}" for a in rng.integers(0, 40, NQ)]
    tbl = pa.table({"id": ids, "category": ids % 10, "text": text,
                    "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM)})
    return tbl, q, texts


TABLE, QV, QT = _data()


def _connect(pkg, path):
    if pkg == "port":
        return lancedb_tpu_torch.connect(path, device="cpu")
    return lancedb_tpu.connect(path)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Per building package: IVF_PQ + FTS, and a copy with a BITMAP index
    on category as well."""
    out = {}
    for pkg in PKGS:
        path = str(tmp_path_factory.mktemp(f"hybrid_{pkg}"))
        t = _connect(pkg, path).create_table("h", TABLE)
        cls = IvfPq if pkg == "port" else RefIvfPq
        t.create_index(config=cls(num_partitions=8, num_sub_vectors=4, num_bits=8,
                                  max_iterations=10))
        t.create_fts_index("text", with_position=False)
        indexed = path + "_bitmap"
        shutil.copytree(path, indexed)
        _connect(pkg, indexed).open_table("h").create_scalar_index("category",
                                                                   index_type="BITMAP")
        out[pkg] = {"scan": path, "bitmap": indexed}
    return out


RERANKERS = {
    "rrf": lambda m: m.RRFReranker(),
    "linear": lambda m: m.LinearCombinationReranker(weight=WEIGHT),
    "mrr": lambda m: m.MRRReranker(),
}


def _hybrid(tbl, rerank_mod, reranker, mode, where):
    if mode == "single":
        outs = []
        for i in range(NQ_SINGLE):
            b = tbl.search((QV[i], QT[i]), query_type="hybrid").limit(K).with_row_id()
            b = b.where(where) if where else b
            out = b.rerank(RERANKERS[reranker](rerank_mod)).to_arrow()
            outs.append(out.append_column("query_index", pa.array(np.full(out.num_rows, i,
                                                                          np.int32))))
        return pa.concat_tables(outs)
    b = tbl.search((QV[0], QT[0]), query_type="hybrid").limit(K).with_row_id()
    for i in range(1, NQ):
        b.add_query(QV[i], QT[i])
    b = b.where(where) if where else b
    return b.rerank(RERANKERS[reranker](rerank_mod)).to_arrow()


def _linear_atol(tbl, where) -> float:
    """1e-6 plus the most that distances off by RTOL of their largest move
    WEIGHT * (1 - (d - min) / (max - min)): three such terms over the
    query's spread of distances."""
    b = tbl.search(QV).limit(K)
    legs = (b.where(where) if where else b).to_arrow()
    worst = 0.0
    for i in range(NQ):
        d = np.asarray(legs["_distance"])[np.asarray(legs["query_index"]) == i]
        if len(d) > 1 and d.max() > d.min():
            worst = max(worst, 3 * WEIGHT * RTOL * np.abs(d).max() / (d.max() - d.min()))
    return 1e-6 + worst


def _assert_same(got, want, atol=1e-6):
    assert got.column_names == want.column_names
    assert np.array_equal(got["_rowid"], want["_rowid"])
    np.testing.assert_allclose(got["_relevance_score"], want["_relevance_score"], rtol=0,
                               atol=atol)
    rest = [c for c in got.column_names if c != "_relevance_score"]
    assert got.select(rest).equals(want.select(rest))


@pytest.mark.parametrize("filt", ["none", "scan", "bitmap"])
@pytest.mark.parametrize("mode", ["single", "batched"])
@pytest.mark.parametrize("reranker", list(RERANKERS))
@pytest.mark.parametrize("builder", PKGS)
def test_hybrid_matches_reference(dbs, builder, reranker, mode, filt):
    path = dbs[builder]["bitmap" if filt == "bitmap" else "scan"]
    where = None if filt == "none" else "category = 3"
    ref = _connect("ref", path).open_table("h")
    port = _connect("port", path).open_table("h")
    want = _hybrid(ref, ref_r, reranker, mode, where)
    got = _hybrid(port, port_r, reranker, mode, where)
    assert want.num_rows >= (NQ_SINGLE if mode == "single" else NQ) * K // 2
    _assert_same(got, want, _linear_atol(ref, where) if reranker == "linear" else 1e-6)
    if where:
        assert set(got["category"].to_pylist()) == {3}
    if filt == "bitmap":  # the index serves both legs and changes nothing
        scan = _connect("port", dbs[builder]["scan"]).open_table("h")
        assert got.equals(_hybrid(scan, port_r, reranker, mode, where))


@pytest.mark.parametrize("builder", PKGS)
def test_legs_match_reference(dbs, builder):
    """Each leg alone: the vector leg's ids and distances (RTOL of the
    largest), the FTS leg's ids and scores, and the default reranker (RRF)."""
    ref = _connect("ref", dbs[builder]["scan"]).open_table("h")
    port = _connect("port", dbs[builder]["scan"]).open_table("h")
    want = ref.search(QV).limit(K).with_row_id().to_arrow()
    got = port.search(QV).limit(K).with_row_id().to_arrow()
    assert np.array_equal(got["_rowid"], want["_rowid"])
    d = np.asarray(want["_distance"])
    np.testing.assert_allclose(got["_distance"], d, rtol=0, atol=RTOL * np.abs(d).max())
    for text in QT:
        w = ref.search(text, query_type="fts").limit(K).with_row_id().to_arrow()
        g = port.search(text, query_type="fts").limit(K).with_row_id().to_arrow()
        assert g.equals(w)
    _assert_same(port.search((QV[0], QT[0])).limit(K).with_row_id().to_arrow(),
                 ref.search((QV[0], QT[0])).limit(K).with_row_id().to_arrow())
