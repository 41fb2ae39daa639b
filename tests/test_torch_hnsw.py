"""HNSW (IVF_HNSW_FLAT / _SQ / _PQ): lancedb_tpu_torch (device="cpu")
against lancedb_tpu.

The build primitives take the same inputs in both packages and must give
the same arrays; where a row differs it must be an f32 near-tie (the kNN
distances agree to rtol 1e-5), and such rows are counted and bounded
(at most 1 % of rows). Searches of one shared, reference-built index
must give the same row ids apart from distance ties (|Δ| <= 1e-5
relative) and distances to rtol 1e-5, through the host walk and through
the device beam, with a filter and after a delete. A graph the port
built is served by the reference within 0.02 recall@10 of the port.
"""

import shutil

import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import HnswFlat as RefHnswFlat
from lancedb_tpu.index import HnswPq as RefHnswPq
from lancedb_tpu.index import HnswSq as RefHnswSq
from lancedb_tpu.index import hnsw as ref_hnsw
from lancedb_tpu_torch.index import HnswFlat, HnswPq, HnswSq
from lancedb_tpu_torch.index import hnsw as port_hnsw

N, DIM, K = 1200, 24, 10
NQ_BEAM, NQ_HOST = 32, 8  # 16 or more queries take the device beam
_RNG = np.random.default_rng(17)
X = _RNG.standard_normal((N, DIM)).astype(np.float32)
Q = _RNG.standard_normal((NQ_BEAM, DIM)).astype(np.float32)
TABLE = pa.table({
    "id": np.arange(N, dtype=np.int64),
    "vector": pa.FixedSizeListArray.from_arrays(pa.array(X.ravel()), DIM),
})
REF_CONFIGS = {
    "FLAT": RefHnswFlat(m=12), "SQ": RefHnswSq(m=12), "PQ": RefHnswPq(m=12, num_sub_vectors=6),
}
CPU = torch.device("cpu")


def _differing_rows(got: np.ndarray, want: np.ndarray, limit: float = 0.01) -> np.ndarray:
    assert got.shape == want.shape
    rows = np.nonzero((got != want).any(axis=1))[0]
    assert len(rows) <= limit * len(want), (len(rows), len(want))
    return rows


@pytest.mark.parametrize("n,dim,metric", [(1500, 16, "l2"), (1500, 16, "dot"), (8300, 4, "l2")])
def test_build_primitives_match_reference(n, dim, metric):
    """kNN on both branches (one exact pass at 8192 rows or fewer, the
    bf16 coarse scan and f32 rescore above); at 1500 rows l2 also the
    prune, the 2-hop pool, the second prune and the adjacency with
    reverse edges, each fed the reference's previous stage."""
    import jax.numpy as jnp

    v = np.random.default_rng(n + dim).standard_normal((n, dim)).astype(np.float32)
    rb, pb = ref_hnsw._DeviceBase(v), port_hnsw._DeviceBase(v, CPU)
    want = np.array(ref_hnsw._knn_all_device(rb, 40, metric))[:n]
    got = port_hnsw._knn_all_device(pb, 40, metric).numpy()
    for r in _differing_rows(got, want):
        d_row = -(v @ v[r]) if metric == "dot" else ((v - v[r]) ** 2).sum(-1)
        np.testing.assert_allclose(np.sort(d_row[got[r]]), np.sort(d_row[want[r]]), rtol=1e-5)
    if metric == "dot" or n > 8192:
        return

    def padded(a):  # the reference scans whole blocks of rows
        return jnp.asarray(np.pad(a, ((0, rb.pad_n - n), (0, 0))))

    stages = {}
    local = np.array(ref_hnsw._prune_all_device(rb, padded(want), 20))[:n]
    stages["prune"] = (port_hnsw._prune_all_device(pb, torch.from_numpy(want), 20), local)
    pool = np.array(ref_hnsw._hop2_pool_device(jnp.asarray(want), jnp.asarray(local), 8))
    stages["hop2"] = (port_hnsw._hop2_pool_device(torch.from_numpy(want),
                                                  torch.from_numpy(local).long(), 8), pool)
    local2 = np.array(ref_hnsw._prune_all_device(rb, padded(pool), 20))[:n]
    stages["prune2"] = (port_hnsw._prune_all_device(pb, torch.from_numpy(pool).long(), 20),
                        local2)
    adj = np.asarray(ref_hnsw._dense_adjacency_device(jnp.asarray(local2), n, 20))
    stages["adjacency"] = (port_hnsw._dense_adjacency_device(torch.from_numpy(local2).long(),
                                                             n, 20), adj)
    for name, (got_s, want_s) in stages.items():
        _differing_rows(got_s.numpy(), want_s)
    # the adjacency's reverse edges: two sources of one column that share
    # a target keep the larger source id in both packages
    assert np.array_equal(stages["adjacency"][0].numpy(), adj)


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """One reference-built index per storage kind, built on first use."""
    built = {}

    def get(kind):
        if kind not in built:
            path = str(tmp_path_factory.mktemp(f"ref_hnsw_{kind}"))
            lancedb_tpu.connect(path).create_table("t", TABLE).create_index(
                config=REF_CONFIGS[kind])
            built[kind] = path
        return built[kind]

    return get


def _search(tbl, nq, where=None, ef=64):
    s = tbl.search(Q[:nq]).ef(ef).limit(K)
    if where:
        s = s.where(where)
    out = s.to_arrow()
    qi = np.asarray(out["query_index"])
    return [(np.asarray(out["id"])[qi == i], np.asarray(out["_distance"])[qi == i])
            for i in range(nq)]


def _assert_same(got, want):
    for (gi, gd), (wi, wd) in zip(got, want):
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
        for j in np.nonzero(gi != wi)[0]:
            tie = np.abs(wd - wd[j]) <= 1e-5 * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, gd, wd)


def _recall(results, nq):
    gt = np.argsort(((Q[:nq, None] - X[None]) ** 2).sum(-1), axis=1)[:, :K]
    return float(np.mean([len(set(ids) & set(g)) / K for (ids, _), g in zip(results, gt)]))


@pytest.mark.parametrize("nq", [NQ_HOST, NQ_BEAM], ids=["host_walk", "device_beam"])
@pytest.mark.parametrize("kind", ["FLAT", "SQ", "PQ"])
def test_reference_index_served_by_port(ref_index, kind, nq):
    """The port serves the reference's graph with the reference's results:
    plain, filtered, and after a delete (PQ is served by the host walk at
    any batch size, in both packages)."""
    path = ref_index(kind)
    ref = lancedb_tpu.connect(path).open_table("t")
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    searcher = port._get_searcher(port._dataset.manifest.indices[0])
    assert isinstance(searcher, port_hnsw.HnswSearcher)
    before = dict(port_hnsw.device_runs)
    _assert_same(_search(port, nq), _search(ref, nq))
    _assert_same(_search(port, nq, "id % 3 = 0"), _search(ref, nq, "id % 3 = 0"))
    assert all(np.all(ids % 3 == 0) for ids, _ in _search(port, nq, "id % 3 = 0"))
    assert dict(port_hnsw.device_runs) == before  # nothing ran on a card


@pytest.mark.parametrize("kind", ["FLAT", "SQ", "PQ"])
def test_search_after_delete_matches_reference(ref_index, tmp_path, kind):
    path = str(tmp_path / "db")
    shutil.copytree(ref_index(kind), path)
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    assert port.delete("id % 4 = 1") == N // 4
    ref = lancedb_tpu.connect(path).open_table("t")
    for nq in (NQ_HOST, NQ_BEAM):
        got = _search(port, nq, ef=128)
        _assert_same(got, _search(ref, nq, ef=128))
        assert not any(np.any(ids % 4 == 1) for ids, _ in got)


@pytest.mark.parametrize("kind,cls", [("FLAT", HnswFlat), ("SQ", HnswSq), ("PQ", HnswPq)])
def test_port_graph_served_by_reference(ref_index, tmp_path, kind, cls):
    """The port writes the reference's dense_v2 files: the reference loads
    the port's graph and reaches the port's recall within 0.02, through
    both routes, and the port's build reaches the reference build's
    recall less 0.02 on the same table (PQ storage trains its codebooks
    from the reference's draws)."""
    path = str(tmp_path)
    port = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
    port.create_index(config=cls(m=12, **({"num_sub_vectors": 6} if kind == "PQ" else {})))
    ref = lancedb_tpu.connect(path).open_table("t")
    assert ref.list_indices()[0]["index_type"] == cls.index_type
    ref_built = lancedb_tpu.connect(ref_index(kind)).open_table("t")
    for nq in (NQ_HOST, NQ_BEAM):
        r_port = _recall(_search(port, nq), nq)
        assert _recall(_search(ref, nq), nq) >= r_port - 0.02
        assert r_port >= _recall(_search(ref_built, nq), nq) - 0.02


def test_index_types_by_name_and_build_timings(tmp_path):
    """create_index(index_type=...) builds each IVF_HNSW type; the build
    records the reference's stage names."""
    tbl = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE[:400])
    for it in ("IVF_HNSW_SQ", "IVF_HNSW_PQ", "IVF_HNSW_FLAT"):
        tbl.create_index(index_type=it, num_sub_vectors=6)
        meta = tbl._dataset.manifest.indices[0]
        assert meta.index_type == it
        assert {"knn_l0", "prune_l0", "adjacency_l0"} <= set(meta.params["build_timings"])
        out = tbl.search(X[11] + 0.01).ef(32).limit(1).to_arrow()
        assert out["id"][0].as_py() == 11
