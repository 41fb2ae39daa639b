"""The slice as a whole: IVF_PQ build and filtered, refined search through
connect(), lancedb_tpu_torch (device="cpu") against lancedb_tpu.

Searches are compared exactly on one shared index: the same row ids
apart from distance ties (|Δ| <= 1e-5 relative), and distances to rtol
1e-5. Builds are compared by recall (the packages draw the same
k-means++ bits, but sum in other orders, so a near-tie can take another
branch), and by cross-loading: each package searches the index the
other one built.
"""

import shutil

import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu_torch.index import IvfPq

N, DIM, NQ, K = 3000, 32, 16, 10
PARTS, NSUB, NPROBES = 16, 8, 4


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((48, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 48, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (cent[rng.integers(0, 48, NQ)] + rng.standard_normal((NQ, DIM))).astype(np.float32)
    ids = np.arange(N, dtype=np.int64)
    tbl = pa.table({
        "id": ids,
        "category": ids % 10,
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM),
    })
    return tbl, x, q


TABLE, X, Q = _data()


def _config(cls, metric, bits):
    return cls(distance_type=metric, num_partitions=PARTS, num_sub_vectors=NSUB, num_bits=bits,
               max_iterations=10)


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """One reference-built index per (metric, num_bits), built on first use."""
    built = {}

    def get(metric, bits):
        if (metric, bits) not in built:
            path = str(tmp_path_factory.mktemp(f"ref_{metric}_{bits}"))
            t = lancedb_tpu.connect(path).create_table("t", TABLE)
            t.create_index(config=_config(RefIvfPq, metric, bits))
            built[(metric, bits)] = path
        return built[(metric, bits)]

    return get


def _search(tbl, where=None, refine=None):
    s = tbl.search(Q).nprobes(NPROBES).limit(K)
    if where:
        s = s.where(where)
    if refine:
        s = s.refine_factor(refine)
    out = s.to_arrow()
    qi = np.asarray(out["query_index"])
    return [(np.asarray(out["id"])[qi == i], np.asarray(out["_distance"])[qi == i])
            for i in range(NQ)]


def _assert_same(got, want):
    for (gi, gd), (wi, wd) in zip(got, want):
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
        for j in np.nonzero(gi != wi)[0]:
            # a different id only where the distance ties another hit, or
            # at the cut, where its tie partner fell off the list
            tie = np.abs(wd - wd[j]) <= 1e-5 * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, gd, wd)


def _recall(results, where=None):
    d = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    if where is not None:
        d[:, np.arange(N) % 10 >= 5] = np.inf
    gt = np.argsort(d, axis=1)[:, :K]
    return float(np.mean([len(set(ids) & set(g)) / K for (ids, _), g in zip(results, gt)]))


@pytest.mark.parametrize("refine", [None, 10])
@pytest.mark.parametrize("where", [None, "category < 5"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_search_matches_reference(ref_index, metric, bits, where, refine):
    path = ref_index(metric, bits)
    want = _search(lancedb_tpu.connect(path).open_table("t"), where, refine)
    got = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"), where, refine)
    _assert_same(got, want)
    if where is not None:
        hits = np.concatenate([ids for ids, _ in got])
        assert len(hits) and np.all(hits % 10 < 5)


@pytest.mark.parametrize("refine", [None, 10])
def test_search_after_delete_matches_reference(tmp_path, refine):
    path = str(tmp_path)
    lancedb_tpu.connect(path).create_table("t", TABLE).create_index(
        config=_config(RefIvfPq, "l2", 8)
    )
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    assert port.delete("id % 3 = 0") == N // 3
    assert port.count_rows() == N - N // 3
    got = _search(port, refine=refine)
    want = _search(lancedb_tpu.connect(path).open_table("t"), refine=refine)
    _assert_same(got, want)
    assert not np.any(np.concatenate([ids for ids, _ in got]) % 3 == 0)


def test_f16_residual_refine_matches_reference(ref_index, monkeypatch):
    """Above the f32 budget the fused refine stores f16 residuals against
    each slot's block centroid, in both packages."""
    monkeypatch.setenv("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", "0")
    path = ref_index("l2", 8)
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    got = _search(port, "category < 5", 10)
    searcher = port._get_searcher(port._dataset.manifest.indices[0])
    assert searcher._device["refine_vecs"].dtype == torch.float16
    _assert_same(got, _search(lancedb_tpu.connect(path).open_table("t"), "category < 5", 10))


def test_opq_index_from_reference(tmp_path):
    """The port searches an OPQ index (rotated residual codes) that the
    reference built; test_torch_capacity.py holds the port's own OPQ
    builds to the reference's."""
    path = str(tmp_path)
    cfg = RefIvfPq(num_partitions=PARTS, num_sub_vectors=NSUB, opq=True, opq_iters=1,
                   max_iterations=5)
    lancedb_tpu.connect(path).create_table("t", TABLE).create_index(config=cfg)
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    _assert_same(_search(port), _search(lancedb_tpu.connect(path).open_table("t")))


def test_edge_cases_match_reference(ref_index, tmp_path):
    """nprobes beyond the partition count clamps in both; an invalid
    num_bits is refused by both before any work."""
    path = ref_index("l2", 4)
    ref = lancedb_tpu.connect(path).open_table("t")
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    for tbl in (ref, port):
        assert tbl.count_rows() == N
    got = port.search(Q[0]).nprobes(10_000).limit(K).to_arrow()
    want = ref.search(Q[0]).nprobes(10_000).limit(K).to_arrow()
    _assert_same([(np.asarray(got["id"]), np.asarray(got["_distance"]))],
                 [(np.asarray(want["id"]), np.asarray(want["_distance"]))])
    fresh = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    with pytest.raises(ValueError, match="num_bits"):
        fresh.create_index(config=IvfPq(num_partitions=PARTS, num_bits=6))
    with pytest.raises(ValueError, match="num_bits"):
        lancedb_tpu.connect(str(tmp_path / "r")).create_table("t", TABLE).create_index(
            config=RefIvfPq(num_partitions=PARTS, num_bits=6)
        )
    fresh.create_index(index_type="IVF_SQ", num_partitions=PARTS)  # test_torch_sqrq.py
    assert fresh._dataset.manifest.indices[0].index_type == "IVF_SQ"


@pytest.fixture(scope="module")
def port_index(tmp_path_factory):
    """One port-built index per num_bits (l2), built on first use."""
    built = {}

    def get(bits):
        if bits not in built:
            path = str(tmp_path_factory.mktemp(f"port_{bits}"))
            t = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
            t.create_index(config=_config(IvfPq, "l2", bits))
            built[bits] = path
        return built[bits]

    return get


@pytest.mark.parametrize("bits", [4, 8])
def test_reference_searches_port_build(port_index, bits):
    """The port writes the reference's files: the reference loads the
    port-built index and gives the port's own results."""
    path = port_index(bits)
    want = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"), refine=10)
    got = _search(lancedb_tpu.connect(path).open_table("t"), refine=10)
    _assert_same(got, want)
    raw_port = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"))
    _assert_same(_search(lancedb_tpu.connect(path).open_table("t")), raw_port)


@pytest.mark.parametrize("bits", [4, 8])
def test_port_build_recall_matches_reference_build(ref_index, port_index, bits):
    """recall@10 against brute force: the port's build reaches the
    reference's own build at the same settings, less 0.03, raw and
    refined (a better port build passes)."""
    port = lancedb_tpu_torch.connect(port_index(bits), device="cpu").open_table("t")
    ref = lancedb_tpu.connect(ref_index("l2", bits)).open_table("t")
    for refine in (None, 10):
        r_port, r_ref = _recall(_search(port, refine=refine)), _recall(_search(ref, refine=refine))
        assert r_port >= r_ref - 0.03, (refine, r_port, r_ref)
    r_port = _recall(_search(port, "category < 5", 10), "category < 5")
    assert r_port >= 0.9


@pytest.fixture(scope="module")
def delta_index(ref_index, tmp_path_factory):
    """A reference-built 8-bit index per metric, then 200 rows added by the
    reference: the added rows live in a fragment the index does not cover."""
    built = {}

    def get(metric):
        if metric not in built:
            path = str(tmp_path_factory.mktemp(f"delta_{metric}"))
            shutil.copytree(ref_index(metric, 8), path, dirs_exist_ok=True)
            rng = np.random.default_rng(7)
            x = (X[rng.integers(0, N, 200)] + 0.3 * rng.standard_normal((200, DIM))).astype(
                np.float32)
            ids = np.arange(N, N + 200, dtype=np.int64)
            lancedb_tpu.connect(path).open_table("t").add(pa.table({
                "id": ids, "category": ids % 10,
                "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM),
            }))
            built[metric] = path
        return built[metric]

    return get


@pytest.mark.parametrize("refine", [None, 10])
@pytest.mark.parametrize("where", [None, "category < 5"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_delta_fragment_matches_reference(delta_index, metric, where, refine):
    """Rows added after the build are brute-forced and merged with the
    index's hits, in both packages alike."""
    path = delta_index(metric)
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    assert port.count_rows() == N + 200
    got = _search(port, where, refine)
    _assert_same(got, _search(lancedb_tpu.connect(path).open_table("t"), where, refine))
    assert any(np.any(ids >= N) for ids, _ in got)  # the delta rows are served


def test_multivector_column_refused(tmp_path):
    """A multivector column (list<fixed_size_list<float32>[8]>) is no
    longer refused: an IVF_PQ create_index builds its token-level FLAT
    index, as the reference's does, and search serves it by MaxSim with
    the reference's results (tests/test_torch_multivector.py holds the
    rest)."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((int(rng.integers(2, 5)), 8)).astype(np.float32).tolist()
            for _ in range(20)]
    path = str(tmp_path)
    tbl = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", pa.table({
        "id": np.arange(20), "vector": pa.array(rows, type=pa.list_(pa.list_(pa.float32(), 8))),
    }))
    q = rng.standard_normal((3, 8)).astype(np.float32)
    before = tbl.search(q).limit(3).to_arrow()
    tbl.create_index(num_partitions=2)
    meta = tbl._dataset.manifest.indices[0]
    assert meta.index_type == "FLAT" and meta.params["multivector"]
    got = tbl.search(q).limit(3).to_arrow()
    want = lancedb_tpu.connect(path).open_table("t").search(q).limit(3).to_arrow()
    for out in (before, got):
        np.testing.assert_array_equal(np.asarray(out["id"]), np.asarray(want["id"]))
        np.testing.assert_allclose(np.asarray(out["_distance"]), np.asarray(want["_distance"]),
                                   rtol=1e-5, atol=1e-5)
