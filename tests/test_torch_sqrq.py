"""IVF_SQ and IVF_RQ: builds and searches of lancedb_tpu_torch
(device="cpu") against lancedb_tpu on the same seeded data.

Builds agree array by array: codes, bits, the rotation, row ids and
counts exactly; scales, offsets, norms and rnorms to 1e-6 relative;
centroids to 1e-4 (k-means sums in another order). Searches run on one
shared index, built by either package and loaded by both: the same ids
apart from distance ties, distances to 1e-5 relative to |q|² + |d|, the
size of the terms that the l2 expansion |q|² − 2q·x̂ + |x̂|² cancels (the
two packages sum the products in other orders). Every case probes past
one gather chunk (8 probes) except the 4-probe raw case.
"""

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfRq as RefIvfRq
from lancedb_tpu.index import IvfSq as RefIvfSq
from lancedb_tpu_torch.index import IvfRq, IvfSq
from lancedb_tpu_torch.index.vector import SearchParams, VectorSearcher, _load_npy

N, DIM, NQ, K, PARTS = 3000, 32, 16, 10, 16
EXACT = {"codes", "bits", "rotation", "row_ids", "counts"}
RTOL_1E6 = {"sq_scale", "sq_offset", "norms", "rnorms", "scales"}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((48, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 48, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (cent[rng.integers(0, 48, NQ)] + rng.standard_normal((NQ, DIM))).astype(np.float32)
    ids = np.arange(N, dtype=np.int64)
    return pa.table({
        "id": ids, "category": ids % 10,
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM),
    }), x, q


TABLE, X, Q = _data()
CLASSES = {"IVF_SQ": (IvfSq, RefIvfSq), "IVF_RQ": (IvfRq, RefIvfRq)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One index per (builder, index type, metric), built on first use."""
    paths = {}

    def get(by, kind, metric):
        key = (by, kind, metric)
        if key not in paths:
            path = str(tmp_path_factory.mktemp(f"{by}_{kind}_{metric}"))
            pkg = lancedb_tpu_torch.connect(path, device="cpu") if by == "port" else \
                lancedb_tpu.connect(path)
            cls = CLASSES[kind][0 if by == "port" else 1]
            pkg.create_table("t", TABLE).create_index(
                config=cls(distance_type=metric, num_partitions=PARTS, max_iterations=10))
            paths[key] = path
        return paths[key]

    return get


def _files(path: str) -> dict:
    tbl = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    meta = tbl._dataset.manifest.indices[0]
    prefix = tbl._dataset.index_dir(meta.uuid)
    names = [p.rsplit("/", 1)[-1][:-4] for p in tbl._dataset.store.list(prefix)
             if p.endswith(".npy")]
    return {n: np.asarray(_load_npy(tbl._dataset.store, f"{prefix}/{n}.npy")) for n in names}


def _search(tbl, nprobes=10, where=None, refine=None):
    s = tbl.search(Q).nprobes(nprobes).limit(K)
    if where:
        s = s.where(where)
    if refine:
        s = s.refine_factor(refine)
    out = s.to_arrow()
    qi = np.asarray(out["query_index"])
    return [(np.asarray(out["id"])[qi == i], np.asarray(out["_distance"])[qi == i])
            for i in range(NQ)]


def _assert_same(got, want, metric="l2"):
    qn2 = np.ones(NQ) if metric == "cosine" else (Q.astype(np.float64) ** 2).sum(1)
    for (gi, gd), (wi, wd), scale in zip(got, want, qn2):
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)
        for j in np.nonzero(gi != wi)[0]:
            # a different id only where the distance ties another hit, or
            # at the cut, where its tie partner fell off the list
            tie = np.abs(wd - wd[j]) <= 1e-5 * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, gd, wd)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("kind", ["IVF_SQ", "IVF_RQ"])
def test_build_matches_reference(built, kind, metric):
    port, ref = _files(built("port", kind, metric)), _files(built("ref", kind, metric))
    assert sorted(port) == sorted(ref)
    for name, want in ref.items():
        got = port[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in RTOL_1E6:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["raw_4_probes", "raw", "refined", "filtered"])
@pytest.mark.parametrize("by", ["ref", "port"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("kind", ["IVF_SQ", "IVF_RQ"])
def test_search_matches_reference(built, kind, metric, by, case):
    opts = {"raw_4_probes": dict(nprobes=4), "raw": {}, "refined": dict(refine=10),
            "filtered": dict(where="category < 5")}[case]
    path = built(by, kind, metric)
    got = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"), **opts)
    want = _search(lancedb_tpu.connect(path).open_table("t"), **opts)
    _assert_same(got, want, metric)
    hits = np.concatenate([ids for ids, _ in got])
    assert len(hits) == NQ * K
    if case == "filtered":
        assert np.all(hits % 10 < 5)


@pytest.mark.parametrize("kind", ["IVF_SQ", "IVF_RQ"])
def test_from_arrays_serves_reference_files(built, kind):
    """VectorSearcher.from_arrays over the reference's arrays gives the
    searcher loaded from disk, and the fused refine is active on both."""
    path = built("ref", kind, "l2")
    tbl = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    meta = tbl._dataset.manifest.indices[0]
    disk = tbl._get_searcher(meta)
    mem = VectorSearcher.from_arrays(meta.params, _files(path), device="cpu")
    for s in (disk, mem):
        assert s.prepare_device_refine(tbl._dataset, "vector")
    for params in (SearchParams(k=K, nprobes=10), SearchParams(k=K, nprobes=10, refine_factor=5)):
        (d1, r1), (d2, r2) = disk.search(Q, params), mem.search(Q, params)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
    assert disk.will_fuse_refine(SearchParams(refine_factor=5))


@pytest.mark.parametrize("kind", ["IVF_SQ", "IVF_RQ"])
def test_create_index_by_name_and_recall(tmp_path, kind):
    """create_index(index_type=...) builds either type with the reference's
    defaults; the port's refined recall@10 is at least 0.95 and its raw
    recall within 0.03 of the reference's build."""
    tbl = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    tbl.create_index(index_type=kind, num_partitions=PARTS, max_iterations=10)
    meta = tbl._dataset.manifest.indices[0]
    assert meta.index_type == kind and meta.params["num_partitions"] >= PARTS
    ref = lancedb_tpu.connect(str(tmp_path / "ref")).create_table("t", TABLE)
    ref.create_index(index_type=kind, num_partitions=PARTS, max_iterations=10)
    gt = np.argsort(((Q[:, None, :] - X[None]) ** 2).sum(-1), axis=1)[:, :K]

    def recall(res):
        return float(np.mean([len(set(ids) & set(g)) / K for (ids, _), g in zip(res, gt)]))

    assert recall(_search(tbl, refine=10)) >= 0.95
    assert recall(_search(tbl)) >= recall(_search(ref)) - 0.03


@pytest.mark.parametrize("kind", ["IVF_SQ", "IVF_RQ"])
def test_chunked_topk_keeps_every_candidate(tmp_path, kind):
    """Where the probes span more than one gather chunk (8 probes) and k
    exceeds 8·pmax, the reference's running top-k keeps only 8·pmax
    candidates (its carry is min(k, chunk·pmax) wide); the port returns
    all k, and both agree on those the reference keeps (ROADMAP §C)."""
    path = str(tmp_path)
    lancedb_tpu.connect(path).create_table("t", TABLE).create_index(
        config=CLASSES[kind][1](num_partitions=256, max_iterations=5))
    tables = (lancedb_tpu_torch.connect(path, device="cpu").open_table("t"),
              lancedb_tpu.connect(path).open_table("t"))
    port, ref = (t._get_searcher(t._dataset.manifest.indices[0]) for t in tables)
    cap = 8 * ref.pmax
    k = 2 * cap
    (pd, pr), (rd, rr) = (s.search(Q[:2], SearchParams(k=k, nprobes=32)) for s in (port, ref))
    invalid = np.uint64(np.iinfo(np.uint64).max)
    assert np.all((rr != invalid).sum(1) == cap)
    assert np.all((pr != invalid).sum(1) == k)
    np.testing.assert_allclose(pd[:, :cap], rd[:, :cap], rtol=1e-5, atol=1e-4)
