"""The slice as a whole: IVF_FLAT and FLAT build and search through
connect(), lancedb_tpu_torch (device="cpu") against lancedb_tpu.

Searches are compared exactly on one shared index: the same row ids
apart from distance ties (|Δ| <= 1e-5 relative), and distances to rtol
1e-5. Builds are compared by recall (the packages draw the same
k-means++ bits, but sum in other orders, so a near-tie can take another
branch), and by cross-loading: each package searches the index the
other one built.

The IVF_FLAT planner takes the shared full scan on the CPU when
bucket(batch) x nprobes >= 2.5 x blocks. With 16 partitions (about 20
blocks) and nprobes 4, a batch of 8 takes the probed scan and a batch of
128 the full scan, in both packages.
"""

import json

import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import Flat as RefFlat
from lancedb_tpu.index import IvfFlat as RefIvfFlat
from lancedb_tpu_torch.index import Flat, IvfFlat, IvfPq
from lancedb_tpu_torch.index import vector as port_vector
from lancedb_tpu_torch.index.vector import SearchParams, VectorSearcher

N, DIM, K = 3000, 32, 10
PARTS, NPROBES = 16, 4
SMALL, LARGE = 8, 128  # a probed batch and a full-scan batch


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((48, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 48, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (cent[rng.integers(0, 48, LARGE)] + rng.standard_normal((LARGE, DIM))).astype(np.float32)
    ids = np.arange(N, dtype=np.int64)
    tbl = pa.table({
        "id": ids,
        "category": ids % 10,
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), DIM),
    })
    return tbl, x, q


TABLE, X, Q = _data()


def _ref_config(index_type, metric):
    if index_type == "FLAT":
        return RefFlat(distance_type=metric)
    return RefIvfFlat(distance_type=metric, num_partitions=PARTS, max_iterations=10)


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """One reference-built index per (index type, metric), built on first use."""
    built = {}

    def get(index_type, metric):
        if (index_type, metric) not in built:
            path = str(tmp_path_factory.mktemp(f"ref_{index_type}_{metric}"))
            t = lancedb_tpu.connect(path).create_table("t", TABLE)
            t.create_index(config=_ref_config(index_type, metric))
            built[(index_type, metric)] = path
        return built[(index_type, metric)]

    return get


def _search(tbl, nq=SMALL, where=None, refine=None, precision=None):
    s = tbl.search(Q[:nq]).nprobes(NPROBES).limit(K)
    if where:
        s = s.where(where)
    if refine:
        s = s.refine_factor(refine)
    if precision:
        s = s.precision(precision)
    out = s.to_arrow()
    qi = np.asarray(out["query_index"])
    return [(np.asarray(out["id"])[qi == i], np.asarray(out["_distance"])[qi == i])
            for i in range(nq)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gi, gd), (wi, wd) in zip(got, want):
        assert len(gi) == len(wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
        for j in np.nonzero(gi != wi)[0]:
            # a different id only where the distance ties another hit, or
            # at the cut, where its tie partner fell off the list
            tie = np.abs(wd - wd[j]) <= 1e-5 * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, gd, wd)


def _recall(results, nq=SMALL):
    d = ((Q[:nq, None, :] - X[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :K]
    return float(np.mean([len(set(ids) & set(g)) / K for (ids, _), g in zip(results, gt)]))


@pytest.fixture
def routes(monkeypatch):
    """Counts the port's IVF_FLAT scans by route."""
    seen = {"probed": 0, "full": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_vector, "_ivf_flat_search", spy("probed", port_vector._ivf_flat_search))
    monkeypatch.setattr(port_vector, "_ivf_full_scan", spy("full", port_vector._ivf_full_scan))
    return seen


@pytest.mark.parametrize("refine", [None, 10])
@pytest.mark.parametrize("where", [None, "category < 5"])
@pytest.mark.parametrize("nq", [SMALL, LARGE])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_ivf_flat_matches_reference(ref_index, routes, metric, nq, where, refine):
    """Cosine distances come back unhalved (1 − cos) and refine takes the
    host path, as in the reference; small batches probe, large ones scan."""
    path = ref_index("IVF_FLAT", metric)
    want = _search(lancedb_tpu.connect(path).open_table("t"), nq, where, refine)
    got = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"), nq, where, refine)
    _assert_same(got, want)
    assert routes["probed" if nq == SMALL else "full"] > 0
    assert routes["full" if nq == SMALL else "probed"] == 0
    if where is not None:
        hits = np.concatenate([ids for ids, _ in got])
        assert len(hits) and np.all(hits % 10 < 5)
    if metric == "cosine" and refine is None:
        ids, d = got[0]
        x, q = X[ids[0]], Q[0]
        assert d[0] == pytest.approx(1 - x @ q / np.linalg.norm(x) / np.linalg.norm(q), abs=1e-5)


@pytest.mark.parametrize("precision", ["default", "float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_flat_matches_reference(ref_index, metric, precision):
    path = ref_index("FLAT", metric)
    want = _search(lancedb_tpu.connect(path).open_table("t"), precision=precision)
    got = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"),
                  precision=precision)
    _assert_same(got, want)


@pytest.mark.parametrize("refine", [None, 10])
def test_flat_filtered_matches_reference(ref_index, refine):
    path = ref_index("FLAT", "l2")
    want = _search(lancedb_tpu.connect(path).open_table("t"), SMALL, "category < 5", refine)
    got = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"), SMALL,
                  "category < 5", refine)
    _assert_same(got, want)


@pytest.mark.parametrize("index_type", ["IVF_FLAT", "FLAT"])
def test_search_after_delete_matches_reference(tmp_path, index_type):
    path = str(tmp_path)
    lancedb_tpu.connect(path).create_table("t", TABLE).create_index(
        config=_ref_config(index_type, "l2")
    )
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    assert port.delete("id % 3 = 0") == N // 3
    got = _search(port)
    _assert_same(got, _search(lancedb_tpu.connect(path).open_table("t")))
    assert not np.any(np.concatenate([ids for ids, _ in got]) % 3 == 0)


def _searchers(path):
    ref = lancedb_tpu.connect(path).open_table("t")
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    return (ref._get_searcher(ref._dataset.manifest.indices[0]),
            port._get_searcher(port._dataset.manifest.indices[0]))


def _same_raw(got, want):
    _assert_same([(r.astype(np.int64), d) for d, r in zip(*got)],
                 [(r.astype(np.int64), d) for d, r in zip(*want)])


def test_use_index_for_batch_keeps_the_probed_scan(ref_index, routes):
    ref, port = _searchers(ref_index("IVF_FLAT", "l2"))
    params = dict(k=K, nprobes=NPROBES, use_index_for_batch=True)
    from lancedb_tpu.index.vector import SearchParams as RefParams

    got = port.search(Q, SearchParams(**params))
    assert routes == {"probed": 1, "full": 0}
    _same_raw(got, ref.search(Q, RefParams(**params)))
    # and the full scan returns the exact top-k, a superset of any nprobes
    full = port.search(Q, SearchParams(k=K, nprobes=NPROBES))
    assert routes["full"] == 1
    assert _recall([(r, d) for d, r in zip(*full)], LARGE) == 1.0


def test_flat_accurate_mode_is_float32(ref_index):
    _, port = _searchers(ref_index("FLAT", "l2"))
    acc = port.search(Q[:SMALL], SearchParams(k=K, approx_mode="accurate"))
    f32 = port.search(Q[:SMALL], SearchParams(k=K, precision="float32"))
    np.testing.assert_array_equal(acc[1], f32[1])
    np.testing.assert_array_equal(acc[0], f32[0])


def test_refine_is_fused_only_for_ivf_pq(ref_index, tmp_path, monkeypatch):
    """IVF_FLAT and FLAT keep the host refine; an IVF_PQ search in
    precision float32 fuses only against an f32 refine table."""
    for index_type in ("IVF_FLAT", "FLAT"):
        port = lancedb_tpu_torch.connect(ref_index(index_type, "l2"), device="cpu").open_table("t")
        s = port._get_searcher(port._dataset.manifest.indices[0])
        assert not s.prepare_device_refine(port._dataset, "vector")
        assert not s.will_fuse_refine(SearchParams(refine_factor=10))
    monkeypatch.setenv("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", "0")
    pq = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    pq.create_index(config=IvfPq(num_partitions=PARTS, num_sub_vectors=8, max_iterations=5))
    s = pq._get_searcher(pq._dataset.manifest.indices[0])
    assert s.prepare_device_refine(pq._dataset, "vector")  # f16 residuals
    assert s.will_fuse_refine(SearchParams(refine_factor=10))
    assert not s.will_fuse_refine(SearchParams(refine_factor=10, precision="float32"))


def test_from_arrays_matches_loaded_index(ref_index):
    """VectorSearcher.from_arrays over the reference's arrays (no disk)
    searches like the searcher that loaded the same files."""
    for index_type in ("IVF_FLAT", "FLAT"):
        path = ref_index(index_type, "cosine")
        port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
        meta = port._dataset.manifest.indices[0]
        prefix = port._dataset.index_dir(meta.uuid)
        store = port._dataset.store
        doc = json.loads(store.read_bytes(f"{prefix}/meta.json"))
        arrays = {n: np.load(store.local_path(f"{prefix}/{n}.npy"))
                  for n in port_vector._INDEX_FILES[index_type]}
        s = VectorSearcher.from_arrays(doc, arrays, device="cpu")
        pen = np.where(np.arange(s.num_slots) % 7 == 0, port_vector.PAD_PENALTY,
                       np.float32(0)).astype(np.float32)
        params = SearchParams(k=K, nprobes=NPROBES)
        got = s.search(Q[:SMALL], params, slot_penalty=pen)
        want = port._get_searcher(meta).search(Q[:SMALL], params, slot_penalty=pen)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.fixture(scope="module")
def port_index(tmp_path_factory):
    """One port-built l2 index per type, built on first use."""
    built = {}

    def get(index_type):
        if index_type not in built:
            path = str(tmp_path_factory.mktemp(f"port_{index_type}"))
            t = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
            cfg = Flat() if index_type == "FLAT" else IvfFlat(num_partitions=PARTS,
                                                             max_iterations=10)
            t.create_index(config=cfg)
            built[index_type] = path
        return built[index_type]

    return get


@pytest.mark.parametrize("index_type", ["IVF_FLAT", "FLAT"])
def test_reference_searches_port_build(port_index, index_type):
    """The port writes the reference's files: the reference loads the
    port-built index and gives the port's own results."""
    path = port_index(index_type)
    want = _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t"))
    _assert_same(_search(lancedb_tpu.connect(path).open_table("t")), want)


def test_port_build_recall_matches_reference_build(ref_index, port_index):
    """recall@10 against brute force: the port's IVF_FLAT build reaches
    the reference's own build at the same settings, less 0.03."""
    port = lancedb_tpu_torch.connect(port_index("IVF_FLAT"), device="cpu").open_table("t")
    ref = lancedb_tpu.connect(ref_index("IVF_FLAT", "l2")).open_table("t")
    r_port, r_ref = _recall(_search(port)), _recall(_search(ref))
    assert r_port >= r_ref - 0.03, (r_port, r_ref)
    flat = lancedb_tpu_torch.connect(port_index("FLAT"), device="cpu").open_table("t")
    assert _recall(_search(flat, precision="float32")) == 1.0


def test_create_index_by_name_and_refusals(tmp_path):
    tbl = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    tbl.create_index(index_type="IVF_FLAT", num_partitions=PARTS, max_iterations=5)
    assert tbl._dataset.manifest.indices[0].index_type == "IVF_FLAT"
    tbl.create_index(index_type="flat", metric="cosine")
    assert tbl._dataset.manifest.indices[0].params["metric"] == "cosine"
    tbl.create_index(index_type="IVF_HNSW_SQ")  # ported: test_torch_hnsw.py holds it
    assert tbl._dataset.manifest.indices[0].index_type == "IVF_HNSW_SQ"
    for index_type in ("IVF_SQ", "IVF_RQ"):  # ported: test_torch_sqrq.py holds them
        tbl.create_index(index_type=index_type, num_partitions=PARTS, max_iterations=5)
        assert tbl._dataset.manifest.indices[0].index_type == index_type
    with pytest.raises(ValueError, match="unsupported index_type"):
        tbl.create_index(index_type="NO_SUCH_INDEX")


def test_bfloat16_storage_is_f32_on_the_cpu(tmp_path):
    """IvfFlat(precision='bfloat16') stores bf16 only where matmul_dtype
    is bf16 (the card), as the reference stores it only on the TPU."""
    tbl = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", TABLE)
    tbl.create_index(config=IvfFlat(num_partitions=PARTS, max_iterations=5, precision="bfloat16"))
    s = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    assert s.params["precision"] == "bfloat16"
    assert s._device["vectors"].dtype == torch.float32
