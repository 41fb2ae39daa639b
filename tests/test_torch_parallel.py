"""The device mesh: lancedb_tpu_torch.parallel against lancedb_tpu.parallel.

The reference runs on the 8 virtual CPU devices tests/conftest.py gives
it, the port on a mesh of ``["cpu"] * n``. The same seeded numpy inputs
go through both: ids must match (a different id only where the distance
ties another hit or sits at the cut), distances to 1e-5 relative, and
centroids to 1e-5. The port sums in other orders than XLA, so exact
floats are not expected.
"""

import shutil

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import lancedb_tpu
import lancedb_tpu.parallel as RP
import lancedb_tpu_torch
import lancedb_tpu_torch.parallel as TP
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu.parallel.build import ShardedIvfPqIndex as RefSharded
from lancedb_tpu_torch.errors import InvalidInputError
from lancedb_tpu_torch.parallel.build import ShardedIvfPqIndex as PortSharded

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

# (devices, query_parallel): 1, 2, 4 and 8 shards, and a 2 x 4 query-by-shard mesh
MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (8, 2)]
MESH_IDS = ["1", "2", "4", "8", "2x4"]
# l2 on every mesh, the other metrics on one each
SEARCH_CASES = [(m, "l2") for m in MESHES] + [((8, 2), "cosine"), ((4, 1), "dot")]
SEARCH_IDS = [f"{i}-l2" for i in MESH_IDS] + ["2x4-cosine", "4-dot"]


def meshes(n, qp=1):
    return RP.make_mesh(n, query_parallel=qp), TP.make_mesh(devices=["cpu"] * n,
                                                            query_parallel=qp)


def assert_same_rows(got_ids, got_d, want_ids, want_d, rtol=1e-5):
    """Row by row: distances to rtol, ids equal except at distance ties."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_d, want_d = np.asarray(got_d, np.float64), np.asarray(want_d, np.float64)
    assert got_ids.shape == want_ids.shape
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, atol=1e-6)
    for gi, wi, wd in zip(got_ids, want_ids, want_d):
        for j in np.nonzero(gi != wi)[0]:
            tie = np.abs(wd - wd[j]) <= rtol * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, wd)


def np_l2(q, x):
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


# ---------------------------------------------------------------- the mesh


def test_make_mesh_shapes_and_errors():
    m = TP.make_mesh(devices=["cpu"] * 8, query_parallel=2)
    assert m.shape == {"query": 2, "shard": 4} and m.devices.shape == (2, 4)
    assert TP.make_mesh(4, devices=["cpu"] * 8).shape == {"query": 1, "shard": 4}
    with pytest.raises(ValueError, match="requested 9 devices"):
        TP.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="query_parallel must divide"):
        TP.make_mesh(devices=["cpu"] * 6, query_parallel=4)
    for ref_call, port_call in (
        (lambda: RP.make_mesh(9), lambda: TP.make_mesh(9, devices=["cpu"] * 8)),
        (lambda: RP.make_mesh(6, query_parallel=4),
         lambda: TP.make_mesh(devices=["cpu"] * 6, query_parallel=4)),
    ):
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        with pytest.raises(ValueError) as port_err:
            port_call()
        assert str(port_err.value) == str(ref_err.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.make_mesh()  # no devices named: every card, and there is none


def test_placement_and_collectives():
    m = TP.make_mesh(devices=["cpu"] * 8, query_parallel=2)
    a = np.arange(48, dtype=np.float32).reshape(8, 6)
    by_shard = TP.shard_rows(m, a)
    assert [[c.shape[0] for c in row] for row in by_shard] == [[2] * 4] * 2
    np.testing.assert_array_equal(by_shard[1][3].numpy(), a[6:8])  # replicated over query
    by_query = TP.shard_rows(m, a, over="query")
    np.testing.assert_array_equal(by_query[1][0].numpy(), a[4:8])
    both = TP.shard_rows(m, a, over=("query", "shard"))
    np.testing.assert_array_equal(both[1][2].numpy(), a[6:7])
    assert all(c.shape == (8, 6) for row in TP.replicate(m, a) for c in row)
    from lancedb_tpu_torch.parallel.mesh import all_gather_cat, psum

    cat = all_gather_cat(by_shard[0], 0, torch.device("cpu"))
    np.testing.assert_array_equal(cat.numpy(), a)
    np.testing.assert_array_equal(psum(by_shard[0], torch.device("cpu")).numpy(),
                                  a.reshape(4, 2, 6).sum(0))
    with pytest.raises(ValueError, match="does not split"):
        TP.shard_rows(m, a[:7])


# ------------------------------------------------------- sharded flat / IVF


@pytest.mark.parametrize("mesh_shape,metric", SEARCH_CASES, ids=SEARCH_IDS)
def test_sharded_flat_matches_reference(mesh_shape, metric):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1000, 16)).astype(np.float32)  # 1000 pads to the mesh
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    rid = np.arange(1000, dtype=np.uint64) * 7
    rm, tm = meshes(*mesh_shape)
    rv, ri = RP.ShardedFlatIndex(rm, x, rid, metric=metric).search(q, 10)
    tv, ti = TP.ShardedFlatIndex(tm, x, rid, metric=metric).search(q, 10)
    assert ti.dtype == ri.dtype
    assert_same_rows(ti, tv, ri, rv)
    if metric == "l2":
        truth = np.argsort(np_l2(q, x), axis=1)[:, :10] * 7
        assert all(set(a) == set(b) for a, b in zip(ti.tolist(), truth.tolist()))


@pytest.mark.parametrize("mesh_shape,metric", SEARCH_CASES, ids=SEARCH_IDS)
def test_sharded_ivf_matches_reference(mesh_shape, metric):
    rng = np.random.default_rng(5)
    nparts, pmax, dim, nprobes = 16, 64, 16, 4
    cents = rng.standard_normal((nparts, dim)).astype(np.float32)
    parts = (cents[:, None, :] + 0.3 * rng.standard_normal((nparts, pmax, dim))).astype(
        np.float32)
    norms2 = np.sum(parts.astype(np.float64) ** 2, axis=2).astype(np.float32)
    norms2[:, 50:] = np.float32(3.0e38)  # padding slots
    rowids = np.arange(nparts * pmax, dtype=np.int32).reshape(nparts, pmax)
    q = (cents[rng.integers(0, nparts, 8)] + 0.3 * rng.standard_normal((8, dim))).astype(
        np.float32)
    rm, tm = meshes(*mesh_shape)

    def put(a, spec):
        return jax.device_put(a, NamedSharding(rm, spec))

    rv, ri = RP.make_sharded_ivf_search(rm, k=10, nprobes=nprobes, metric=metric)(
        put(q, P("query", None)), put(cents, P()), put(parts, P("shard", None, None)),
        put(norms2, P("shard", None)), put(rowids, P("shard", None)),
    )
    tv, ti = TP.make_sharded_ivf_search(tm, k=10, nprobes=nprobes, metric=metric)(
        TP.shard_rows(tm, q, over="query"), TP.replicate(tm, cents), TP.shard_rows(tm, parts),
        TP.shard_rows(tm, norms2), TP.shard_rows(tm, rowids),
    )
    assert_same_rows(ti.numpy(), tv.numpy(), np.asarray(ri), np.asarray(rv))
    assert not np.isin(ti.numpy() % pmax, np.arange(50, pmax)).any()  # no padding slot


# -------------------------------------------------------- distributed k-means


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_kmeans_step_matches_reference(mesh_shape):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4096, 8)).astype(np.float32)
    cents = x[:16].copy()
    rm, tm = meshes(*mesh_shape)
    step = RP.make_distributed_kmeans_step(rm, k=16)
    r_new, r_counts = step(
        jax.device_put(x, NamedSharding(rm, P(("query", "shard"), None))),
        jax.device_put(cents, NamedSharding(rm, P())),
    )
    t_new, t_counts = TP.make_distributed_kmeans_step(tm, k=16)(
        TP.shard_rows(tm, x, over=("query", "shard")), TP.replicate(tm, cents))
    # replicated over every cell
    assert len(t_new) == mesh_shape[1] and len(t_new[0]) == mesh_shape[0] // mesh_shape[1]
    np.testing.assert_array_equal(t_counts[-1][-1].numpy(), np.asarray(r_counts))
    np.testing.assert_allclose(t_new[-1][-1].numpy(), np.asarray(r_new), rtol=1e-5, atol=1e-5)
    truth = np.bincount(np_l2(x, cents).argmin(1), minlength=16)
    np.testing.assert_array_equal(t_counts[0][0].numpy(), truth)


@pytest.mark.parametrize("n_dev", [3, 8])
def test_distributed_kmeans_matches_reference(n_dev):
    """1001 rows pad to the mesh with the reference's drawn rows; the
    initial centroids are its numpy draw too."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 4)).astype(np.float32) * 10
    x = np.concatenate([c + rng.standard_normal((125, 4)).astype(np.float32) for c in centers])
    x = np.concatenate([x, x[:1]])
    rm, tm = meshes(n_dev)
    want = RP.distributed_kmeans(rm, x, k=8, iters=5, seed=3)
    got = TP.distributed_kmeans(tm, x, k=8, iters=5, seed=3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- sharded IVF_PQ


N, DIM = 3000, 32


def _vectors(seed=7):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((24, DIM)).astype(np.float32) * 3.0
    x = (cent[rng.integers(0, 24, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (cent[rng.integers(0, 24, 8)] + rng.standard_normal((8, DIM))).astype(np.float32)
    return x, q


X, Q = _vectors()


def _table(n=N):
    ids = np.arange(n, dtype=np.int64)
    return pa.table({
        "id": ids, "cat": ids % 3,
        "text": [f"tok{i % 23} filler{i % 7}" for i in range(n)],
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(X[:n].ravel()), DIM),
    })


_KINDS = {
    "l2": dict(num_partitions=16, num_sub_vectors=8, max_iterations=10),
    "cosine": dict(distance_type="cosine", num_partitions=16, num_sub_vectors=8,
                   max_iterations=10),
    "opq": dict(num_partitions=16, num_sub_vectors=8, opq=True, opq_iters=1, max_iterations=5),
    # fat partitions split into duplicate-centroid blocks: 5 blocks of 4
    # logical partitions (the others: 20 blocks of 16); neither count
    # divides by 3 or 8 shards
    "split": dict(num_partitions=4, num_sub_vectors=8, max_iterations=10),
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One index per (builder, kind) in a database of its own, on first use."""
    cache = {}

    def get(builder, kind):
        if (builder, kind) not in cache:
            path = str(tmp_path_factory.mktemp(f"{builder}_{kind}"))
            if builder == "ref":
                t = lancedb_tpu.connect(path).create_table("t", _table())
                t.create_index(config=RefIvfPq(**_KINDS[kind]))
            else:
                from lancedb_tpu_torch.index import IvfPq

                t = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", _table())
                t.create_index(config=IvfPq(**_KINDS[kind]))
            cache[(builder, kind)] = path
        return cache[(builder, kind)]

    return get


def _both_from(path, n_dev):
    rt = lancedb_tpu.connect(path).open_table("t")
    tt = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    rm, tm = meshes(n_dev)
    ref = RefSharded.from_dataset(rm, rt._dataset, rt._dataset.manifest.indices[0])
    port = PortSharded.from_dataset(tm, tt._dataset, tt._dataset.manifest.indices[0])
    return ref, port, rt, tt


@pytest.mark.parametrize("kind", ["l2", "cosine", "opq", "split"])
@pytest.mark.parametrize("builder", ["ref", "port"])
def test_from_dataset_matches_reference(built, builder, kind):
    """3 shards for the reference's builds, 8 for the port's; no block
    count divides by either, so dummy blocks are dealt."""
    n_dev = 3 if builder == "ref" else 8
    ref, port, _, _ = _both_from(built(builder, kind), n_dev)
    assert port.nblocks == ref.nblocks and port.num_slots == ref.num_slots
    np.testing.assert_array_equal(port.row_ids, ref.row_ids)
    np.testing.assert_array_equal(port._deal, ref._deal)
    if kind == "split":
        assert ref.num_logical_partitions == 4
    for nprobes in (2, 16):
        rv, ri = ref.search(Q, k=10, nprobes=nprobes)
        tv, ti = port.search(Q, k=10, nprobes=nprobes)
        assert ti.dtype == np.uint64 and tv.dtype == np.float32
        assert_same_rows(ti, tv, ri, np.asarray(rv))


def test_build_matches_reference():
    """ShardedIvfPqIndex built on the mesh: distributed k-means, the PQ
    build and the layout against the reference's, on 8 shards, and the
    searches."""
    rm, tm = meshes(8)
    rid = np.arange(2048, dtype=np.uint64)
    x = X[:2048]
    ref = RefSharded(rm, x, rid, num_partitions=16, num_sub_vectors=8, kmeans_iters=5)
    port = PortSharded(tm, x, rid, num_partitions=16, num_sub_vectors=8, kmeans_iters=5)
    np.testing.assert_allclose(port._centroids[0][0].numpy(), np.asarray(ref._centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port._codebooks[0][0].numpy(), np.asarray(ref._codebooks),
                               rtol=1e-5, atol=1e-5)
    assert port.nblocks == ref.nblocks and port.pmax == ref.pmax
    np.testing.assert_array_equal(port.row_ids, ref.row_ids)
    codes = np.concatenate([c.numpy() for c in port._codes[0]])
    assert (codes == np.asarray(ref._codes)).mean() > 0.999  # near-ties may flip a code
    for nprobes in (4, 16):
        rv, ri = ref.search(Q, k=10, nprobes=nprobes)
        tv, ti = port.search(Q, k=10, nprobes=nprobes)
        assert_same_rows(ti, tv, ri, np.asarray(rv))


def _synthetic_arrays(rng, nblocks=64, pmax=128, s_pad=8, nsub=4, dim=16):
    cents = rng.standard_normal((nblocks, dim)).astype(np.float32) * 4.0
    cbs = rng.standard_normal((nsub, 256, dim // nsub)).astype(np.float32)
    codes = rng.integers(0, 256, (nblocks, s_pad, pmax), dtype=np.uint8)
    codes[:, nsub:] = 0
    rn = rng.uniform(10, 40, (nblocks, pmax)).astype(np.float32)
    rn[:, 100:] = np.float32(3.0e38)
    rid = np.arange(nblocks * pmax, dtype=np.int64).reshape(nblocks, pmax)
    rid[:, 100:] = -1
    return codes, rn, rid, cents, cbs, pmax


def _placed(arrays, n_dev, num_logical=None):
    rm, tm = meshes(n_dev)
    ref, port = RefSharded.__new__(RefSharded), PortSharded.__new__(PortSharded)
    for ix, m in ((ref, rm), (port, tm)):
        ix.mesh, ix.metric = m, "l2"
        ix._place(*arrays, num_logical or arrays[0].shape[0])
    return ref, port


def test_owned_probes_beyond_the_budget_match_reference():
    """A query whose nearest blocks all deal to shard 0: 8 probes over 8
    shards give a budget of 6, so shard 0 drops two owned probes; the
    port keeps the reference's six (the first in probe order)."""
    rng = np.random.default_rng(3)
    arrays = _synthetic_arrays(rng)
    cents = arrays[3]
    target = cents[0].copy()
    for b in range(0, 64, 8):  # blocks 0, 8, ..., 56 live on shard 0
        cents[b] = target + 0.01 * (b // 8) * np.ones_like(target)
    ref, port = _placed(arrays, 8)
    assert port._budget(8) == 6
    q = np.stack([target + 0.001, cents[5]]).astype(np.float32)
    rv, ri = ref.search(q, k=20, nprobes=8)
    tv, ti = port.search(q, k=20, nprobes=8)
    assert_same_rows(ti, tv, ri, np.asarray(rv))
    blocks = (ti[0][ti[0] != np.iinfo(np.uint64).max].astype(np.int64)) // 128
    assert set(blocks.tolist()) <= {0, 8, 16, 24, 32, 40}  # 48 and 56 were dropped
    full_v, _ = port.search(q, k=20, nprobes=64)  # every block: a budget of 8 a shard
    assert np.all(full_v[0] <= tv[0] + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_refine_matches_reference(built, dtype):
    ref, port, rt, tt = _both_from(built("ref", "l2"), 3)
    # the slot-order table: each slot's row (by row id), zeros on padding
    col = tt._dataset.to_table(columns=["vector"], with_row_id=True)
    rid = col["_rowid"].to_numpy().astype(np.uint64)
    order = np.argsort(rid)
    rid = rid[order]
    mat = np.asarray(col["vector"].combine_chunks().flatten()).reshape(len(rid), -1)[order]
    pos = np.clip(np.searchsorted(rid, port.row_ids), 0, len(rid) - 1)
    found = rid[pos] == port.row_ids
    vecs = np.where(found[:, None], mat[pos], 0.0).astype(np.float32)
    n2 = np.sum(vecs.astype(np.float64) ** 2, axis=1).astype(np.float32)
    ref.attach_refine_table(vecs, n2, dtype=getattr(jax.numpy, dtype))
    port.attach_refine_table(vecs, n2, dtype=getattr(torch, dtype))
    assert port.refine_dtype == getattr(torch, dtype)
    rv, ri = ref.search(Q, k=40, nprobes=4, refine_k=10)
    tv, ti = port.search(Q, k=40, nprobes=4, refine_k=10)
    assert_same_rows(ti, tv, ri, np.asarray(rv))
    exact = np.sqrt(np.maximum(tv, 0))
    assert np.all(np.isfinite(exact))
    with pytest.raises(ValueError, match="slots"):
        port.attach_refine_table(vecs[:-1], n2[:-1])


def test_f16_residual_refine_matches_single_device(served, monkeypatch):
    """Above the f32 budget the sharded refine table holds f16 residuals
    against each slot's block centroid, as the single-device table does:
    a 1-shard mesh then reranks as one device does (the reference's
    sharded table would be bf16 full vectors on its TPU)."""
    monkeypatch.setenv("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", "0")
    _, port = served
    want = [_search(port, q, "cat = 1", 8) for q in Q[:4]]
    single = port._get_searcher(port._dataset.manifest.indices[0])
    assert single._device["refine_vecs"].dtype == torch.float16
    port.enable_sharded_serving(TP.make_mesh(devices=["cpu"]))
    got = [_search(port, q, "cat = 1", 8) for q in Q[:4]]
    sharded = next(iter(port._searchers.values()))._sharded
    assert sharded.refine_dtype == torch.float16 and sharded._refine_residual
    for (gi, gd), (wi, wd) in zip(got, want):
        assert_same_rows(gi[None], gd[None], wi[None], wd[None])


def test_slot_penalty_matches_reference(built):
    """Allowed rows, deleted rows and a vanished fragment give the
    reference's penalty; searches under it give the reference's hits. A
    single-device penalty is a prefix of the shard-padded slots."""
    ref, port, rt, tt = _both_from(built("ref", "split"), 8)
    allowed = np.arange(0, N, 2, dtype=np.uint64)
    deleted = np.arange(0, N, 5, dtype=np.uint64)
    for args in ((allowed, None, None), (None, deleted, None), (allowed, deleted, {0}),
                 (None, None, None)):
        want = ref.slot_penalty(*args)
        got = port.slot_penalty(*args)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, want)
    pen = port.slot_penalty(allowed, deleted)
    single = tt._get_searcher(tt._dataset.manifest.indices[0])
    prefix = single.slot_penalty(allowed, deleted)
    np.testing.assert_array_equal(pen[: len(prefix)], prefix)
    for p in (pen, prefix):
        rv, ri = ref.search(Q, k=10, nprobes=4, slot_penalty=p)
        tv, ti = port.search(Q, k=10, nprobes=4, slot_penalty=p)
        assert_same_rows(ti, tv, ri, np.asarray(rv))
        hits = ti[ti != np.iinfo(np.uint64).max]
        assert np.all(hits % 2 == 0) and not np.any(hits % 5 == 0)
    vanished = port.slot_penalty(None, None, {0})
    _, ti = port.search(Q, k=10, nprobes=4, slot_penalty=vanished)
    assert np.all(ti == np.iinfo(np.uint64).max)  # the table's one fragment is gone


def test_small_pool_large_k_matches_reference(built):
    """k beyond a shard's candidate pool pads with the invalid markers."""
    ref, port, _, _ = _both_from(built("ref", "l2"), 8)
    rv, ri = ref.search(Q[:2], k=600, nprobes=1)
    tv, ti = port.search(Q[:2], k=600, nprobes=1)
    assert ti.shape == (2, 600)
    assert np.isinf(tv[:, -1]).all() and (ti[:, -1] == np.iinfo(np.uint64).max).all()
    assert_same_rows(ti, tv, ri, np.asarray(rv))


# ------------------------------------------------- the table's sharded serving


def _hits(out):
    return np.asarray(out["id"]), np.asarray(out["_distance"])


def _search(tbl, q, where=None, refine=None, nprobes=4, k=10):
    s = tbl.search(q).nprobes(nprobes).limit(k)
    if where:
        s = s.where(where)
    if refine:
        s = s.refine_factor(refine)
    return _hits(s.to_arrow())


@pytest.fixture
def served(built, tmp_path):
    """A copy of the reference-built l2 database, open in both packages."""
    path = str(tmp_path / "db")
    shutil.copytree(built("ref", "l2"), path)
    return (lancedb_tpu.connect(path).open_table("t"),
            lancedb_tpu_torch.connect(path, device="cpu").open_table("t"))


@pytest.mark.parametrize("n_dev,case", [(1, "raw"), (4, "raw"), (4, "refined"), (4, "filtered"),
                                        (1, "filtered_refined"), (4, "filtered_refined")])
def test_table_sharded_serving_matches_reference(served, n_dev, case):
    ref, port = served
    where = "cat = 1" if case.startswith("filtered") else None
    refine = 8 if case.endswith("refined") else None
    rm, tm = meshes(n_dev)
    single = _search(port, Q[0], where, refine)
    ref.enable_sharded_serving(rm)
    port.enable_sharded_serving(tm)
    for q in Q[:3]:
        got = _search(port, q, where, refine)
        assert_same_rows(got[0][None], got[1][None], *[a[None] for a in _search(ref, q, where,
                                                                                    refine)])
    searcher = next(iter(port._searchers.values()))
    assert type(searcher).__name__ == "ShardedServingSearcher"
    assert searcher.device_refine_active == (refine is not None)
    if where:
        assert np.all(_search(port, Q[1], where, refine)[0] % 3 == 1)
    if n_dev == 1:  # one shard: the single-device searcher's hits
        got = _search(port, Q[0], where, refine)
        assert_same_rows(got[0][None], got[1][None], single[0][None], single[1][None])
    port.disable_sharded_serving()
    assert not port._searchers


def test_table_sharded_serving_after_delete_and_write(served):
    """A delete masks rows on every shard; a write drops the dealt
    searcher and the new rows are brute-forced beside it. The port's
    handle writes; the reference reopens the table and reads."""
    _, port = served
    path = port._conn.uri
    rm, tm = meshes(4)
    port.enable_sharded_serving(tm)

    def ref_search(*args, **kw):
        ref = lancedb_tpu.connect(path).open_table("t")
        ref.enable_sharded_serving(rm)
        return _search(ref, *args, **kw)

    target = int(_search(port, X[100])[0][0])
    port.delete(f"id = {target} OR id % 10 = 3")
    got, want = _search(port, X[100], refine=8), ref_search(X[100], refine=8)
    assert_same_rows(got[0][None], got[1][None], want[0][None], want[1][None])
    assert target not in got[0] and not np.any(got[0] % 10 == 3)
    new = _table(3000).slice(0, 5).to_pydict()
    new["id"] = [90_000 + i for i in range(5)]
    port.add(pa.table(new, schema=port.schema))
    assert not port._searchers
    got, want = _search(port, X[2]), ref_search(X[2])
    assert_same_rows(got[0][None], got[1][None], want[0][None], want[1][None])
    assert got[0][0] == 90_002 and list(got[0]).count(90_002) == 1
    assert "sharded:" in next(iter(port._searchers))


def test_table_sharded_hybrid_matches_reference(served):
    ref, port = served
    for t in (ref, port):
        t.create_fts_index("text", with_position=False)
    rm, tm = meshes(4)
    ref.enable_sharded_serving(rm)
    port.enable_sharded_serving(tm)

    def hybrid(t, where=None):
        s = t.search((X[7], "tok7"), query_type="hybrid").nprobes(4).limit(5)
        if where:
            s = s.where(where)
        return np.asarray(s.to_arrow()["id"])

    np.testing.assert_array_equal(hybrid(port), hybrid(ref))
    assert hybrid(port)[0] == 7
    got = hybrid(port, "id < 100")
    np.testing.assert_array_equal(got, hybrid(ref, "id < 100"))
    assert len(got) and np.all(got < 100)


@pytest.mark.parametrize("kind", ["ivf_flat", "dot"])
def test_table_sharded_serving_falls_back_like_reference(tmp_path, kind):
    """IVF_FLAT and dot are not served by the sharded scan: both packages
    answer from the single-device searcher."""
    path = str(tmp_path)
    t = lancedb_tpu.connect(path).create_table("t", _table(1200))
    if kind == "ivf_flat":
        t.create_index(index_type="IVF_FLAT", num_partitions=8)
    else:
        t.create_index(config=RefIvfPq(distance_type="dot", num_partitions=8,
                                       num_sub_vectors=8))
    ref = lancedb_tpu.connect(path).open_table("t")
    port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
    want = _search(port, Q[0])
    ref.enable_sharded_serving(RP.make_mesh(4))
    port.enable_sharded_serving(TP.make_mesh(devices=["cpu"] * 4))
    got = _search(port, Q[0])
    assert_same_rows(got[0][None], got[1][None], want[0][None], want[1][None])
    r = _search(ref, Q[0])
    assert_same_rows(got[0][None], got[1][None], r[0][None], r[1][None])
    assert type(next(iter(port._searchers.values()))).__name__ == "VectorSearcher"


def test_padding_slots_name_no_fragment(served, monkeypatch):
    """The query layer reads a searcher's fragments from its row ids;
    padding slots (the invalid id) must not count as a vanished fragment,
    or every search would compute a full slot penalty."""
    import lancedb_tpu_torch.query as tq

    _, port = served
    seen = []
    orig = tq._deleted_rowids
    monkeypatch.setattr(tq, "_deleted_rowids", lambda *a: seen.append(orig(*a)) or seen[-1])
    _search(port, Q[0])
    single = port._get_searcher(port._dataset.manifest.indices[0])
    assert (single.row_ids_flat == np.iinfo(np.uint64).max).any()  # the index has padding
    port.enable_sharded_serving(TP.make_mesh(devices=["cpu"] * 2))
    _search(port, Q[0])
    sharded = next(iter(port._searchers.values()))
    assert not (sharded.row_ids_flat == np.iinfo(np.uint64).max).any()
    assert seen == [(None, None), (None, None)]


def test_enable_sharded_serving_devices(tmp_path):
    """mesh=None on a CPU table is one cpu; a mesh of another device type
    is refused; the sharded searcher's row ids drop the padding."""
    port = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", _table(1200))
    port.create_index(config=lancedb_tpu_torch.IvfPq(num_partitions=4, num_sub_vectors=8,
                                                     max_iterations=5))
    with pytest.raises(InvalidInputError, match="device type"):
        port.enable_sharded_serving(TP.Mesh([[torch.device("meta")]]))
    port.enable_sharded_serving()
    out = _search(port, X[9], refine=4)
    assert out[0][0] == 9
    s = port._searchers[f"sharded:{port._dataset.manifest.indices[0].uuid}"]
    assert s._sharded.mesh.shape == {"query": 1, "shard": 1}
    assert len(s.row_ids_flat) == 1200 and not np.any(s.row_ids_flat == np.iinfo(np.uint64).max)
