"""IVF_PQ at large D: the build's capacity modes (bf16 residuals, the
residual-free encode), OPQ, and the PQ host functions, lancedb_tpu_torch
(device="cpu") against lancedb_tpu.

Given shared inputs (centroids, codebooks, rotations) the two packages
must agree exactly on assignments and codes, to rtol 1e-5 on rnorms,
reconstructions and ADC tables, and bit for bit on bf16 residuals.
Both packages draw the same k-means++ bits from a seed, so trainings are
held to the reference's outputs: codebooks, centroids and OPQ rotations
to 1e-5 (rtol and atol), whole builds array by array (centroids to 1e-4,
codebooks to 1e-4 but for at most one subvector, codes equal but for at
most 0.1 % of them: the packages sum in other orders, so a near-tie in
a Lloyd step can go the other way and send that subvector's training
its own way). Builds are also compared by cross-loading (each
package searches the other's index and gives the builder's own ids and
distances) and by recall@10 within 0.02 after refine.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu.ops import kmeans as ref_kmeans
from lancedb_tpu.ops import pq as ref_pq
from lancedb_tpu_torch.index import IvfPq
from lancedb_tpu_torch.index import vector as port_vector
from lancedb_tpu_torch.ops import kmeans as port_kmeans
from lancedb_tpu_torch.ops import pq as port_pq
from lancedb_tpu_torch.ops import prng

N, DIM, NQ, K = 3000, 32, 16, 10
PARTS, NSUB = 16, 8
_RNG = np.random.default_rng(5)
_CENT = _RNG.standard_normal((48, DIM)).astype(np.float32) * 3.0
X = (_CENT[_RNG.integers(0, 48, N)] + _RNG.standard_normal((N, DIM))).astype(np.float32)
Q = (_CENT[_RNG.integers(0, 48, NQ)] + _RNG.standard_normal((NQ, DIM))).astype(np.float32)
TABLE = pa.table({
    "id": np.arange(N, dtype=np.int64),
    "vector": pa.FixedSizeListArray.from_arrays(pa.array(X.ravel()), DIM),
})
CENTS = X[:: N // PARTS][:PARTS] + 0.1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_bf16_residuals_match_reference(metric):
    """assign_residuals_device with bf16 residuals equals the reference's
    on shared centroids; ivf_train_assign_device in bf16 mode gives its
    f32 mode's centroids and assignment, and residuals that are the f32
    ones rounded to bf16."""
    want_a, want_r = ref_kmeans.assign_residuals_device(
        jnp.asarray(X[:2048]), jnp.asarray(CENTS), metric=metric, chunk=1024,
        residual_dtype="bfloat16")
    got_a, got_r = port_kmeans.assign_residuals_device(
        _t(X[:2048]), _t(CENTS), metric=metric, chunk=700, residual_dtype="bfloat16")
    assert got_r.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_r.float().numpy(), np.asarray(want_r).astype(np.float32))

    rng = np.random.default_rng(0)
    args = (_t(X), _t(rng.choice(N, 1024, replace=False).astype(np.int32)),
            _t(np.arange(256, dtype=np.int32)))
    reseed = _t(rng.integers(0, 1024, (10, PARTS), dtype=np.int32))
    out = {}
    for dt in ("float32", "bfloat16"):
        out[dt] = port_kmeans.ivf_train_assign_device(
            *args, prng.prng_key(0), reseed, k=PARTS, max_iters=10, metric=metric, chunk=1000,
            residual_dtype=dt)
    for a, b in zip(out["float32"][:2], out["bfloat16"][:2]):
        assert torch.equal(a, b)
    assert torch.equal(out["bfloat16"][2], out["float32"][2].to(torch.bfloat16))


@pytest.fixture(scope="module")
def shared():
    """Residuals against CENTS, reference-trained codebooks (8-bit x8) and
    a seeded orthonormal rotation."""
    assign = np.argmin(((X[:, None] - CENTS[None]) ** 2).sum(-1), axis=1).astype(np.int32)
    res = X - CENTS[assign]
    cb = ref_pq.pq_train(res, NSUB, num_bits=8, max_iters=10, seed=3)
    rot = np.linalg.qr(np.random.default_rng(4).standard_normal((DIM, DIM)))[0]
    return assign, res, cb, rot.astype(np.float32)


@pytest.mark.parametrize("from_raw,rotated", [(False, False), (True, False), (False, True)],
                         ids=["residuals", "from_raw", "rotation"])
def test_encode_rnorms_matches_reference(shared, from_raw, rotated):
    """The fused encode + |x̂|² on shared codebooks: codes exact, rnorms to
    rtol 1e-5, whether it reads residuals, forms them from the raw rows
    (the residual-free capacity mode) or encodes rotated residuals (OPQ)."""
    assign, res, cb, rot = shared
    src = X if from_raw else res
    n = 2048  # the reference scans whole chunks
    want_c, want_r = ref_pq._encode_rnorms_device(
        jnp.asarray(src[:n]), jnp.asarray(CENTS), jnp.asarray(assign[:n]), jnp.asarray(cb),
        jnp.asarray(rot) if rotated else jnp.zeros((1, 1), jnp.float32), chunk=512,
        has_rotation=rotated, from_raw=from_raw)
    got_c, got_r = port_pq._encode_rnorms_device(
        _t(src[:n]), _t(CENTS), _t(assign[:n]), _t(cb), chunk=700,
        rotation=_t(rot) if rotated else None, from_raw=from_raw)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-5)


def test_pq_host_functions_match_reference(shared):
    """pq_encode, pq_reconstruct, adc_lut and adc_scan_lut on shared
    codebooks; kmeans_assign on shared centroids; pq_train and kmeans_fit
    give the reference's own training from the same seed."""
    assign, res, cb, _ = shared
    codes = port_pq.pq_encode(res, cb, block_rows=1000, device="cpu")
    np.testing.assert_array_equal(codes, ref_pq.pq_encode(res, cb))
    np.testing.assert_allclose(port_pq.pq_reconstruct(codes, cb, device="cpu"),
                               ref_pq.pq_reconstruct(codes, cb), rtol=1e-6)
    luts = port_pq.adc_lut(_t(Q), _t(cb))
    want_luts = ref_pq.adc_lut(jnp.asarray(Q), jnp.asarray(cb))
    np.testing.assert_allclose(luts.numpy(), np.asarray(want_luts), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        port_pq.adc_scan_lut(luts, _t(codes[:500])).numpy(),
        np.asarray(ref_pq.adc_scan_lut(want_luts, jnp.asarray(codes[:500]))), rtol=1e-5)
    np.testing.assert_array_equal(
        port_kmeans.kmeans_assign(X, CENTS, block_rows=1000, device="cpu"),
        ref_kmeans.kmeans_assign(X, CENTS))

    for bits in (4, 8):
        np.testing.assert_allclose(
            port_pq.pq_train(res, NSUB, num_bits=bits, max_iters=10, device="cpu"),
            ref_pq.pq_train(res, NSUB, num_bits=bits, max_iters=10), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port_kmeans.kmeans_fit(X, PARTS, max_iters=10, seed=1, device="cpu"),
                               ref_kmeans.kmeans_fit(X, PARTS, max_iters=10, seed=1),
                               rtol=1e-5, atol=1e-5)


def _search(tbl, refine=None):
    s = tbl.search(Q).nprobes(4).limit(K)
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
            tie = np.abs(wd - wd[j]) <= 1e-5 * max(abs(float(wd[j])), 1e-6)
            assert j == len(wi) - 1 or tie.sum() > 1, (gi, wi, gd, wd)


def _recall(results):
    gt = np.argsort(((Q[:, None] - X[None]) ** 2).sum(-1), axis=1)[:, :K]
    return float(np.mean([len(set(ids) & set(g)) / K for (ids, _), g in zip(results, gt)]))


def test_residual_free_build_equals_buffered_build(tmp_path, monkeypatch):
    """Above the threshold the build forms residuals per chunk from the
    raw rows; on the CPU (f32 either way) its files equal the buffered
    build's, and the reference serves the index with the port's results."""
    files = {}
    for mode, limit in (("residuals_float32", port_vector.RES_FREE_BYTES), ("res_free", 0)):
        monkeypatch.setattr(port_vector, "RES_FREE_BYTES", limit)
        path = str(tmp_path / mode)
        tbl = lancedb_tpu_torch.connect(path, device="cpu").create_table("t", TABLE)
        tbl.create_index(config=IvfPq(num_partitions=PARTS, num_sub_vectors=NSUB,
                                      max_iterations=10))
        meta = tbl._dataset.manifest.indices[0]
        assert meta.params["build_mode"] == mode
        prefix = tbl._dataset.index_dir(meta.uuid)
        files[mode] = {name: port_vector._load_npy(tbl._dataset.store, f"{prefix}/{name}.npy")
                       for name in ("codes", "rnorms", "codebooks", "centroids")}
    for name, arr in files["res_free"].items():
        np.testing.assert_array_equal(arr, files["residuals_float32"][name], err_msg=name)
    path = str(tmp_path / "res_free")
    _assert_same(_search(lancedb_tpu.connect(path).open_table("t")),
                 _search(lancedb_tpu_torch.connect(path, device="cpu").open_table("t")))


def test_opq_builds_cross_load(tmp_path):
    """create_index(IvfPq(opq=True)) builds in the port; each package
    searches the other's OPQ index and gives the builder's own ids and
    distances, raw and refined; the two builds' refined recall@10 lies
    within 0.02, and the port's raw recall is at least the reference's
    less 0.03."""
    kw = dict(num_partitions=PARTS, num_sub_vectors=NSUB, opq=True, opq_iters=1,
              max_iterations=10)
    paths = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    lancedb_tpu_torch.connect(paths["port"], device="cpu").create_table("t", TABLE).create_index(
        config=IvfPq(**kw))
    lancedb_tpu.connect(paths["ref"]).create_table("t", TABLE).create_index(config=RefIvfPq(**kw))
    results = {}
    for builder, path in paths.items():
        port = lancedb_tpu_torch.connect(path, device="cpu").open_table("t")
        ref = lancedb_tpu.connect(path).open_table("t")
        assert port._dataset.manifest.indices[0].params.get("opq") is True
        for refine in (None, 10):
            got, want = _search(port, refine), _search(ref, refine)
            if builder == "port":
                got, want = want, got
            _assert_same(got, want)
            results[(builder, refine)] = _recall(want)
    assert abs(results[("port", 10)] - results[("ref", 10)]) <= 0.02, results
    assert results[("port", None)] >= results[("ref", None)] - 0.03, results
    port_files, ref_files = (_index_files(lancedb_tpu_torch.connect(paths[b], device="cpu")
                                          .open_table("t"), ("rotation", "codebooks"))
                             for b in ("port", "ref"))
    np.testing.assert_allclose(port_files["rotation"], ref_files["rotation"], rtol=1e-5,
                               atol=1e-5)
    _assert_codebooks_close(port_files["codebooks"], ref_files["codebooks"])


def _assert_codebooks_close(got, want):
    """Every subvector's codebook to 1e-4 but at most one, whose training
    a near-tie sent its own way."""
    close = np.all(np.isclose(got, want, rtol=1e-4, atol=1e-4), axis=(1, 2))
    assert np.sum(~close) <= 1, np.nonzero(~close)


def _index_files(tbl, names) -> dict:
    meta = tbl._dataset.manifest.indices[0]
    prefix = tbl._dataset.index_dir(meta.uuid)
    return {name: port_vector._load_npy(tbl._dataset.store, f"{prefix}/{name}.npy")
            for name in names}


def _widths_table(n, dim, metric):
    rng = np.random.default_rng(11)
    cent = rng.standard_normal((64, dim)).astype(np.float32) * 2.0
    x = (cent[rng.integers(0, 64, n)] + rng.standard_normal((n, dim))).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return pa.table({"id": np.arange(n, dtype=np.int64),
                     "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), dim)})


@pytest.mark.parametrize("n,dim,metric,parts,nsub,bits", [
    (N, DIM, "l2", PARTS, NSUB, 8),
    (4096, 960, "l2", 16, 96, 4),
    (4096, 1536, "cosine", 8, 192, 4),
], ids=["d32_8bit", "gist_widths", "openai_widths"])
def test_build_matches_reference(tmp_path, n, dim, metric, parts, nsub, bits):
    """From the same seed the port builds the reference's IVF_PQ index,
    at a small width and at the widths of the BASELINE large-D configs
    (D 960 with 96 4-bit subvectors, D 1536 cosine with 192) on fewer
    rows: the same block layout and row order, centroids and codebooks,
    and codes but for near-ties (searches of one index are held to the
    reference's in test_torch_ivfpq.py)."""
    table = TABLE if dim == DIM else _widths_table(n, dim, metric)
    kw = dict(num_partitions=parts, num_sub_vectors=nsub, num_bits=bits, distance_type=metric)
    tbls = {"port": lancedb_tpu_torch.connect(str(tmp_path / "port"), device="cpu")
            .create_table("t", table),
            "ref": lancedb_tpu.connect(str(tmp_path / "ref")).create_table("t", table)}
    tbls["port"].create_index(config=IvfPq(**kw))
    tbls["ref"].create_index(config=RefIvfPq(**kw))
    names = ("row_ids", "counts", "centroids", "codebooks", "codes")
    got = _index_files(tbls["port"], names)
    want = _index_files(lancedb_tpu_torch.connect(str(tmp_path / "ref"), device="cpu")
                        .open_table("t"), names)
    for name in ("row_ids", "counts"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["centroids"], want["centroids"], rtol=1e-4, atol=1e-4)
    assert np.mean(got["codes"] == want["codes"]) >= 0.999
    _assert_codebooks_close(got["codebooks"], want["codebooks"])
