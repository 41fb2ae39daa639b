"""The one-card capacity probe (lancedb_tpu_torch/probes/probe_scale_30m.py,
the port of scripts/probe_scale_30m.py) at a small size on the CPU, and
the bounded k-means transient under it.

- The probe draws the script's rows and queries bit for bit (its formula
  re-derived here from scripts/probe_scale_30m.py:46-95; the script is not
  imported: it builds and writes when imported).
- ``run(n=65_536, ch=16_384, device="cpu")`` on the smoke branch's 256
  partitions, with the port's RES_FREE_BYTES at 0 so that its build takes
  the residual-free mode the 30M build takes. The reference builds the
  same rows; its threshold is a literal (lancedb_tpu/index/vector.py:357-361)
  that cannot be lowered, so it builds in its buffered mode, which on the
  CPU gives the residual-free files (the port's two modes are held equal
  in test_torch_capacity.py). Raw recall@10 of the two builds within 0.03;
  each package's searcher on the other's index gives the builder's own
  top-10 ids exactly, distances to rtol 1e-5 (f32 sums in other orders).
- ``kmeans_fit_device`` with its product bound forced below the sample
  against the unchunked call on the same seeded inputs: the same
  assignments, centroids to rtol 1e-6 / atol 1e-6 (the same f32 products
  a chunk of rows at a time), and no chunk's product above the bound.
"""

import shutil

import numpy as np
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu.index import vector as ref_vector
from lancedb_tpu_torch.index import vector as port_vector
from lancedb_tpu_torch.ops import kmeans as port_kmeans
from lancedb_tpu_torch.probes import probe_scale_30m as probe

N, CH = 65_536, 16_384
NQ, D, K = 32, 128, 10


def _script_data(n: int, ch: int):
    """scripts/probe_scale_30m.py:46-51 (centres, query rows), :73-90
    (each chunk's rows, the query rows copied out of their chunk) and
    :93-95 (the queries' noise) → (centres, [chunk rows], queries)."""
    rng = np.random.default_rng(0)
    nc = 10_000
    cents = (rng.standard_normal((nc, D)) * 2.0).astype(np.float32)
    qi = np.random.default_rng(7).integers(0, n, NQ)
    q_rows, want, chunks = {}, {}, []
    for j, ridx in enumerate(qi.tolist()):
        want.setdefault(ridx // ch, []).append((j, ridx))
    for s in range(0, n, ch):
        e = min(s + ch, n)
        crng = np.random.default_rng(1000 + s // ch)
        a = crng.integers(0, nc, e - s)
        blk = cents[a] + crng.standard_normal((e - s, D), dtype=np.float32)
        for j, ridx in want.get(s // ch, []):
            q_rows[j] = blk[ridx - s].copy()
        chunks.append(blk)
    q = np.stack([q_rows[j] for j in range(NQ)]).astype(np.float32)
    q += 0.05 * np.random.default_rng(8).standard_normal((NQ, D)).astype(np.float32)
    return cents, chunks, q


@pytest.mark.parametrize("n,ch", [(N, CH), (50_000, CH)], ids=["whole_chunks", "ragged_last"])
def test_generator_is_the_scripts(n, ch):
    """Centres, every chunk's rows and the queries equal the script's bits."""
    cents, chunks, q = _script_data(n, ch)
    np.testing.assert_array_equal(probe.centres(), cents)
    for i, s in enumerate(range(0, n, ch)):
        got = probe.chunk_rows(cents, s, n, ch)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, chunks[i])
    np.testing.assert_array_equal(probe.queries(cents, n, ch), q)


def _recall(hits: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(hits, gt)]))


@pytest.fixture(scope="module")
def scale_run(tmp_path_factory):
    """The probe's run in the port (res_free), then the reference's build on
    a copy of the same table → (record, workdir, the copy's path, queries,
    ground truth)."""
    work = tmp_path_factory.mktemp("scale")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vector, "RES_FREE_BYTES", 0)
        # the probe's budget, set here so that it is undone after the run
        mp.setenv("LANCEDB_TPU_DEVICE_REFINE_BUDGET", str(int(N * D * 2 + 2**30)))
        rec = probe.run(n=N, ch=CH, device="cpu", workdir=work)
    ref_root = work / "ref_db"
    shutil.copytree(work / "db", ref_root)
    ref_tbl = lancedb_tpu.connect(str(ref_root)).open_table("data")
    ref_tbl.drop_index(probe.INDEX_NAME)
    ref_tbl.create_index(config=RefIvfPq(num_partitions=probe.num_partitions(N),
                                         num_sub_vectors=probe.NSUB, num_bits=probe.NBITS,
                                         distance_type="l2"), name="ref_pq")
    q, gt = np.load(work / "queries.npy"), np.load(work / "gt.npy")
    return rec, work, ref_root, q, gt


def test_probe_record_and_modes(scale_run):
    """The record: the script's settings, the residual-free build, the
    fused refine (an f32 table at this size), one chunk of queries."""
    rec = scale_run[0]
    assert (rec["n"], rec["npart"], rec["nsub"], rec["nbits"], rec["nq"]) == (N, 256, 16, 8, NQ)
    assert rec["build_mode"] == "res_free"
    assert rec["refine_mode"] == "fused_device_float32"
    assert rec["device"] == "cpu" and rec["build_peak_bytes"] is None
    assert rec["blocks"] >= 256 and rec["pmax"] % 128 == 0
    for tag in ("table_raw", "searcher_raw", "table_refine10", "searcher_refine10"):
        assert len(rec[tag]["b1_launches"]) == probe.REPS  # 0 each on the CPU: no kernel
    assert rec["table_raw"]["recall@10"] == rec["searcher_raw"]["recall@10"]
    assert rec["table_refine10"]["recall@10"] == rec["searcher_refine10"]["recall@10"]
    assert rec["table_refine10"]["recall@10"] >= rec["table_raw"]["recall@10"]


def test_probe_table_and_truth(scale_run):
    """The table holds the script's rows in id order; the ground truth is
    a numpy brute force's top-10."""
    _, work, _, q, gt = scale_run
    cents, chunks, want_q = _script_data(N, CH)
    np.testing.assert_array_equal(q, want_q)
    tbl = lancedb_tpu_torch.connect(str(work / "db"), device="cpu").open_table("data")
    out = tbl.to_arrow()
    np.testing.assert_array_equal(np.asarray(out["id"]), np.arange(N))
    x = np.concatenate(chunks)
    np.testing.assert_array_equal(
        np.asarray(out["vector"].combine_chunks().flatten()).reshape(N, D), x)
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    d = (q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T) + (x64 * x64).sum(1)[None, :]
    want = np.argsort(d, axis=1, kind="stable")[:, :K]
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(gt, want)]) == 1.0


def test_raw_recall_matches_reference_build(scale_run):
    """The port's build (res_free) and the reference's on the same rows
    reach raw recall@10 within 0.03 of each other."""
    rec, _, ref_root, q, gt = scale_run
    out = (lancedb_tpu.connect(str(ref_root)).open_table("data").search(q)
           .nprobes(probe.NPROBES).limit(K).select(["id"]).to_arrow())
    ref_recall = _recall(probe.hit_ids(out), gt)
    assert abs(rec["table_raw"]["recall@10"] - ref_recall) <= 0.03, (rec["table_raw"], ref_recall)


def _searchers(root, name):
    """(reference searcher, port searcher) over the index ``name`` of the
    table at ``root``."""
    ref_ds = lancedb_tpu.connect(str(root)).open_table("data")._dataset
    port_ds = lancedb_tpu_torch.connect(str(root), device="cpu").open_table("data")._dataset
    ref_meta = next(ix for ix in ref_ds.manifest.indices if ix.name == name)
    port_meta = next(ix for ix in port_ds.manifest.indices if ix.name == name)
    return (ref_vector.load_searcher(ref_ds, ref_meta),
            port_vector.load_searcher(port_ds, port_meta, "cpu"))


@pytest.mark.parametrize("builder", ["reference", "port"])
def test_cross_loaded_top10(scale_run, builder):
    """Each package's searcher on the other's index gives the builder's
    own top-10 exactly (raw, nprobes 20)."""
    _, work, ref_root, q, _ = scale_run
    root, name = (ref_root, "ref_pq") if builder == "reference" else (work / "db",
                                                                      probe.INDEX_NAME)
    ref_sp, port_sp = _searchers(root, name)
    want_d, want_r = ref_sp.search(q, ref_vector.SearchParams(k=K, nprobes=probe.NPROBES))
    got_d, got_r = port_sp.search(q, port_vector.SearchParams(k=K, nprobes=probe.NPROBES))
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def _clustered(rng, n, d, k):
    cent = rng.standard_normal((k, d)).astype(np.float32) * 3.0
    return (cent[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("batch", [None, 4], ids=["unbatched", "batched"])
def test_kmeans_chunked_equals_unchunked(monkeypatch, metric, batch):
    """Lloyd with the product bound forced to about 700 rows a chunk
    (ragged last chunk) gives the unchunked call's assignments, its
    centroids to rtol 1e-6 / atol 1e-6, and no (B, rows, K) f32 product
    above the bound; at the default bound the sample is one call."""
    rng = np.random.default_rng(9)
    n, d, k, iters = 3000, 16, 32, 15
    b = batch or 1
    x = np.stack([_clustered(rng, n, d, k) for _ in range(b)])
    init = np.stack([x[i, rng.choice(n, k, replace=False)] for i in range(b)])
    reseed = rng.integers(0, n, (iters, k)).astype(np.int32)
    args = [torch.from_numpy(x if batch else x[0]), torch.from_numpy(init if batch else init[0]),
            torch.from_numpy(reseed)]
    shapes = []
    real_assign = port_kmeans._assign

    def spy(x_lp, x_n2, cents, metric_):
        shapes.append((x_lp.shape[0], x_lp.shape[1], cents.shape[1]))
        return real_assign(x_lp, x_n2, cents, metric_)

    monkeypatch.setattr(port_kmeans, "_assign", spy)
    want_c, want_a = port_kmeans.kmeans_fit_device(*args, k=k, max_iters=iters, metric=metric)
    assert all(rows == n for _, rows, _ in shapes)
    shapes.clear()
    bound = 4 * b * k * 700
    monkeypatch.setattr(port_kmeans, "ASSIGN_PRODUCT_BYTES", bound)
    got_c, got_a = port_kmeans.kmeans_fit_device(*args, k=k, max_iters=iters, metric=metric)
    assert shapes and all(4 * bb * rows * kk <= bound for bb, rows, kk in shapes)
    assert {rows for _, rows, _ in shapes} == {700, n % 700}
    assert torch.equal(got_a, want_a)
    np.testing.assert_allclose(got_c.numpy(), want_c.numpy(), rtol=1e-6, atol=1e-6)


def test_kmeans_bound_leaves_small_builds_whole():
    """At the default bound the builds that fit run as one product: path
    a's 262,144-row sample at 1024 partitions (1 GiB), a 16 x 65,536 x 256
    PQ training; path i's and the 30M point's 1,048,576 x 4096 (17.2 GB)
    is split into chunks of 131,072 rows (2 GiB)."""
    bound = port_kmeans.ASSIGN_PRODUCT_BYTES
    assert 4 * 1 * 262_144 * 1024 <= bound
    assert 4 * 16 * 65_536 * 256 <= bound
    assert bound // (4 * 1 * 4096) == 131_072
