"""lancedb_tpu_torch.ops against lancedb_tpu.ops on the same seeded inputs (CPU).

Tolerances: selections (top-k ids, k-means assignments, PQ codes) are
exact; f32 values agree to rtol 1e-5 (the two packages sum in other
orders), with an atol of 1e-5 of the largest magnitude where values
cancel towards 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lancedb_tpu.index import vector as jvec
from lancedb_tpu.ops import distance as jdist
from lancedb_tpu.ops import kmeans as jkm
from lancedb_tpu.ops import pq as jpq
from lancedb_tpu.ops import topk as jtopk
from lancedb_tpu_torch.index import vector as tvec
from lancedb_tpu_torch.ops import distance as tdist
from lancedb_tpu_torch.ops import kmeans as tkm
from lancedb_tpu_torch.ops import prng
from lancedb_tpu_torch.ops import pq as tpq
from lancedb_tpu_torch.ops import topk as ttopk

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * float(np.abs(want).max()))


def _clustered(rng, n, d, centers=8):
    cent = rng.standard_normal((centers, d)).astype(np.float32) * 4.0
    return (cent[rng.integers(0, centers, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_topk_smallest(k):
    rng = np.random.default_rng(k)
    d = rng.standard_normal((5, 300)).astype(np.float32)
    d[:, 10:20] = d[:, 10:11]  # exact ties resolve lower index first in both
    jv, ji = jtopk.topk_smallest(jnp.asarray(d), k)
    tv, ti = ttopk.topk_smallest(torch.from_numpy(d), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv.numpy(), jv)


def test_merge_and_mask_topk():
    rng = np.random.default_rng(1)
    va, vb = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2))
    ia, ib = (rng.integers(0, 1000, (4, 6)) for _ in range(2))
    jv, ji = jtopk.merge_topk(*map(jnp.asarray, (va, ia, vb, ib)), 5)
    tv, ti = ttopk.merge_topk(*map(torch.from_numpy, (va, ia, vb, ib)), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv.numpy(), jv)
    d = rng.standard_normal((3, 50)).astype(np.float32)
    valid = rng.random((3, 50)) < 0.5
    jv, ji = jtopk.mask_and_topk(jnp.asarray(d), jnp.asarray(valid), 8)
    tv, ti = ttopk.mask_and_topk(torch.from_numpy(d), torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_pairwise_distance(metric):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    x = rng.standard_normal((200, 24)).astype(np.float32)
    want = np.asarray(jdist.pairwise_distance(jnp.asarray(q), jnp.asarray(x), metric))
    got = tdist.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric).numpy()
    _close(got, want)
    np.testing.assert_array_equal(np.argsort(got, 1, kind="stable")[:, :10],
                                  np.argsort(want, 1, kind="stable")[:, :10])


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_refine_distances(metric):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    c = rng.standard_normal((5, 12, 16)).astype(np.float32)
    want = jdist.refine_distances(jnp.asarray(q), jnp.asarray(c), metric)
    got = tdist.refine_distances(torch.from_numpy(q), torch.from_numpy(c), metric)
    _close(got.numpy(), want)


def test_metric_and_subvector_defaults():
    for m in ("L2", "euclidean", "cos", "ip", "dot"):
        assert tdist.normalize_metric(m) == jdist.normalize_metric(m)
    with pytest.raises(ValueError):
        tdist.normalize_metric("manhattan")
    for dim in (128, 96, 24, 7):
        assert tpq.default_num_sub_vectors(dim) == jpq.default_num_sub_vectors(dim)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_kmeans_fit_from_shared_init(metric):
    """Lloyd from the same seeding and reseed rows: same centroids and
    assignments."""
    rng = np.random.default_rng(4)
    x = _clustered(rng, 600, 16)
    init = x[rng.choice(600, 8, replace=False)]
    reseed = rng.integers(0, 600, (20, 8)).astype(np.int32)
    jc, ja = jkm.kmeans_fit_device(jnp.asarray(x), jnp.asarray(init), jnp.asarray(reseed),
                                   k=8, max_iters=20, metric=metric)
    tc, ta = tkm.kmeans_fit_device(torch.from_numpy(x), torch.from_numpy(init),
                                   torch.from_numpy(reseed), k=8, max_iters=20, metric=metric)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tc.numpy(), jc)


def test_kmeanspp_seeding_is_seeded():
    """k-means++ from a key picks the reference's rows from the same key,
    one key per batch member when batched."""
    xn = _clustered(np.random.default_rng(5), 400, 8)
    x = torch.from_numpy(xn)
    a = tkm.kmeanspp_init_device(x, prng.prng_key(3), k=6)
    b = tkm.kmeanspp_init_device(x, prng.prng_key(3), k=6)
    assert torch.equal(a, b)
    want = jkm.kmeanspp_init_device(jnp.asarray(xn), jax.random.PRNGKey(3), k=6)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    xb = np.stack([xn, xn[::-1].copy(), xn * 2.0])
    got = tkm.kmeanspp_init_device(torch.from_numpy(xb), prng.split(prng.prng_key(9), 3), k=5)
    want = jax.vmap(lambda xs, kk: jkm.kmeanspp_init_device(xs, kk, k=5))(
        jnp.asarray(xb), jax.random.split(jax.random.PRNGKey(9), 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every seed is a data row, and no row is picked twice
    rows = {tuple(r) for r in x.numpy().tolist()}
    assert all(tuple(r) in rows for r in a.numpy().tolist())
    assert len({tuple(r) for r in a.numpy().tolist()}) == 6


@pytest.mark.parametrize("seed", [0, 41536, 2**31 - 1])
def test_prng_draws_match_jax(seed):
    """prng computes jax.random's threefry draws: keys, splits, bits and
    randint exactly, Gumbel noise to 1e-6 absolute (the logarithms
    differ in the last bit)."""
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    np.testing.assert_array_equal(prng.split(tkey, 192).numpy(),
                                  np.asarray(jax.random.split(key, 192)).astype(np.int64))
    k0, kg = jax.random.split(key)
    tk0, tkg = prng.split(tkey)
    for n in (1, 400, 65_536, 1_000_000):
        assert int(prng.randint(tk0, n)) == int(jax.random.randint(k0, (), 0, n))
    np.testing.assert_array_equal(
        prng.random_bits(tkg, 0, 1000).numpy(),
        np.asarray(jax.random.bits(kg, (1000,), dtype=jnp.uint32)).astype(np.int64))
    want = np.asarray(jax.random.gumbel(kg, (5, 300), dtype=jnp.float32))
    got = prng.gumbel(tkg, 0, 1500).numpy().reshape(5, 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(prng.gumbel(tkg, 600, 300).numpy(), got[2])


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_assign_residuals(metric):
    rng = np.random.default_rng(6)
    x = _clustered(rng, 500, 16)
    cents = x[:10].copy()
    ja, jr = jkm.assign_residuals_device(jnp.asarray(x), jnp.asarray(cents), metric=metric,
                                         chunk=100)
    ta, tr = tkm.assign_residuals_device(torch.from_numpy(x), torch.from_numpy(cents),
                                         metric=metric, chunk=100)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tr.numpy(), jr)


def test_pq_encode_rnorms_from_shared_codebooks():
    rng = np.random.default_rng(7)
    res = rng.standard_normal((300, 16)).astype(np.float32)
    cents = rng.standard_normal((4, 16)).astype(np.float32)
    assign = rng.integers(0, 4, 300).astype(np.int32)
    cb = rng.standard_normal((4, 16, 4)).astype(np.float32)
    jc, jr = jpq._encode_rnorms_device(
        jnp.asarray(res), jnp.asarray(cents), jnp.asarray(assign), jnp.asarray(cb),
        jnp.zeros((1, 1), jnp.float32), chunk=100, has_rotation=False,
    )
    tc, tr = tpq._encode_rnorms_device(torch.from_numpy(res), torch.from_numpy(cents),
                                       torch.from_numpy(assign), torch.from_numpy(cb), chunk=100)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(tr.numpy(), jr)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_select_probes_and_dlut(metric):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    cents = rng.standard_normal((40, 16)).astype(np.float32)
    cents[5] = cents[4]  # duplicate-centroid blocks tie; both pick the lower id
    jp, jd = jvec._select_probes(jnp.asarray(q), jnp.asarray(cents), 7, metric)
    tp, td = tvec._select_probes(torch.from_numpy(q), torch.from_numpy(cents), 7, metric)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(td.numpy(), jd)
    cb = rng.standard_normal((4, 16, 4)).astype(np.float32)
    _close(tvec._pq_dlut(torch.from_numpy(q), torch.from_numpy(cb), 8).numpy(),
           jvec._pq_dlut(jnp.asarray(q), jnp.asarray(cb), 8))
