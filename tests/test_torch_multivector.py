"""Multivector (ColBERT-style MaxSim) search: lancedb_tpu_torch
(device="cpu") against lancedb_tpu on the same seeded token bags.

MaxSim scores agree to 1e-5 (absolute, on scores of at most the number of
query tokens); searches give the same ids in the same order and
distances (−MaxSim) to 1e-5, without a token index, with a token index
built by either package, with a prefilter and a postfilter, with an
offset and with a single-token query. Mirrors tests/test_multivector.py.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import multivector as ref_mv
from lancedb_tpu_torch.index import multivector as port_mv

DIM, NDOC, NCLUSTER = 16, 80, 4


def _table(seed=3):
    rng = np.random.default_rng(seed)
    bases = rng.standard_normal((NCLUSTER, DIM)).astype(np.float32) * 3.0
    rows = []
    for i in range(NDOC):
        n_tok = int(rng.integers(2, 9))
        toks = bases[i % NCLUSTER] + rng.standard_normal((n_tok, DIM)).astype(np.float32)
        rows.append(toks.astype(np.float32).tolist())
    ids = np.arange(NDOC)
    return pa.table({
        "id": ids, "cluster": ids % NCLUSTER,
        "vector": pa.array(rows, type=pa.list_(pa.list_(pa.float32(), DIM))),
    }), bases, rng


TABLE, BASES, RNG = _table()
QUERIES = [(BASES[i % NCLUSTER] + RNG.standard_normal((n, DIM))).astype(np.float32)
           for i, n in enumerate((4, 1, 6, 3))]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(port, reference) handles on one table per index case: 'none', or
    a token index built by 'port' or by 'ref'."""
    made = {}

    def get(index):
        if index not in made:
            path = str(tmp_path_factory.mktemp(f"mv_{index}"))
            lancedb_tpu.connect(path).create_table("t", TABLE)
            if index == "ref":
                lancedb_tpu.connect(path).open_table("t").create_index(vector_column_name="vector")
            elif index == "port":
                lancedb_tpu_torch.connect(path, device="cpu").open_table("t").create_index(
                    vector_column_name="vector")
            made[index] = path
        path = made[index]
        return (lancedb_tpu_torch.connect(path, device="cpu").open_table("t"),
                lancedb_tpu.connect(path).open_table("t"))

    return get


def test_maxsim_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    docs = [rng.standard_normal((int(n), DIM)).astype(np.float32) for n in (1, 4, 7, 2, 0, 3)]
    got = port_mv.maxsim_rescore(q, docs, device="cpu")
    want = np.asarray(ref_mv.maxsim_rescore(q, docs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the product itself, on padded inputs
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    padded = rng.standard_normal((6, 7, DIM)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([1, 4, 7, 2, 0, 3])[:, None]
    got = port_mv.maxsim(torch.from_numpy(qn), torch.from_numpy(padded), torch.from_numpy(mask))
    want = ref_mv._maxsim_device(jnp.asarray(qn), jnp.asarray(padded), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert port_mv.maxsim_rescore(np.eye(2, dtype=np.float32),
                                  [np.eye(2, dtype=np.float32), np.eye(2, dtype=np.float32)[:1]],
                                  device="cpu").tolist() == [2.0, 1.0]


def test_token_index_matches_reference(tables):
    """The port's token index holds the reference's files: unit tokens and
    each token's parent row id, metric cosine, flagged multivector."""
    port, _ = tables("port")
    ref, _ = tables("ref")
    metas = [t._dataset.manifest.indices[0] for t in (port, ref)]
    for m in metas:
        assert m.index_type == "FLAT"
        assert m.params["multivector"] and m.params["metric"] == "cosine"
    arrays = [{n: np.load(t._dataset.store.local_path(f"{t._dataset.index_dir(m.uuid)}/{n}.npy"))
               for n in ("vectors", "row_ids")} for t, m in zip((port, ref), metas)]
    np.testing.assert_array_equal(arrays[0]["row_ids"], arrays[1]["row_ids"])
    np.testing.assert_allclose(arrays[0]["vectors"], arrays[1]["vectors"], rtol=1e-6, atol=1e-7)
    assert len(np.unique(arrays[0]["row_ids"])) == NDOC < len(arrays[0]["row_ids"])


CASES = {
    "plain": lambda s: s.limit(5),
    "prefilter": lambda s: s.where("id >= 9").limit(5),
    "postfilter": lambda s: s.where("id % 3 != 1").postfilter().limit(8),
    "offset": lambda s: s.limit(4).offset(3),
    "bypass_index": lambda s: s.bypass_vector_index().limit(5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("index", ["none", "port", "ref"])
def test_search_matches_reference(tables, index, case):
    port, ref = tables(index)
    for qi, q in enumerate(QUERIES):
        query = q.tolist() if len(q) > 1 else [q[0].tolist()]  # a single-token bag too
        got = CASES[case](port.search(query)).to_arrow()
        want = CASES[case](ref.search(query)).to_arrow()
        assert got.num_rows == want.num_rows > 0, (qi, case)
        assert got.column_names == want.column_names
        np.testing.assert_array_equal(np.asarray(got["id"]), np.asarray(want["id"]))
        np.testing.assert_allclose(np.asarray(got["_distance"]), np.asarray(want["_distance"]),
                                   rtol=1e-5, atol=1e-5)
        if case == "prefilter":
            assert np.all(np.asarray(got["id"]) >= 9)
        if case == "postfilter":
            assert np.all(np.asarray(got["id"]) % 3 != 1)


def test_brute_force_and_index_agree(tables):
    """With and without the token index the port finds the query's
    cluster, in ascending distance."""
    for index in ("none", "port"):
        port, _ = tables(index)
        for qi, q in enumerate(QUERIES):
            out = port.search(q.tolist()).limit(5).to_arrow()
            assert np.all(np.asarray(out["cluster"]) == qi % NCLUSTER)
            d = np.asarray(out["_distance"])
            assert np.all(np.diff(d) >= 0)


def test_nested_python_lists_become_multivector(tmp_path):
    """list<list<float>> with a constant inner length is a multivector
    column, searchable by late interaction (reference
    TestMultivectorInference)."""
    t = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table(
        "mvinf", {"id": [1, 2], "emb": [[[1.0, 0.0], [0.5, 0.5]], [[0.0, 1.0]]]})
    assert port_mv.is_multivector_type(t.schema.field("emb").type)
    assert t.search([[0.0, 1.0]], vector_column_name="emb").limit(1).to_list()[0]["id"] == 2
