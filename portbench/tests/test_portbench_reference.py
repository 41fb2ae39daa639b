"""The reference's exact top-k, cosine, filter, precision rounding and
build checks against NumPy brute force, and the comparison's numbers on
answers that are right and on answers that are wrong in one way each."""

import numpy as np
import pytest
import torch

from portbench.reference import build, exact, judge

CFG = {"metric": "l2", "category_mod": 10, "search": {"k": 5},
       "limits": {"miscount": 0, "dupes": 0, "misordered": 0, "hydrate_bad": 0,
                  "filter_bad": 0, "dist_gap": 1e-4, "recall": 0.95, "misplaced": 0,
                  "assign_miss": 0.0, "code_miss": 0.0, "quant_excess": 0.05}}


def data(metric="l2", n=3000, d=24, nq=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def numpy_topk(x, q, k, metric, allowed=None):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        d = 1.0 - q64 @ x64.T
    else:
        d = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    if allowed is not None:
        d = np.where(allowed[None, :], d, np.inf)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, 1), i


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("filtered", [False, True])
def test_exact_topk_matches_numpy(metric, filtered, monkeypatch):
    monkeypatch.setattr(exact, "ROW_BLOCK", 700)  # several blocks
    x, q = data(metric)
    allowed = (np.arange(len(x)) % 10 == 3) if filtered else None
    want_d, want_i = numpy_topk(x, q, 5, metric, allowed)
    got_d, got_i = exact.topk(torch.from_numpy(x), torch.from_numpy(q), 5, metric,
                              None if allowed is None else torch.from_numpy(allowed))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("precision,rel", [("tf32", 2**-11), ("bfloat16", 2**-8),
                                           ("float16", 2**-11)])
def test_round_to_keeps_the_mantissa(precision, rel):
    # normal numbers of every format (float16's smallest is 6.1e-5)
    x = torch.sign(torch.randn(1000, 16)) * (0.01 + 3 * torch.rand(1000, 16))
    r = exact.round_to(x, precision)
    assert torch.all((r - x).abs() <= x.abs() * rel * 1.0001)
    assert not torch.equal(r, x)


@pytest.mark.parametrize("precision,rel", [("fp8", 2**-4), ("int8", 1 / 254)])
def test_round_to_scaled_formats(precision, rel):
    x = torch.randn(200, 64)
    r = exact.round_to(x, precision)
    amax = x.abs().amax(1, keepdim=True)
    assert torch.all((r - x).abs() <= amax * rel * 1.01)


def test_control_precision_reorders_and_moves_distances():
    x, q = data(n=2000)
    d32, i32 = exact.topk(torch.from_numpy(x), torch.from_numpy(q), 5, "l2")
    d8, i8 = exact.topk(torch.from_numpy(x), torch.from_numpy(q), 5, "l2", precision="fp8")
    assert (d8.double() - d32).abs().max() > 1e-3


def exact_answers(x, q, cfg, where=None):
    allowed = None if where is None else judge.predicate_mask(np.arange(len(x)), where, cfg)
    d, i = numpy_topk(x, q, cfg["search"]["k"], cfg["metric"], allowed)
    return {"ids": i, "dists": d, "category": i % 10, "vector": x[i]}


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_judge_passes_exact_answers(metric):
    cfg = dict(CFG, metric=metric)
    x, q = data(metric)
    out = judge.judge_search(torch.from_numpy(x), torch.from_numpy(q),
                             exact_answers(x, q, cfg, "category = 3"), cfg, "category = 3")
    assert all(c["ok"] for c in out.values()), out
    assert out["recall"]["value"] == 1.0 and out["dist_gap"]["value"] < 1e-9


@pytest.mark.parametrize("fault,number", [
    ("drop_half", "miscount"), ("repeat", "dupes"), ("reverse", "misordered"),
    ("category", "hydrate_bad"), ("vector", "hydrate_bad"), ("unfiltered", "filter_bad"),
    ("distance", "dist_gap"), ("other_row", "dist_gap"), ("far_rows", "recall"),
])
def test_judge_flags_each_fault(fault, number):
    x, q = data()
    where = "category = 3"
    ans = exact_answers(x, q, CFG, where)
    if fault == "drop_half":
        ans["ids"][len(q) // 2:] = -1
    elif fault == "repeat":
        ans["ids"][0, 1] = ans["ids"][0, 0]
    elif fault == "reverse":
        ans["dists"] = ans["dists"][:, ::-1].copy()
    elif fault == "category":
        ans["category"] = ans["category"] + 1
    elif fault == "vector":
        ans["vector"] = ans["vector"].copy()
        ans["vector"][0, 0, 0] += 1e-3
    elif fault == "unfiltered":
        ans = exact_answers(x, q, CFG, None)
    elif fault == "distance":
        ans["dists"] = ans["dists"] * (1 + 1e-3)
    elif fault == "other_row":
        ans["ids"][0, 0] = (ans["ids"][0, 0] + 10) % len(x)
        ans["category"] = ans["ids"] % 10
        ans["vector"] = x[ans["ids"]]
    elif fault == "far_rows":
        d, i = numpy_topk(x, q, 60, "l2", judge.predicate_mask(np.arange(len(x)), where, CFG))
        ans = {"ids": i[:, 50:55], "dists": d[:, 50:55], "category": i[:, 50:55] % 10,
               "vector": x[i[:, 50:55]]}
    out = judge.judge_search(torch.from_numpy(x), torch.from_numpy(q), ans, CFG, where)
    assert not out[number]["ok"], out


def test_predicate_mask():
    ids = np.arange(30)
    assert np.array_equal(judge.predicate_mask(ids, "category = 3", CFG), ids % 10 == 3)
    assert np.array_equal(judge.predicate_mask(ids, "id < 7", CFG), ids < 7)
    with pytest.raises(ValueError):
        judge.predicate_mask(ids, "category in (1, 2)", CFG)


def lower_median(v):
    """torch.median's: the lower of the two middle values."""
    return np.sort(v)[(len(v) - 1) // 2]


def numpy_build_checks(x, index, sample):
    """(the worst relative excess of a row's centroid distance over its
    nearest, the same of its codes, the share of codes not the nearest)"""
    cents, books = index["centroids"].astype(np.float64), index["codebooks"].astype(np.float64)
    b = index["block_of_row"][sample]
    xs = x[sample].astype(np.float64)
    d = ((xs[:, None, :] - cents[None]) ** 2).sum(-1)
    assign_gap = (d[np.arange(len(b)), b] - d.min(1)).max() / lower_median(d.min(1))
    s, _, dsub = books.shape
    r = (xs - cents[b]).reshape(len(b), s, dsub)
    e = ((r[:, :, None, :] - books[None]) ** 2).sum(-1)
    codes = index["codes"][sample]
    c_ch = np.take_along_axis(e, codes[:, :, None], 2)[:, :, 0]
    code_gap = (c_ch.sum(1) - e.min(2).sum(1)).max() / lower_median(e.min(2).sum(1))
    return assign_gap, code_gap, float((c_ch > e.min(2) * (1 + 1e-9)).mean())


def tiny_index():
    return {"num_partitions": 16, "num_sub_vectors": 4, "num_bits": 4, "sample_rate": 64,
            "max_iterations": 10}


def test_reference_build_is_optimal_for_its_own_centroids():
    x, _ = data(n=2000, d=16)
    idx = build.build_ivf_pq(torch.from_numpy(x), tiny_index(), seed=3)
    canon = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in idx.items()}
    sample = np.arange(0, 2000, 7)
    a, c, miss = numpy_build_checks(x, canon, sample)
    assert a == 0 and c <= 1e-12 and miss == 0
    assert canon["block_of_row"].min() >= 0 and canon["codes"].max() < 16


def test_judge_build_matches_numpy_and_flags_faults():
    x, _ = data(n=2000, d=16)
    xt = torch.from_numpy(x)
    idx = build.build_ivf_pq(xt, tiny_index(), seed=3)
    canon = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in idx.items()}
    sample = torch.arange(0, 2000, 7)
    ref_err = judge.reference_error(xt[sample], sample, canon)
    ok = judge.judge_build(xt[sample], sample, canon, ref_err, CFG)
    assert all(v["ok"] for v in ok.values()), ok
    assert abs(ok["quant_excess"]["value"]) < 1e-12
    bad = dict(canon, codes=(canon["codes"] + 1) % 16)
    out = judge.judge_build(xt[sample], sample, bad, ref_err, CFG)
    _, c, _ = numpy_build_checks(x, bad, sample.numpy())
    _, _, miss = numpy_build_checks(x, bad, sample.numpy())
    assert not out["code_miss"]["ok"]
    assert out["code_miss"]["value"] == pytest.approx(miss, rel=1e-12)
    moved = dict(canon, block_of_row=(canon["block_of_row"] + 1) % 16)
    assert not judge.judge_build(xt[sample], sample, moved, ref_err, CFG)["assign_miss"]["ok"]


def test_canonical_index_counts_misplaced_rows():
    # 3 blocks of pmax 4, 8 rows, codes (B, S_pad=8, pmax) with S=2
    row_ids = np.array([[0, 1, 2, -1], [3, 4, 4, -1], [5, 6, -1, -1]])
    codes = np.arange(3 * 8 * 4).reshape(3, 8, 4).astype(np.uint8)
    canon = judge.canonical_index(np.zeros((3, 4)), row_ids, codes, np.zeros((2, 16, 2)), 8)
    assert canon["misplaced"] == 2  # row 7 missing, row 4 twice
    assert canon["block_of_row"].tolist() == [0, 0, 0, 1, 1, 2, 2, -1]
    assert canon["codes"][5].tolist() == [codes[2, 0, 0], codes[2, 1, 0]]


def test_worst_takes_each_numbers_worst_reading():
    a = {"gap": judge.check(0.1, 1, "<="), "recall": judge.check(0.99, 0.9, ">=")}
    b = {"gap": judge.check(0.3, 1, "<="), "recall": judge.check(0.97, 0.9, ">=")}
    w = judge.worst([a, b])
    assert w["gap"]["value"] == 0.3 and w["recall"]["value"] == 0.97
