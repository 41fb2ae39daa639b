"""Full-text search, scalar indexes, rerankers and substrait filters:
lancedb_tpu_torch (device="cpu") against lancedb_tpu on the same seeded
inputs.

The whole layer is host code in both packages, and the FTS scorers are the
same C++ source (native/lancedb_native.cpp), built once for each package.
So ids must be equal, ties included, and scores equal to 1e-6. Indexes
are compared both ways: each package searches the index the other one
built.
"""

import sys

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu import errors as ref_errors
from lancedb_tpu import query_fts as ref_q
from lancedb_tpu.filters.sql import parse_sql_expr as ref_parse
from lancedb_tpu.index import fts as ref_fts
from lancedb_tpu.index import scalar as ref_scalar
from lancedb_tpu.index.tokenizer import Tokenizer as RefTokenizer
from lancedb_tpu.native import native_available as ref_native_available
from lancedb_tpu.query import compute_allowed_rowids as ref_allowed
from lancedb_tpu_torch import errors as port_errors
from lancedb_tpu_torch import query_fts as port_q
from lancedb_tpu_torch.filters.sql import parse_sql_expr as port_parse
from lancedb_tpu_torch.index import fts as port_fts
from lancedb_tpu_torch.index import scalar as port_scalar
from lancedb_tpu_torch.index.tokenizer import Tokenizer as PortTokenizer
from lancedb_tpu_torch.native import native_available
from lancedb_tpu_torch.query import compute_allowed_rowids as port_allowed

PKGS = {"ref": lancedb_tpu, "port": lancedb_tpu_torch}


def make_corpus(rng, n, vocab=30_000):
    """bench.py:426's generator: Zipf(1.3) word ranks, 8-word docs."""
    ranks = np.clip(rng.zipf(1.3, size=n * 8), 1, vocab) - 1
    docs = np.char.add("w", ranks.astype("U6")).reshape(n, 8)
    return [" ".join(row) for row in docs]


def _connect(pkg, path):
    if pkg == "port":
        return lancedb_tpu_torch.connect(path, device="cpu")
    return lancedb_tpu.connect(path)


def _open_both(path, name):
    return {p: _connect(p, path).open_table(name) for p in PKGS}


# ------------------------------------------------------------- tokenizer

TOKENIZER_CASES = [
    ({}, "The Quick Brown Foxes JUMPED over the lazy dogs' running-shoes"),
    ({}, "Café naïve résumé Ærøskøbing crème brûlée"),
    ({"stem": False, "remove_stop_words": False}, "The runners were running and ran"),
    ({"ascii_folding": False}, "Café naïve résumé"),
    ({"max_token_length": 5}, "antidisestablishment is a long word"),
    ({"base": "whitespace", "lower_case": False}, "Hello  World\tTabs, punct!"),
    ({"base": "raw"}, "Keep This Whole"),
    ({"base": "ngram", "ngram_min_length": 2, "ngram_max_length": 4}, "search engine"),
    ({"base": "ngram", "prefix_only": True}, "prefix only grams"),
    ({"base": "cjk", "stem": False}, "机器学习 neural 東京"),
    ({"base": "lindera", "stem": False}, "東京都に住んでいます。日本語の形態素解析"),
    ({"base": "jieba", "stem": False}, "我爱自然语言处理"),
    ({"base": "unicode"}, "e-mail U.S.A. 3.14 foo_bar ｶﾀｶﾅ 한국어 naïve"),
    ({"language": "French"}, "les chevaux mangeaient rapidement"),
]


@pytest.mark.parametrize("cfg,text", TOKENIZER_CASES)
def test_tokenizer_matches_reference(cfg, text):
    assert PortTokenizer(**cfg).tokenize(text) == RefTokenizer(**cfg).tokenize(text)
    assert PortTokenizer(**cfg).effective_scheme() == RefTokenizer(**cfg).effective_scheme()


# ----------------------------------------------------------- FTS builds

BUILD_DOCS = make_corpus(np.random.default_rng(7), 5000) + ["", None, "W1 w1 w1 café"]


@pytest.mark.parametrize("builder", ["native", "python"])
@pytest.mark.parametrize("with_position", [True, False])
def test_build_matches_reference(builder, with_position, monkeypatch):
    assert native_available() and ref_native_available()
    if builder == "python":  # the builders' pure-Python loop
        monkeypatch.setattr("lancedb_tpu_torch.native.fts_build_native", lambda *a, **k: None)
        monkeypatch.setattr("lancedb_tpu.native.fts_build_native", lambda *a, **k: None)
    rowids = np.arange(len(BUILD_DOCS), dtype=np.uint64) + (np.uint64(3) << np.uint64(32))
    got = port_fts._build_column_index(BUILD_DOCS, rowids, PortTokenizer(), with_position)
    want = ref_fts._build_column_index(BUILD_DOCS, rowids, RefTokenizer(), with_position)
    assert got.vocab == want.vocab
    for name in ("df", "postings_offsets", "postings_docs", "postings_tf", "doc_lens",
                 "doc_rowids", "pos_offsets", "positions"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name


# ------------------------------------------------- FTS search, both ways

N_DOCS = 3000
BIG_DOCS = 70_000  # above 65,536: plain OR queries take the native pruned scorer


def _fts_data(n, seed):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    text = make_corpus(rng, n, vocab=400)
    title = make_corpus(rng, n, vocab=60)
    return pa.table({"id": ids, "category": ids % 10, "text": text, "title": title})


@pytest.fixture(scope="module")
def fts_dbs(tmp_path_factory):
    """Per building package: a table with an FTS index on text (positions),
    one with a combined index on text and title, a 70,000-doc table, and
    the first table again with rows deleted after the build."""
    out = {}
    for pkg in PKGS:
        path = str(tmp_path_factory.mktemp(f"fts_{pkg}"))
        db = _connect(pkg, path)
        t = db.create_table("docs", _fts_data(N_DOCS, 1))
        t.create_fts_index("text", with_position=True)
        m = db.create_table("multi", _fts_data(N_DOCS, 2))
        m.create_fts_index(["text", "title"], with_position=False)
        b = db.create_table("big", _fts_data(BIG_DOCS, 3))
        b.create_fts_index("text", with_position=False)
        d = db.create_table("deleted", _fts_data(N_DOCS, 1))
        d.create_fts_index("text", with_position=True)
        d.delete("id % 7 = 3")
        out[pkg] = path
    return out


def _fts_queries(q):
    """(table, query, fts_columns, where) for the query package ``q``."""
    return [
        ("docs", "w1 w17", None, None),
        ("docs", q.MatchQuery("w1 w5 w12", "text", operator=q.Operator.AND), None, None),
        ("docs", q.MatchQuery("w2 w9", "text", operator=q.Operator.AND), None, None),
        ("docs", '"w0 w1"', None, None),
        ("docs", q.PhraseQuery("w1 w2", "text", slop=2), None, None),
        ("docs", q.MatchQuery("w5 w11", "text", boost=2.5), None, None),
        ("docs", q.BoostQuery(q.MatchQuery("w1", "text"), q.MatchQuery("w2", "text"),
                              negative_boost=0.3), None, None),
        ("docs", q.BooleanQuery([(q.Occur.MUST, q.MatchQuery("w0", "text")),
                                 (q.Occur.SHOULD, q.MatchQuery("w7", "text")),
                                 (q.Occur.MUST_NOT, q.MatchQuery("w3", "text"))]), None, None),
        ("docs", q.MatchQuery("w1234", "text", fuzziness=1), None, None),
        ("docs", "w1 w17", None, "category = 3"),
        ("docs", '"w0 w1"', None, "id < 1500 AND category != 2"),
        ("multi", q.MultiMatchQuery("w4 w8", ["text", "title"], boosts=[1.0, 2.0]), None, None),
        ("multi", "w4 w8", ["title"], None),
        ("multi", "w6", None, None),
        ("big", "w2 w30", None, None),
        ("big", "w0 w1", None, None),
        ("big", "w5 w6 w7", None, None),
        ("big", q.MatchQuery("w3 w4", "text", operator=q.Operator.AND), None, None),
        ("deleted", "w1 w17", None, None),
        ("deleted", '"w0 w1"', None, None),
        ("deleted", q.MatchQuery("w2 w9", "text", operator=q.Operator.AND), None, "category < 5"),
    ]


def _run_fts(tbl, query, cols, where):
    b = tbl.search(query, query_type="fts", fts_columns=cols).limit(10).with_row_id()
    if where:
        b = b.where(where)
    return b.to_arrow()


@pytest.mark.parametrize("builder", list(PKGS))
@pytest.mark.parametrize("case", range(len(_fts_queries(ref_q))))
def test_fts_search_matches_reference(fts_dbs, builder, case):
    name, ref_query, cols, where = _fts_queries(ref_q)[case]
    port_query = _fts_queries(port_q)[case][1]
    tbls = _open_both(fts_dbs[builder], name)
    want = _run_fts(tbls["ref"], ref_query, cols, where)
    got = _run_fts(tbls["port"], port_query, cols, where)
    assert want.num_rows > 0, "the case must hit"
    assert got.column_names == want.column_names
    assert np.array_equal(got["_rowid"], want["_rowid"])
    np.testing.assert_allclose(got["_score"], want["_score"], rtol=0, atol=1e-6)
    assert got.drop_columns(["_score"]).equals(want.drop_columns(["_score"]))
    if where:
        assert got.equals(_run_fts(tbls["port"], port_query, cols, where))


def test_tokenize_and_refusals(fts_dbs, monkeypatch):
    tbls = _open_both(fts_dbs["ref"], "docs")
    text = "The Runners were RUNNING"
    assert ([(t.text, t.position) for t in tbls["port"].tokenize(text)]
            == [(t.text, t.position) for t in tbls["ref"].tokenize(text)])
    # a text query for the vector leg needs an embedding function (and this
    # table has no vector column): the reference's InvalidInputError in both
    with pytest.raises(port_errors.InvalidInputError) as got:
        tbls["port"].search("w1", query_type="vector")
    with pytest.raises(ref_errors.InvalidInputError) as want:
        tbls["ref"].search("w1", query_type="vector")
    assert str(got.value) == str(want.value)
    # the rerankers are ported: a cross-encoder without its package raises
    # the reference's error, and a REST reranker without its key raises the
    # reference's error when it is called (never at construction)
    import lancedb_tpu.rerankers as ref_rr
    import lancedb_tpu_torch.rerankers as port_rr

    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    monkeypatch.delenv("COHERE_API_KEY", raising=False)
    msgs = []
    for rr in (port_rr, ref_rr):
        with pytest.raises(RuntimeError) as got:
            rr.CrossEncoderReranker()
        msgs.append(str(got.value))
        with pytest.raises(Exception, match="COHERE_API_KEY") as got:
            rr.CohereReranker(base_url="http://127.0.0.1:9")._key()
        msgs.append(str(got.value))
    assert msgs[:2] == msgs[2:]


# ------------------------------------------------------- scalar indexes


def _scalar_data(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    num = pa.array(rng.integers(0, 500, n), mask=rng.random(n) < 0.05)
    tags = [list(rng.choice(["a", "b", "c", "d", "e"], int(rng.integers(0, 3)), replace=False))
            for _ in range(n)]
    names = [f"{rng.choice(['alpha', 'beta', 'gamma'])}-{i % 37}-x" for i in range(n)]
    return pa.table({"id": ids, "num": num, "cat": pa.array((ids % 10).astype(np.int64),
                                                           mask=ids % 97 == 5),
                     "tags": pa.array(tags, pa.list_(pa.string())), "name": names})


SCALAR_PREDICATES = [
    "num = 42", "num IN (1, 2, 3, 400)", "num < 100", "num >= 450", "num > 10 AND num <= 20",
    "num BETWEEN 10 AND 20", "cat = 3", "cat IN (3, 4)", "cat = 3 OR cat = 7",
    "cat = 3 AND num < 250", "NOT (cat = 3)", "num IS NULL", "cat IS NULL",
    "array_has(tags, 'a')", "array_has(tags, 'a') OR array_has(tags, 'e')",
    "name LIKE '%-12-%'", "name LIKE 'beta%'",
    "name LIKE '%-x'", "name LIKE 'alpha-1_-x'", "cat = 2 OR num > 480",
]


@pytest.fixture(scope="module")
def scalar_dbs(tmp_path_factory):
    out = {}
    for pkg in PKGS:
        path = str(tmp_path_factory.mktemp(f"scalar_{pkg}"))
        t = _connect(pkg, path).create_table("s", _scalar_data())
        t.create_scalar_index("num", index_type="BTREE")
        t.create_scalar_index("cat", index_type="BITMAP")
        t.create_scalar_index("tags", index_type="LABEL_LIST")
        t.create_scalar_index("name", index_type="FM")
        out[pkg] = path
    return out


@pytest.mark.parametrize("builder", list(PKGS))
@pytest.mark.parametrize("pred", SCALAR_PREDICATES)
def test_scalar_prefilter_matches_reference(scalar_dbs, builder, pred):
    tbls = _open_both(scalar_dbs[builder], "s")
    got = port_scalar.try_scalar_prefilter(tbls["port"], port_parse(pred))
    want = ref_scalar.try_scalar_prefilter(tbls["ref"], ref_parse(pred))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == want.dtype and np.array_equal(got, want)
    scan = tbls["port"]._dataset.to_table(columns=[], predicate=pred, with_row_id=True)
    scan = np.sort(scan.column("_rowid").to_numpy().astype(np.uint64))
    allowed = port_allowed(tbls["port"], pred)
    assert np.array_equal(allowed, scan)
    assert np.array_equal(allowed, ref_allowed(tbls["ref"], pred))


def test_auto_index_routes_scalar_to_btree(tmp_path):
    t = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("s", _scalar_data())
    t.create_index(vector_column_name="num", index_type="AUTO")
    assert [(ix.index_type, ix.columns) for ix in t._dataset.manifest.indices] == [
        ("BTREE", ["num"])]


# ------------------------------------------------------------ rerankers


def _legs():
    rng = np.random.default_rng(3)
    v_ids = rng.choice(60, 12, replace=False).astype(np.uint64)
    f_ids = np.concatenate([v_ids[[2, 7, 0]], rng.choice(np.arange(60, 90), 9, replace=False)])
    vec = pa.table({"id": v_ids.astype(np.int64), "_distance": np.sort(rng.random(12)).astype(
        np.float32), "_rowid": pa.array(v_ids, pa.uint64())})
    fts = pa.table({"id": f_ids.astype(np.int64), "_score": np.sort(rng.random(12))[::-1].astype(
        np.float32), "_rowid": pa.array(f_ids.astype(np.uint64), pa.uint64())})
    return vec, fts


@pytest.mark.parametrize("name,kwargs", [
    ("RRFReranker", {}), ("RRFReranker", {"K": 5, "return_score": "all"}),
    ("LinearCombinationReranker", {}),
    ("LinearCombinationReranker", {"weight": 0.2, "return_score": "all"}),
    ("MRRReranker", {}), ("MRRReranker", {"return_score": "all"}),
])
def test_reranker_matches_reference(name, kwargs):
    import lancedb_tpu.rerankers as ref_r
    import lancedb_tpu_torch.rerankers as port_r

    vec, fts = _legs()
    got = getattr(port_r, name)(**kwargs).rerank_hybrid("q", vec, fts)
    want = getattr(ref_r, name)(**kwargs).rerank_hybrid("q", vec, fts)
    assert got.equals(want)
    assert np.array_equal(port_r.normalize_scores(vec["_distance"].to_numpy(), invert=True),
                          ref_r.normalize_scores(vec["_distance"].to_numpy(), invert=True))


# ------------------------------------------------------------- substrait

SUBSTRAIT_SCHEMA = pa.schema([
    ("id", pa.int64()), ("cat", pa.int64()), ("x", pa.float64()),
    ("name", pa.string()), ("ok", pa.bool_()),
])


@pytest.mark.parametrize("expr", [
    (pc.field("cat") == 3) & (pc.field("x") > 0.5),
    (pc.field("name") == "it's") | ~pc.field("ok"),
    pc.field("x").is_null(),
    pc.field("cat").isin([1, 2, 3]),
    (pc.field("cat") >= 1) & (pc.field("cat") <= 5) & (pc.field("x").is_valid()),
])
def test_substrait_matches_reference(expr):
    ps = pytest.importorskip("pyarrow.substrait")
    from lancedb_tpu.filters.substrait import substrait_to_sql as ref_sql
    from lancedb_tpu_torch.filters.substrait import substrait_to_sql as port_sql

    blob = ps.serialize_expressions([expr], ["filter"], SUBSTRAIT_SCHEMA)
    assert port_sql(blob) == ref_sql(blob)
