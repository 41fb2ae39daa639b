"""The rest of the reference's surface in lancedb_tpu_torch (device="cpu"),
against lancedb_tpu: the expression DSL, the metrics recorder, the pyarrow
dataset adapters, the Scannable sources, the REST, ColBERT and
model-package rerankers, the blocked top-k, the test utilities and the
exported names; and the rule that nothing falls back to the CPU.

The same seeded inputs go through both packages and the outputs are
compared exactly: SQL strings, counters, tables, request bytes (the REST
rerankers' requests are recorded by one mock on 127.0.0.1), scores and
orders, top-k values and ids with their ties. Every server runs under a
``with`` block or a fixture that stops it, and nothing leaves 127.0.0.1.
"""

import json
import stat
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pytest
import torch

import lancedb_tpu
import lancedb_tpu.expr
import lancedb_tpu.integrations
import lancedb_tpu.metrics
import lancedb_tpu.rerankers
import lancedb_tpu.scannable
import lancedb_tpu.test_utils
import lancedb_tpu_torch
import lancedb_tpu_torch.expr
import lancedb_tpu_torch.integrations
import lancedb_tpu_torch.metrics
import lancedb_tpu_torch.rerankers
import lancedb_tpu_torch.scannable
import lancedb_tpu_torch.test_utils
from conftest import make_vector_table

REPO = Path(__file__).resolve().parent.parent
PKGS = {"port": lancedb_tpu_torch, "ref": lancedb_tpu}
DEV = {"port": {"device": "cpu"}, "ref": {}}


def _tables(tmp_path, data, name="t"):
    return {side: PKGS[side].connect(str(tmp_path / side), **DEV[side]).create_table(name, data)
            for side in PKGS}


# ------------------------------------------------------------ 1. expr

EXPRS = {
    "range": lambda e: (e.col("id") >= 10) & (e.col("id") < 20),
    "in_between": lambda e: e.col("label").is_in(["item-0", "item-1"])
    | e.col("price").between(0, 1),
    "arithmetic": lambda e: (e.col("id") * 2 + 1) > 35,
    "strings": lambda e: e.col("label").upper().like("ITEM-%") & e.col("label")
    .starts_with("item-0"),
    "negation_nulls": lambda e: ~(e.col("id") < 10) | e.col("price").is_null(),
    "modulo_lit": lambda e: (e.col("id") + e.lit(1)) % 3 == 0,
}


@pytest.mark.parametrize("case", sorted(EXPRS))
def test_expr_renders_the_reference_sql(tmp_path, case):
    got = EXPRS[case](lancedb_tpu_torch.expr)
    want = EXPRS[case](lancedb_tpu.expr)
    assert got.sql() == want.sql()
    assert (lancedb_tpu_torch.expr.expr_to_sql_string(got)
            == lancedb_tpu.expr.expr_to_sql_string(want))
    tables = _tables(tmp_path, make_vector_table(50))
    assert tables["port"].count_rows(got.sql()) == tables["ref"].count_rows(want.sql())


# --------------------------------------------------------- 2. metrics


def _recorded(mod):
    rec = mod.MetricsRecorder()
    rec.increment_counter("queries", labels={"table": "t"})
    rec.increment_counter("queries", 2, labels={"table": "t"})
    rec.increment_counter("bytes", 10.5)
    rec.set_gauge("device_bytes", 123.0, labels={"dev": "0"})
    for v in (0.003, 0.004, 0.2, 5.0, 50.0):
        rec.record_histogram("latency", v)
    return rec.snapshot(), rec.metrics_catalog()


def test_metrics_recorder_matches_the_reference():
    assert _recorded(lancedb_tpu_torch.metrics) == _recorded(lancedb_tpu.metrics)


def _vector_queries(mod) -> float:
    return sum(c["value"] for c in mod.snapshot_metrics()["counters"]
               if c["name"] == "lancedb.queries" and c["labels"] == {"table": "metrics_t",
                                                                       "kind": "vector"})


def test_query_counter_matches_the_reference(tmp_path):
    """``lancedb.queries`` counts each vector search call, a batch of
    query vectors once, in both packages."""
    data = make_vector_table(100)
    q = np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32)
    deltas = []
    tables = _tables(tmp_path, data, "metrics_t")
    for side, mod in (("port", lancedb_tpu_torch.metrics), ("ref", lancedb_tpu.metrics)):
        t = tables[side]
        before = _vector_queries(mod)
        t.search(q[0]).limit(3).to_arrow()
        t.search(q).limit(3).to_arrow()
        t.search(q[1]).where("id < 50").limit(3).to_arrow()
        deltas.append(_vector_queries(mod) - before)
        assert "lancedb.queries" in mod.metrics_catalog()
    assert deltas[0] == deltas[1] == 3


def test_otel_bridge():
    pytest.importorskip("opentelemetry")
    got = lancedb_tpu_torch.metrics.instrument_lancedb_metrics()
    want = lancedb_tpu.metrics.instrument_lancedb_metrics()
    assert type(got).__name__ == type(want).__name__


# --------------------------------------------- 3. the pyarrow adapters

ADAPTER_CASES = {
    "protocol": lambda ds: [ds.count_rows(), ds.count_rows(filter="id < 10"),
                            ds.schema.names, ds.head(3, columns=["id"])],
    "scanner": lambda ds: [list(ds.scanner(columns=["id"], filter="id >= 50", batch_size=16)
                                .to_batches()),
                           ds.scanner(columns=["id"], filter="id >= 50").count_rows()],
    "expression_filter": lambda ds: ds.to_table(columns=["id", "label"],
                                                filter=pc.field("id") < 7),
    "take_sort": lambda ds: [ds.take([5, 1, 9], columns=["id"]),
                             ds.sort_by([("id", "descending")]).slice(0, 5)],
    "head_expression": lambda ds: ds.head(10, filter=pc.field("id") >= 50),
}


@pytest.mark.parametrize("case", sorted(ADAPTER_CASES))
def test_pyarrow_adapters(tmp_path, case):
    tables = _tables(tmp_path, make_vector_table(100))
    out = {}
    for side, mod in (("port", lancedb_tpu_torch), ("ref", lancedb_tpu)):
        ds = mod.integrations.to_pyarrow_dataset(tables[side])
        assert isinstance(ds, pads.Dataset)
        out[side] = ADAPTER_CASES[case](ds)
    _equal(out["port"], out["ref"])


def _equal(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, (pa.Table, pa.RecordBatch)):
        assert got.equals(want), (got, want)
    else:
        assert got == want, (got, want)


# ------------------------------------------------------ 4. Scannable


def _ids(n=10):
    return pa.table({"id": pa.array(np.arange(n, dtype=np.int64))})


def _parquet(path, n=20):
    if not path.exists():
        pads.write_dataset(_ids(n), str(path), format="parquet")
    return pads.dataset(str(path))


SOURCES = {
    "table": lambda p: _ids(7),
    "batch": lambda p: _ids(3).to_batches()[0],
    "reader": lambda p: pa.RecordBatchReader.from_batches(_ids(5).schema, _ids(5).to_batches()),
    "rows_list": lambda p: [{"a": 1}, {"a": 2}],
    "dict": lambda p: {"a": [1, 2, 3]},
    "pyarrow_dataset": lambda p: _parquet(p),
    "scanner": lambda p: _parquet(p).scanner(columns=["id"]),
    "batch_iterator": lambda p: iter(_ids(9).to_batches(max_chunksize=3)),
    "row_iterator": lambda p: iter([{"a": 1}, {"a": 2}]),
    "empty_iterator": lambda p: iter([]),
}


def _scan_twice(make):
    try:
        s = make()
    except ValueError as exc:
        return [("raised", str(exc))]
    first = s.reader().read_all()
    try:
        second = ("ok", s.reader().read_all())
    except ValueError as exc:
        second = ("raised", str(exc))
    return [s.schema, s.num_rows, s.rescannable, first, second]


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_to_scannable(tmp_path, case):
    got = _scan_twice(lambda: lancedb_tpu_torch.scannable.to_scannable(
        SOURCES[case](tmp_path / "ds")))
    want = _scan_twice(lambda: lancedb_tpu.scannable.to_scannable(SOURCES[case](tmp_path / "ds")))
    assert repr(got) == repr(want)
    if case == "empty_iterator":
        assert got == [("raised", "cannot infer a schema from an empty iterator")]
    else:
        assert isinstance(got[0], pa.Schema) and got[3].equals(want[3])


def test_add_streams_a_pyarrow_dataset(tmp_path):
    """Table.add takes a dataset through to_scannable: one commit, the
    same rows as the reference's."""
    n = 5000
    src = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "vector": pa.FixedSizeListArray.from_arrays(
            pa.array(np.random.default_rng(0).standard_normal(n * 4).astype(np.float32)), 4),
    })
    pads.write_dataset(src, str(tmp_path / "parquet"), format="parquet")
    out = []
    for side in PKGS:
        t = PKGS[side].connect(str(tmp_path / side), **DEV[side]).create_table(
            "t", schema=src.schema)
        t.add(pads.dataset(str(tmp_path / "parquet")))
        t.add(pads.dataset(str(tmp_path / "parquet")).scanner(filter=pc.field("id") < 10))
        out.append([t.count_rows(), len(t.list_versions()), t.to_arrow().sort_by("id")])
    assert out[0][:2] == out[1][:2] == [n + 10, 3] and out[0][2].equals(out[1][2])


# ------------------------------------------------------ 5. rerankers


class _MockRerankApi(BaseHTTPRequestHandler):
    """The providers' rerank endpoints, scoring by word overlap; every
    request is recorded (path, headers but the host, body)."""

    log: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        raw = self.rfile.read(int(self.headers["content-length"]))
        self.log.append((self.path, sorted((k.lower(), v) for k, v in self.headers.items()
                                           if k.lower() != "host"), raw))
        body = json.loads(raw) if raw[:1] == b"{" else {}
        path = self.path.split("?")[0]
        if path in ("/v2/rerank", "/v1/rerank"):
            return self._json({"results": [{"index": i, "relevance_score": _overlap(
                body["query"], d)} for i, d in enumerate(body["documents"])]})
        if path == "/identity/token":
            return self._json({"access_token": "tok-1", "expiration": 4102444800})
        if path == "/ml/v1/text/rerank":
            return self._json({"results": [{"index": i, "score": _overlap(body["query"],
                                                                          d["text"])}
                                            for i, d in enumerate(body["inputs"])]})
        if path == "/v1/chat/completions":
            prompt = body["messages"][0]["content"]
            query = next(l for l in prompt.splitlines() if l.startswith("Query: "))[7:]
            docs = [l.split("] ", 1)[1] for l in prompt.splitlines()
                    if l.startswith("[") and "] " in l]
            order = sorted(range(len(docs)), key=lambda i: -_overlap(query, docs[i]))
            return self._json({"choices": [{"message": {"content": json.dumps(order)}}]})
        return self._json({"error": path}, 404)

    def _json(self, obj, code=200):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


def _overlap(query: str, doc: str) -> float:
    q, d = set(query.lower().split()), set(doc.lower().split())
    return len(q & d) / max(len(q), 1)


@pytest.fixture(scope="module")
def mock_api():
    handler = type("Mock", (_MockRerankApi,), {"log": []})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", handler.log
    srv.shutdown()
    thread.join(timeout=5)


def _results():
    vec = pa.table({"_rowid": pa.array([0, 1, 3], pa.uint64()),
                    "text": ["slow green turtle", "quick brown fox", "a brown dog"],
                    "_distance": pa.array([0.1, 0.4, 0.5], pa.float32())})
    fts = pa.table({"_rowid": pa.array([2, 1], pa.uint64()),
                    "text": ["lazy dog sleeps", "quick brown fox"],
                    "_score": pa.array([3.0, 1.0], pa.float32())})
    return vec, fts


REST = {
    "cohere": ("CohereReranker", {}),
    "jina": ("JinaReranker", {"top_n": 2}),
    "voyageai": ("VoyageaiReranker", {}),
    "watsonx": ("WatsonxReranker", {"project_id": "p1"}),
    "openai": ("OpenaiReranker", {}),
}


@pytest.mark.parametrize("case", sorted(REST))
def test_rest_rerankers(mock_api, case):
    url, log = mock_api
    name, kw = REST[case]
    if case == "watsonx":
        kw = {**kw, "iam_url": url}
    out = []
    for mod in (lancedb_tpu_torch.rerankers, lancedb_tpu.rerankers):
        log.clear()
        rr = getattr(mod, name)(api_key="k", base_url=url, **kw)
        vec, fts = _results()
        tables = [rr.rerank_hybrid("quick brown fox", vec, fts),
                  rr.rerank_vector("brown dog", vec), rr.rerank_fts("lazy dog", fts)]
        out.append((tables, list(log)))
    (got, got_log), (want, want_log) = out
    assert got_log == want_log and got_log
    for g, w in zip(got, want):
        assert g.equals(w), (g, w)
    assert got[0].column("text")[0].as_py() == "quick brown fox"


def test_rest_reranker_without_a_key(mock_api, monkeypatch):
    monkeypatch.delenv("COHERE_API_KEY", raising=False)
    msgs = []
    for mod in (lancedb_tpu_torch.rerankers, lancedb_tpu.rerankers):
        rr = mod.CohereReranker(base_url=mock_api[0])
        with pytest.raises(Exception, match="COHERE_API_KEY") as e:
            rr.rerank_hybrid("x", *_results())
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


def _word_encoder(cls):
    """A ColBERT reranker whose token encoder hashes words to one-hot rows
    (crc32, the same in every process), so MaxSim is a word overlap."""
    import zlib

    class _Words(cls):
        def _encode(self, texts):
            out = []
            for t in texts:
                words = t.lower().split() or ["_"]
                vecs = np.zeros((len(words), 32), np.float32)
                for i, w in enumerate(words):
                    vecs[i, zlib.crc32(w.encode()) % 32] = 1.0 + 0.01 * i
                out.append(vecs)
            return out

    return _Words


def test_colbert_scores_and_order(monkeypatch):
    got_rr = _word_encoder(lancedb_tpu_torch.rerankers.ColbertReranker)(device="cpu")
    want_rr = _word_encoder(lancedb_tpu.rerankers.ColbertReranker)()
    vec, fts = _results()
    for method, args in (("rerank_hybrid", ("quick brown fox", vec, fts)),
                         ("rerank_vector", ("brown dog", vec)), ("rerank_fts", ("lazy dog", fts))):
        got, want = getattr(got_rr, method)(*args), getattr(want_rr, method)(*args)
        assert got.column_names == want.column_names
        assert got.column("_rowid").equals(want.column("_rowid"))
        np.testing.assert_allclose(np.asarray(got["_relevance_score"]),
                                   np.asarray(want["_relevance_score"]), rtol=1e-6)
    # the reranker's device is the card unless it says otherwise: no CPU fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _word_encoder(lancedb_tpu_torch.rerankers.ColbertReranker)().rerank_vector(
                "brown dog", vec)


@pytest.mark.parametrize("name", ["CrossEncoderReranker", "AnswerdotaiRerankers"])
def test_model_rerankers_without_their_package(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    monkeypatch.setitem(sys.modules, "rerankers", None)
    msgs = []
    for mod in (lancedb_tpu_torch.rerankers, lancedb_tpu.rerankers):
        with pytest.raises(RuntimeError) as e:
            getattr(mod, name)()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------ 6. top-k


def _blocks(seed: int, nb: int, q: int, b: int, ties: bool):
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 4, (nb, q, b)) if ties else rng.standard_normal((nb, q, b)))
    ids = rng.permutation(nb * q * b).reshape(nb, q, b).astype(np.int64)
    return d.astype(np.float32), ids


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("ids_1d", [False, True], ids=["ids_2d", "ids_1d"])
def test_blocked_topk_scan(ties, ids_1d):
    import jax.numpy as jnp

    from lancedb_tpu.ops.topk import blocked_topk_scan as ref_scan
    from lancedb_tpu_torch.ops.topk import blocked_topk_scan as port_scan

    nb, q, b, k = 5, 6, 12, 10
    d, ids = _blocks(3, nb, q, b, ties)
    if ids_1d:
        ids = ids[:, 0, :]
    dj, ij = jnp.asarray(d), jnp.asarray(ids)
    want_v, want_i = ref_scan(lambda i: (dj[i], ij[i]), nb, k, q)
    for exact in (True, False):
        got_v, got_i = port_scan(lambda i: (torch.from_numpy(d[i]), torch.from_numpy(ids[i])),
                                 nb, k, q, exact=exact)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    flat_d = np.moveaxis(d, 0, 1).reshape(q, -1)
    np.testing.assert_array_equal(got_v.numpy(), np.sort(flat_d, axis=1, kind="stable")[:, :k])


def test_merge_topk_ties_go_to_the_first_set():
    import jax.numpy as jnp

    from lancedb_tpu.ops.topk import merge_topk as ref_merge
    from lancedb_tpu_torch.ops.topk import merge_topk as port_merge

    rng = np.random.default_rng(9)
    va, vb = (np.sort(rng.integers(0, 3, (4, 6)), axis=1).astype(np.float32) for _ in range(2))
    ia, ib = np.arange(24).reshape(4, 6), 100 + np.arange(24).reshape(4, 6)
    got = port_merge(*(torch.from_numpy(a) for a in (va, ia, vb, ib)), 7)
    want = ref_merge(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ 7. the test utilities


def test_local_test_connection(tmp_path):
    from lancedb_tpu_torch.test_utils import new_test_connection, random_vector_table

    tc = new_test_connection(device="cpu")
    with tc as conn:
        assert conn.device.type == "cpu"
        assert conn.create_table("t", random_vector_table(50, dim=8)).count_rows() == 50
    assert not Path(tc._tmpdir).exists()
    assert random_vector_table(30, 8, seed=4).equals(
        lancedb_tpu.test_utils.random_vector_table(30, 8, seed=4))
    fn = lancedb_tpu_torch.test_utils.MockTextEmbeddingFunction(8)
    np.testing.assert_array_equal(
        fn.compute_source_embeddings(["x", "y"]),
        lancedb_tpu.test_utils.MockTextEmbeddingFunction(8).compute_source_embeddings(["x", "y"]))


def test_test_connection_spawns_the_port_server(tmp_path, monkeypatch):
    """With the script set, new_test_connection spawns
    ``python -m lancedb_tpu_torch.remote.server DIR --port 0 --device cpu``,
    reads its port and connects through db://."""
    from lancedb_tpu_torch.errors import InvalidInputError
    from lancedb_tpu_torch.test_utils import new_test_connection

    script = tmp_path / "spawn_node.sh"
    script.write_text(f'#!/bin/sh\ncd "{REPO}" && exec "{sys.executable}" -m '
                      f'lancedb_tpu_torch.remote.server "{tmp_path / "served"}" --port 0 '
                      f'--device cpu\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CREATE_LANCEDB_TEST_CONNECTION_SCRIPT", str(script))
    with pytest.raises(InvalidInputError, match="owns the device"):
        new_test_connection(device="cpu")
    tc = new_test_connection()
    try:
        tc.connection.create_table("t", [{"id": 1}, {"id": 2}])
        assert tc.connection.table_names() == ["t"]
        assert tc.connection.open_table("t").count_rows() == 2
    finally:
        tc.close()
    assert tc._process.returncode is not None


# ------------------------------------------------ 8. names, no fallback


def test_exported_names_cover_the_reference():
    import lancedb_tpu.remote
    import lancedb_tpu_torch.remote

    assert set(lancedb_tpu.__all__) <= set(lancedb_tpu_torch.__all__)
    assert lancedb_tpu_torch.__version__ == lancedb_tpu.__version__
    for mod in ("rerankers", "remote", "integrations"):
        assert (getattr(lancedb_tpu_torch, mod).__all__ == getattr(lancedb_tpu, mod).__all__), mod
    for name in lancedb_tpu_torch.__all__:
        assert getattr(lancedb_tpu_torch, name) is not None, name


def test_no_cpu_fallback_without_a_card(tmp_path):
    """The server, the catalogues and the rerankers default to the card
    and raise without one; none picks the CPU by itself."""
    from lancedb_tpu_torch.remote import QueryServer

    if torch.cuda.is_available():
        pytest.skip("the refusals hold where there is no card")

    lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", make_vector_table(8))
    for call in (lambda: QueryServer(str(tmp_path)),
                 lambda: lancedb_tpu_torch.connect_namespace(str(tmp_path)),
                 lambda: lancedb_tpu_torch.NamespaceServer(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with lancedb_tpu_torch.NamespaceServer(str(tmp_path), device="cpu") as srv:
        client = lancedb_tpu_torch.connect_namespace_client(srv.address)
        assert client.list_tables() == ["t"]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            client.open_table(["t"])
