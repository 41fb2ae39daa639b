"""Embedding functions: lancedb_tpu_torch (device="cpu") against
lancedb_tpu on the same seeded inputs.

The registry, its providers and the schema-metadata JSON under
``b"embedding_functions"`` (the state that carries a table's functions
across the two packages) must be identical; embedded floats equal; text
searches of a hash-embedded table give the reference's ids on tables
written by either package, through the vector, ``auto`` and one-string
hybrid dispatch. Distances are held to ROADMAP §C's bound (1.3e-5
relative, 1e-5 absolute at |q|² = 1). The multimodal and REST cases
mirror tests/test_embeddings_multimodal.py and tests/test_embeddings_rest.py;
the REST providers talk to a mock on 127.0.0.1, and the requests each
package sends must be the same.
"""

import hashlib
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.embeddings as ref_emb
import lancedb_tpu.embeddings.multimodal as ref_mm
import lancedb_tpu.embeddings.rest_providers as ref_rest
import lancedb_tpu.pydantic as ref_pyd
import lancedb_tpu_torch
import lancedb_tpu_torch.embeddings as port_emb
import lancedb_tpu_torch.embeddings.multimodal as port_mm
import lancedb_tpu_torch.embeddings.rest_providers as port_rest
import lancedb_tpu_torch.pydantic as port_pyd
from lancedb_tpu_torch.errors import InvalidInputError

PKGS = ("port", "ref")
EMB = {"port": port_emb, "ref": ref_emb}
MM = {"port": port_mm, "ref": ref_mm}
PYD = {"port": port_pyd, "ref": ref_pyd}
DIM = 8  # the REST mock's width
HASH_DIM = 32
EXPECTED_PROVIDERS = {
    "bedrock-text", "cohere", "colpali", "gemini-text", "gte-text", "hash",
    "huggingface", "imagebind", "instructor", "jinaai", "ollama",
    "open-clip", "openai", "sentence-transformers", "siglip", "voyageai",
    "watsonx",
}


def _docs(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    ranks = np.clip(rng.zipf(1.3, size=n * 8), 1, 300) - 1
    return [" ".join(r) for r in np.char.add("w", ranks.astype("U4")).reshape(n, 8)]


DOCS = _docs(120, 5)
QUERIES = [DOCS[3], DOCS[40], "w1 w2 w7", "w0 w0 w13 w99"]


def _connect(pkg, path):
    if pkg == "port":
        return lancedb_tpu_torch.connect(str(path), device="cpu")
    return lancedb_tpu.connect(str(path))


def _hash_doc_model(pkg):
    fn = EMB[pkg].get_registry().get("hash").create(dim=HASH_DIM)

    class Doc(PYD[pkg].LanceModel):
        id: int
        text: str = fn.SourceField()
        vector: PYD[pkg].Vector(HASH_DIM) = fn.VectorField()
        category: int

    return Doc


def _rows(ids) -> list[dict]:
    return [{"id": int(i), "text": DOCS[i], "category": int(i) % 10} for i in ids]


def _hash_table(pkg, path, streamed=False):
    t = _connect(pkg, path).create_table("docs", schema=_hash_doc_model(pkg))
    if streamed:
        sch = pa.schema([("id", pa.int64()), ("text", pa.string()), ("category", pa.int64())])
        batches = [pa.RecordBatch.from_pylist(_rows(range(s, min(s + 50, len(DOCS)))), schema=sch)
                   for s in range(0, len(DOCS), 50)]
        t.add(pa.RecordBatchReader.from_batches(sch, batches))
    else:
        t.add(_rows(range(len(DOCS))))
    return t


def _same_hits(got: pa.Table, want: pa.Table) -> None:
    assert got.column_names == want.column_names
    np.testing.assert_array_equal(np.asarray(got["id"]), np.asarray(want["id"]))
    for col in ("_distance", "_relevance_score", "_score"):
        if col in want.column_names:
            np.testing.assert_allclose(np.asarray(got[col]), np.asarray(want[col]),
                                       rtol=1.3e-5, atol=1e-5)


@pytest.fixture
def tables(tmp_path):
    return {pkg: _hash_table(pkg, tmp_path / pkg) for pkg in PKGS}


# ------------------------------------------------------------ the registry


def test_registry_lists_the_same_providers():
    port, ref = (set(EMB[p].get_registry().list_functions()) for p in PKGS)
    assert port == ref and EXPECTED_PROVIDERS <= port


WEIGHTED = {  # provider → how it is asked for an embedding
    "sentence-transformers": lambda fn: None,
    "huggingface": lambda fn: None,
    "colpali": lambda fn: fn.compute_source_embeddings(["x"]),
    "open-clip": lambda fn: fn.compute_query_embeddings("x"),
    "siglip": lambda fn: fn.compute_query_embeddings("x"),
    "gte-text": lambda fn: fn.compute_source_embeddings(["x"]),
    "instructor": lambda fn: fn.compute_source_embeddings(["x"]),
    "imagebind": lambda fn: None,
}


def _failure(pkg, name) -> str:
    try:
        WEIGHTED[name](EMB[pkg].get_registry().get(name).create())
    except Exception as e:  # the type is what both packages must share
        return type(e).__name__
    return "no error"


@pytest.mark.parametrize("name", sorted(WEIGHTED))
def test_providers_without_weights_raise_as_the_reference(name, monkeypatch):
    """Without their model packages (so without weights), the providers
    register and then raise, at creation or at the first embedding, the
    reference's error. No download is tried."""
    for mod in ("sentence_transformers", "transformers", "InstructorEmbedding", "imagebind"):
        monkeypatch.setitem(sys.modules, mod, None)
    got, want = _failure("port", name), _failure("ref", name)
    assert got == want != "no error"


@pytest.mark.parametrize("kw", [{}, {"dim": 64, "ngram": 2}])
def test_hash_embedding_floats_equal(kw):
    fns = {p: EMB[p].get_registry().get("hash").create(**kw) for p in PKGS}
    texts = DOCS[:40] + ["", None, "Mixed CASE words, with punctuation!"]
    got, want = (fns[p].compute_source_embeddings(texts) for p in PKGS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fns["port"].compute_query_embeddings(QUERIES[2]),
                                  fns["ref"].compute_query_embeddings(QUERIES[2]))
    assert fns["port"].ndims() == fns["ref"].ndims() == kw.get("dim", 256)


def test_mock_text_embedding_equal_within_a_process():
    from lancedb_tpu.test_utils import MockTextEmbeddingFunction as RefMock
    from lancedb_tpu_torch.test_utils import MockTextEmbeddingFunction

    fn = MockTextEmbeddingFunction(8)
    a = fn.compute_source_embeddings(["x", "y"])
    np.testing.assert_array_equal(a, fn.compute_source_embeddings(["x", "y"]))
    assert a.shape == (2, 8) and fn.ndims() == 8
    np.testing.assert_array_equal(a, RefMock(8).compute_source_embeddings(["x", "y"]))
    np.testing.assert_array_equal(fn.compute_query_embeddings(None),
                                  RefMock(8).compute_query_embeddings(None))


def test_schema_metadata_is_byte_identical(tables, tmp_path):
    key = b"embedding_functions"
    assert tables["port"].schema.metadata[key] == tables["ref"].schema.metadata[key]
    # create_table(embedding_functions=...) and the instance-level config
    metas = {}
    for pkg in PKGS:
        e = EMB[pkg]
        t = _connect(pkg, tmp_path / f"defs_{pkg}").create_table(
            "t", [{"body": "a b"}], embedding_functions=[e.EmbeddingDefinition(
                source_column="body", vector_column="emb", function_name="hash",
                config={"dim": 16, "ngram": 2})])
        fn = e.get_registry().get("hash").create(dim=16)
        conf = e.get_registry().get_table_metadata(
            [e.EmbeddingFunctionConfig(function=fn, source_column="body")])
        metas[pkg] = (t.schema.metadata[key], t.schema.field("emb").type, conf)
    assert metas["port"] == metas["ref"]


@pytest.mark.parametrize("streamed", [False, True], ids=["single", "streamed"])
def test_add_embeds_like_the_reference(tmp_path, streamed):
    tbls = {pkg: _hash_table(pkg, tmp_path / pkg, streamed) for pkg in PKGS}
    got, want = (tbls[p].to_arrow().sort_by("id") for p in PKGS)
    assert got.equals(want)
    assert len(tbls["port"]._dataset.manifest.fragments) == (3 if streamed else 1)
    assert list(tbls["port"].embedding_functions) == ["vector"]


@pytest.mark.parametrize("writer", PKGS)
def test_text_search_on_a_table_written_by_either_package(tmp_path, writer):
    """A table written by one package opens in the other with the same
    functions: text searches and appends embed to the same floats."""
    _hash_table(writer, tmp_path / "db")
    tbls = {pkg: _connect(pkg, tmp_path / "db").open_table("docs") for pkg in PKGS}
    for q in QUERIES:
        got, want = (tbls[p].search(q, query_type="vector").limit(6).to_arrow() for p in PKGS)
        _same_hits(got, want)
    v = tbls["port"].embedding_functions["vector"].compute_query_embeddings(QUERIES[2])[0]
    _same_hits(tbls["port"].search(QUERIES[2], query_type="vector").limit(6).to_arrow(),
               tbls["port"].search(v).limit(6).to_arrow())
    tbls["port"].add([{"id": 500, "text": "w5 w6 new", "category": 0}])
    tbls["ref"].add([{"id": 501, "text": "w5 w6 new", "category": 0}])
    tbls = {pkg: _connect(pkg, tmp_path / "db").open_table("docs") for pkg in PKGS}
    new = [tbls[p].search("w5 w6 new", query_type="vector").limit(2).to_arrow() for p in PKGS]
    assert [sorted(t["id"].to_pylist()) for t in new] == [[500, 501]] * 2
    assert max(np.asarray(t["_distance"]).max() for t in new) < 1e-5


def test_auto_dispatch_with_and_without_an_fts_index(tables):
    port_q = lancedb_tpu_torch.query
    for pkg in PKGS:
        assert type(tables[pkg].search(QUERIES[0])).__name__ == "LanceVectorQueryBuilder"
    _same_hits(*(tables[p].search(QUERIES[0]).limit(5).to_arrow() for p in PKGS))
    for pkg in PKGS:
        tables[pkg].create_fts_index("text")
    assert isinstance(tables["port"].search(QUERIES[0]), port_q.LanceFtsQueryBuilder)
    got, want = (tables[p].search(QUERIES[0]).limit(5).to_arrow() for p in PKGS)
    _same_hits(got, want)
    assert "_score" in got.column_names
    # query_type="vector" still embeds the string
    _same_hits(*(tables[p].search(QUERIES[0], query_type="vector").limit(5).to_arrow()
                 for p in PKGS))


def test_one_string_hybrid_single_and_batched(tables):
    for pkg in PKGS:
        tables[pkg].create_fts_index("text")
    for q in QUERIES[:2]:
        _same_hits(*(tables[p].search(q, query_type="hybrid").limit(6).to_arrow() for p in PKGS))

    def batched(t):
        b = t.search(QUERIES[0], query_type="hybrid").limit(6)
        for q in QUERIES[1:]:
            b.add_query(text=q)
        return b.where("category < 7").to_arrow()

    got, want = (batched(tables[p]) for p in PKGS)
    _same_hits(got, want)
    np.testing.assert_array_equal(np.asarray(got["query_index"]), np.asarray(want["query_index"]))


def test_text_query_without_an_embedding_function_is_refused(tmp_path):
    errs = []
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / pkg).create_table("t", pa.table({
            "text": ["a b"], "vector": pa.FixedSizeListArray.from_arrays(
                pa.array(np.zeros(4, np.float32)), 4)}))
        for call in (lambda: t.search("a", query_type="vector"),
                     lambda: t.search("a", query_type="hybrid").to_arrow()):
            with pytest.raises(Exception, match="no embedding function") as e:
                call()
            errs.append(type(e.value).__name__)
    assert set(errs) == {"InvalidInputError"}


# -------------------------------------- multimodal (test_embeddings_multimodal)


def _png_bytes():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (4, 4), (250, 10, 10)).save(buf, format="PNG")
    return buf.getvalue()


def test_sanitize_images_pil_bytes_path(tmp_path):
    from PIL import Image

    raw = _png_bytes()
    p = tmp_path / "img.png"
    p.write_bytes(raw)
    inputs = [Image.new("L", (2, 2)), raw, str(p), f"file://{p}"]
    got, want = (MM[pkg].sanitize_images(inputs) for pkg in PKGS)
    assert len(got) == 4 and all(im.mode == "RGB" for im in got)
    assert [np.asarray(im).tolist() for im in got] == [np.asarray(im).tolist() for im in want]


def test_sanitize_images_bad_input():
    with pytest.raises(InvalidInputError):
        port_mm.sanitize_images([123])
    with pytest.raises(ref_mm.InvalidInputError):
        ref_mm.sanitize_images([123])


POOL_CASES = {
    "halves_count": (np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32), 2,
                     (8, 8)),
    "deterministic": (np.random.default_rng(1).standard_normal((10, 4)).astype(np.float32), 2,
                      (5, 4)),
    "keeps_at_least_one": (np.ones((3, 4), dtype=np.float32), 100, (1, 4)),
    "noop_factor_one": (np.ones((5, 4), dtype=np.float32), 1, (5, 4)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_hierarchical_token_pool(case):
    v, factor, shape = POOL_CASES[case]
    got = port_mm.hierarchical_token_pool(v, factor)
    assert got.shape == shape
    np.testing.assert_array_equal(got, ref_mm.hierarchical_token_pool(v, factor))
    np.testing.assert_array_equal(got, port_mm.hierarchical_token_pool(v, factor))
    if factor == 1:
        assert got is v


def _fake_colpali(pkg):
    class FakeColPali(MM[pkg].ColPaliEmbedding):
        """Deterministic encoder: each item hashes to a (n_tokens, DIM) bag."""

        DIM = 16

        def _encode(self, items, is_query):
            out = []
            for it in items:
                seed = int.from_bytes(hashlib.md5(str(it).encode()).digest()[:4], "little")
                n = 4 if is_query else 8
                out.append(np.random.default_rng(seed).standard_normal(
                    (n, self.DIM)).astype(np.float32))
            return out

    return FakeColPali


def test_colpali_pools_sources_not_queries():
    fns = {pkg: _fake_colpali(pkg)(pool_factor=2) for pkg in PKGS}
    bags = fns["port"].compute_source_embeddings(["a", "b"])
    assert [b.shape for b in bags] == [(4, 16), (4, 16)]  # 8 pooled to 4
    for g, w in zip(bags, fns["ref"].compute_source_embeddings(["a", "b"])):
        np.testing.assert_array_equal(g, w)
    assert fns["port"].compute_query_embeddings("a")[0].shape == (4, 16)  # queries unpooled
    assert issubclass(port_mm.ColPaliEmbedding, port_mm.MultiVectorEmbeddingFunction)
    assert port_emb.MultiVectorEmbeddingFunction is port_mm.MultiVectorEmbeddingFunction


def test_multivector_function_feeds_maxsim(tmp_path):
    """A multivector embedding function creates a multivector column,
    served by MaxSim, as in the reference."""
    out = {}
    for pkg in PKGS:
        reg = EMB[pkg].get_registry()
        reg.register("fake-colpali")(_fake_colpali(pkg))
        try:
            t = _connect(pkg, tmp_path / pkg).create_table(
                "pages", [{"text": w} for w in ("alpha", "bravo", "charlie", "delta")],
                embedding_functions=[EMB[pkg].EmbeddingDefinition(
                    source_column="text", vector_column="embedding",
                    function_name="fake-colpali",
                    config={"ndims": 16, "pooling_strategy": "none"})])
            field = t.schema.field("embedding")
            assert pa.types.is_list(field.type)
            assert pa.types.is_fixed_size_list(field.type.value_type)
            qbag = _fake_colpali(pkg)(pooling_strategy="none")._encode(["bravo"], False)[0]
            out[pkg] = t.search(qbag, vector_column_name="embedding").limit(3).to_arrow()
            assert out[pkg]["text"][0].as_py() == "bravo"
        finally:
            reg._functions.pop("fake-colpali", None)
    assert out["port"]["text"].equals(out["ref"]["text"])
    np.testing.assert_allclose(np.asarray(out["port"]["_distance"]),
                               np.asarray(out["ref"]["_distance"]), rtol=1.3e-5, atol=1e-5)


def test_clip_like_text_vs_image_routing():
    calls = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        class Fake(MM[pkg].OpenClipEmbedding):
            def _embed_text(self, texts, _c=calls[pkg]):
                _c.append(("text", tuple(texts)))
                return np.zeros((len(texts), 4), dtype=np.float32)

            def _embed_images(self, images, _c=calls[pkg]):
                _c.append(("image", len(images)))
                return np.zeros((len(images), 4), dtype=np.float32)

        fn = Fake(ndims=4)
        fn.compute_query_embeddings("a dog")
        fn.compute_source_embeddings(["x.png", "y.jpg"])
    assert calls["port"] == calls["ref"] == [("text", ("a dog",)), ("image", 2)]


# -------------------------------------------------- REST (test_embeddings_rest)


def _vec(text: str) -> list[float]:
    h = np.frombuffer(hashlib.sha256(text.encode()).digest()[: DIM * 4], dtype=np.uint32)
    return (h / np.uint32(0xFFFFFFFF)).astype(float).tolist()


class _MockApi(BaseHTTPRequestHandler):
    """The hosted APIs' response shapes; every request is logged as
    (path, body, content-type, the authorization scheme)."""

    log: list = []
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_POST(self):
        raw = self.rfile.read(int(self.headers["content-length"]))
        try:
            body = json.loads(raw)
        except ValueError:  # form-encoded (watsonx IAM token exchange)
            body = {"form": raw.decode()}
        path = self.path.split("?")[0]
        auth = self.headers.get("authorization", "")
        with self.lock:
            self.log.append((self.path, body, self.headers.get("content-type"),
                             auth.split(" ")[0]))
        if path == "/v1/embeddings":  # openai / voyage / jina
            if not auth:
                return self._json(401, {"error": "missing auth"})
            return self._json(200, {"data": [{"index": i, "embedding": _vec(t)}
                                             for i, t in enumerate(body["input"])]})
        if path == "/v2/embed":  # cohere
            return self._json(200, {"embeddings": {"float": [_vec(t) for t in body["texts"]]}})
        if path.startswith("/v1beta/models/"):  # gemini
            return self._json(200, {"embeddings": [
                {"values": _vec(r["content"]["parts"][0]["text"])} for r in body["requests"]]})
        if path == "/api/embed":  # ollama
            return self._json(200, {"embeddings": [_vec(t) for t in body["input"]]})
        if path.startswith("/model/") and path.endswith("/invoke"):  # bedrock
            if "AWS4-HMAC-SHA256" not in auth or "Signature=" not in auth:
                return self._json(403, {"error": "bad sigv4"})
            if "texts" in body:
                return self._json(200, {"embeddings": [_vec(t) for t in body["texts"]]})
            return self._json(200, {"embedding": _vec(body["inputText"])})
        if path == "/identity/token":  # watsonx IAM exchange
            return self._json(200, {"access_token": "tok-123"})
        if path == "/ml/v1/text/embeddings":  # watsonx
            if auth != "Bearer tok-123":
                return self._json(401, {"error": "bad token"})
            if "project_id" not in body and "space_id" not in body:
                return self._json(400, {"error": "missing project"})
            return self._json(200, {"results": [{"embedding": _vec(t)} for t in body["inputs"]]})
        return self._json(404, {"error": path})

    def _json(self, code, obj):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@pytest.fixture(scope="module")
def mock_api():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _MockApi)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    for pkg in PKGS:
        EMB[pkg].get_registry().set_var("test_api_key", "k")
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _requests(fn):
    """(result of fn(), the requests it sent)."""
    with _MockApi.lock:
        _MockApi.log.clear()
    out = fn()
    with _MockApi.lock:
        return out, list(_MockApi.log)


def _both(fn):
    """fn(pkg) for each package: results equal, requests the same."""
    (got, got_req), (want, want_req) = (_requests(lambda p=p: fn(p)) for p in PKGS)
    assert got_req == want_req and got_req
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name,kwargs", [
    ("openai", {"api_key": "$var:test_api_key"}),
    ("voyageai", {"api_key": "$var:test_api_key"}),
    ("jinaai", {"api_key": "$var:test_api_key"}),
    ("cohere", {"api_key": "$var:test_api_key"}),
    ("gemini-text", {"api_key": "$var:test_api_key"}),
    ("ollama", {}),
])
def test_provider_roundtrip(mock_api, name, kwargs):
    fns = {p: EMB[p].get_registry().get(name).create(base_url=mock_api, ndims=DIM, **kwargs)
           for p in PKGS}
    embs = _both(lambda p: fns[p].compute_source_embeddings(["hello", "world"]))
    assert embs.shape == (2, DIM)
    np.testing.assert_allclose(embs[0], _vec("hello"), rtol=1e-6)
    q = _both(lambda p: fns[p].compute_query_embeddings("hello"))
    np.testing.assert_allclose(q[0], embs[0], rtol=1e-6)
    assert fns["port"].ndims() == DIM


def test_bedrock_titan_and_cohere(mock_api, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    for model in (None, "cohere.embed-english-v3"):
        kw = {"model": model} if model else {}
        fns = {p: EMB[p].get_registry().get("bedrock-text").create(base_url=mock_api, ndims=DIM,
                                                                     **kw) for p in PKGS}
        embs = _both(lambda p: fns[p].compute_source_embeddings(["hello", "world"]))
        np.testing.assert_allclose(embs[0], _vec("hello"), rtol=1e-6)


def test_watsonx_token_exchange(mock_api):
    fns = {p: EMB[p].get_registry().get("watsonx").create(
        base_url=mock_api, iam_url=mock_api, api_key="$var:test_api_key", project_id="p1",
        ndims=DIM) for p in PKGS}
    embs = _both(lambda p: fns[p].compute_source_embeddings(["hello", "world"]))
    assert embs.shape == (2, DIM)
    np.testing.assert_allclose(embs[1], _vec("world"), rtol=1e-6)


def test_watsonx_requires_project_or_space(mock_api):
    for kw in ({}, {"project_id": "a", "space_id": "b"}):
        for pkg in PKGS:
            with pytest.raises(Exception) as e:
                EMB[pkg].get_registry().get("watsonx").create(
                    base_url=mock_api, api_key="$var:test_api_key", **kw)
            assert type(e.value).__name__ == "InvalidInputError"


def test_missing_api_key_message(mock_api, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for pkg in PKGS:
        fn = EMB[pkg].get_registry().get("openai").create(base_url=mock_api, ndims=DIM)
        with pytest.raises(Exception, match="OPENAI_API_KEY"):
            fn.compute_source_embeddings(["x"])


def test_batching_chunks_requests(mock_api):
    fns = {p: EMB[p].get_registry().get("openai").create(
        base_url=mock_api, api_key="$var:test_api_key", ndims=DIM) for p in PKGS}
    texts = [f"t{i}" for i in range(301)]  # > 2 x max_batch (128)
    embs = _both(lambda p: fns[p].compute_source_embeddings(texts))
    assert embs.shape == (301, DIM)
    np.testing.assert_allclose(embs[300], _vec("t300"), rtol=1e-6)


def _openai_docs(pkg, path, mock_api):
    return _connect(pkg, path).create_table(
        "docs", [{"text": "alpha"}, {"text": "bravo"}, {"text": "charlie"}],
        embedding_functions=[EMB[pkg].EmbeddingDefinition(
            source_column="text", vector_column="vector", function_name="openai",
            config={"base_url": mock_api, "api_key": "$var:test_api_key", "ndims": DIM})])


def test_table_auto_embedding(mock_api, tmp_path):
    tbls = {pkg: _openai_docs(pkg, tmp_path / pkg, mock_api) for pkg in PKGS}
    assert tbls["port"].count_rows() == 3
    assert tbls["port"].to_arrow().equals(tbls["ref"].to_arrow())
    hits = _both(lambda p: tbls[p].search("bravo").limit(1).to_arrow()["text"].to_pylist())
    assert list(hits) == ["bravo"]
    assert tbls["port"].search("bravo").limit(1).to_list()[0]["_distance"] < 1e-5


def _sfvf_model(pkg, mock_api, vector_field=True, source_field=True):
    fn = EMB[pkg].get_registry().get("openai").create(
        base_url=mock_api, api_key="$var:test_api_key", ndims=DIM)
    ns = {"__annotations__": {}}
    if source_field:
        ns["__annotations__"]["text"] = str
        ns["text"] = fn.SourceField()
    if vector_field:
        ns["__annotations__"]["vector"] = PYD[pkg].Vector(DIM)
        ns["vector"] = fn.VectorField()
    return type("Doc", (PYD[pkg].LanceModel,), ns)


def test_source_field_vector_field(mock_api, tmp_path):
    tbls = {}
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / pkg).create_table("sfvf", schema=_sfvf_model(pkg, mock_api))
        t.add([{"text": "alpha"}, {"text": "bravo"}])
        tbls[pkg] = t
    hits = _both(lambda p: tbls[p].search("bravo").limit(1).to_arrow()["text"].to_pylist())
    assert list(hits) == ["bravo"]
    # the config round-trips through the schema's metadata: reopening reconnects
    for pkg in PKGS:
        t2 = _connect(pkg, tmp_path / pkg).open_table("sfvf")
        t2.add([{"text": "charlie"}])
        assert t2.search("charlie").limit(1).to_list()[0]["text"] == "charlie"
    assert tbls["port"].to_arrow().equals(tbls["ref"].to_arrow())


def test_source_field_default_vector_column(mock_api, tmp_path):
    schemas = []
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / pkg).create_table(
            "sfonly", schema=_sfvf_model(pkg, mock_api, vector_field=False))
        assert "vector" in t.schema.names
        t.add([{"text": "delta"}])
        assert t.search("delta").limit(1).to_list()[0]["text"] == "delta"
        schemas.append(t.schema)
    assert schemas[0].equals(schemas[1], check_metadata=True)


def test_orphan_vector_field_rejected(mock_api, tmp_path):
    for pkg in PKGS:
        with pytest.raises(Exception, match="SourceField") as e:
            _connect(pkg, tmp_path / pkg).create_table(
                "orphan", schema=_sfvf_model(pkg, mock_api, source_field=False))
        assert type(e.value).__name__ == "InvalidInputError"


def test_sensitive_key_rejected_and_var_persisted(mock_api, tmp_path):
    raws = []
    for pkg in PKGS:
        reg = EMB[pkg].get_registry()
        with pytest.raises(Exception, match="sensitive"):
            reg.get("openai").create(base_url=mock_api, api_key="topsecret")
        reg.set_var("sk_test", "k")
        assert reg.get("openai").create(base_url=mock_api, api_key="$var:sk_test",
                                        ndims=DIM)._api_key == "k"
        t = _connect(pkg, tmp_path / pkg).create_table(
            "sek", [{"text": "x"}], embedding_functions=[EMB[pkg].EmbeddingDefinition(
                source_column="text", function_name="openai",
                config={"base_url": mock_api, "api_key": "$var:sk_test", "ndims": DIM})])
        raws.append(t.schema.metadata[b"embedding_functions"])
    assert raws[0] == raws[1]
    raw = raws[0].decode()
    assert "$var:sk_test" in raw and "topsecret" not in raw and '"k"' not in raw


def test_var_default_and_validation():
    for pkg in PKGS:
        reg = EMB[pkg].get_registry()
        with pytest.raises(Exception, match="colon"):
            reg.set_var("a:b", "v")
        with pytest.raises(Exception, match="not set"):
            reg.get("openai").create(api_key="$var:nope", ndims=DIM)
        assert reg.get("openai").create(api_key="$var:nope:fallback",
                                        ndims=DIM)._api_key == "fallback"


def test_registry_config_roundtrip(mock_api):
    metas = []
    for pkg in PKGS:
        reg = EMB[pkg].get_registry()
        reg.set_var("rk", "k")
        fn = reg.get("openai").create(base_url=mock_api, api_key="$var:rk", ndims=DIM)
        meta = reg.get_table_metadata([EMB[pkg].EmbeddingFunctionConfig(function=fn,
                                                                         source_column="text")])
        parsed = reg.parse_functions({k.encode(): v for k, v in meta.items()})
        assert parsed["vector"].source_column == "text"
        assert parsed["vector"].function.ndims() == DIM
        assert reg.parse_functions(None) == {} and reg.parse_functions({}) == {}
        metas.append(meta)
    assert metas[0] == metas[1]


# ------------------------- hardcoded secrets (tests/test_advice_r3.py, item 2)


def _openai_class(pkg):
    return (port_rest if pkg == "port" else ref_rest).OpenAIEmbedding


@pytest.mark.parametrize("pkg", PKGS)
def test_hardcoded_secret_never_persists_via_source_field(pkg):
    fn = _openai_class(pkg)(api_key="sk-SECRET-123", ndims=8)
    doc = type("Doc", (PYD[pkg].LanceModel,), {
        "__annotations__": {"text": str, "vector": PYD[pkg].Vector(8)},
        "text": fn.SourceField(), "vector": fn.VectorField()})
    db = _connect(pkg, f"memory://embeddings-secret-{pkg}")
    with pytest.raises(Exception, match="sensitive") as e:
        db.create_table("docs", schema=doc)
    assert type(e.value).__name__ == "InvalidInputError"
    assert "docs" not in db.table_names()


def test_secret_references_and_hardcoded_secrets_in_safe_model_dump():
    for pkg in PKGS:
        cls = _openai_class(pkg)
        assert cls(api_key="$var:my_key", ndims=8).safe_model_dump()["api_key"] == "$var:my_key"
        with pytest.raises(Exception, match="sensitive"):
            cls(api_key="sk-SECRET-123", ndims=8).safe_model_dump()
