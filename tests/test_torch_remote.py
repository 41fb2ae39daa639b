"""The query server and the remote client of lancedb_tpu_torch (device="cpu")
against lancedb_tpu's.

Each case drives one sequence of client calls twice: through the port's
client against the port's server, and through the reference's client
against the reference's server, each server over its own copy of one
table made from seeded numpy data (with a reference-built IVF_PQ index and
FTS index where the case searches). Results are compared: ids and every
other column exactly, ``_distance`` to rtol 1.3e-5 (the CPU gap of the
vector leg, PERF.md §7) with an atol of 1e-5 |q|² (the size of the l2
expansion's terms), ``_score`` to 1e-6. The cross-package cases pair each
client with the other package's server, and a recording handler on
127.0.0.1 holds the two clients' requests to equal bytes. The server's
micro-batcher, the transport (retries, headers, OAuth, mTLS, API keys)
and the TypeScript SDK's protocol fixtures are held too. Every server runs
under a ``with`` block, every thread is joined with a timeout, retries
back off by milliseconds, and nothing leaves 127.0.0.1.
"""

import io
import json
import re
import shutil
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.remote as ref_remote
import lancedb_tpu_torch
import lancedb_tpu_torch.remote as port_remote
from lancedb_tpu import errors as ref_errors
from lancedb_tpu.index import IvfPq as RefIvfPq
from lancedb_tpu_torch import errors as port_errors
from lancedb_tpu_torch.remote import server as port_server_mod

REPO = Path(__file__).resolve().parent.parent
N, DIM, NQ = 600, 16, 4
_RNG = np.random.default_rng(15)
X = _RNG.standard_normal((N, DIM)).astype(np.float32)
Q = (X[[7, 101, 333, 512]] + 0.05 * _RNG.standard_normal((NQ, DIM))).astype(np.float32)
QN2 = float(np.max((Q.astype(np.float64) ** 2).sum(1)))
_WORDS = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"])
FAST_RETRY = {"retries": 1, "connect_retries": 1, "backoff_factor": 0.001, "backoff_jitter": 0.0}


def _rows(ids: np.ndarray, vecs: np.ndarray, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": ids.astype(np.int64),
        "category": (ids % 10).astype(np.int64),
        "price": rng.uniform(0, 100, len(ids)),
        "label": [f"item-{i % 7}" for i in ids],
        "text": [" ".join(_WORDS[rng.integers(0, 6, 4)]) for _ in ids],
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), DIM),
    })


TABLE = _rows(np.arange(N), X, 1)
DOCS = pa.table({
    "id": [1, 2, 3, 4],
    "text": ["the quick brown fox", "lazy dog sleeps", "quick dog runs", "brown bear"],
    "title": ["fox", "dog", "dog", "bear"],
})


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A database the reference wrote: ``t`` (IVF_PQ on vector, FTS on
    text) and ``docs`` (FTS on text and title)."""
    path = tmp_path_factory.mktemp("remote_base")
    db = lancedb_tpu.connect(str(path))
    t = db.create_table("t", TABLE)
    t.create_index(config=RefIvfPq(num_partitions=4, num_sub_vectors=4, max_iterations=10))
    t.create_fts_index("text")
    db.create_table("docs", DOCS).create_fts_index(["text", "title"])
    return path


def _client_config(pkg, **kw):
    mod = pkg.remote.client
    return mod.ClientConfig(retry_config=mod.RetryConfig(**FAST_RETRY), **kw)


class _Servers:
    """The port's server (on the CPU) and the reference's, each over its
    own copy of a database, and a client of each package on its own
    package's server: ``dbs`` is (port client, reference client)."""

    def __init__(self, tmp, base_dir=None, **server_kw):
        self.dirs = {}
        for side in ("port", "ref"):
            self.dirs[side] = tmp / side
            if base_dir is not None:
                shutil.copytree(base_dir, self.dirs[side])
        self.port = port_remote.QueryServer(str(self.dirs["port"]), device="cpu", **server_kw)
        self.ref = ref_remote.QueryServer(str(self.dirs["ref"]), **server_kw)

    def __enter__(self):
        self.port.start()
        self.ref.start()
        self.dbs = (
            port_remote.connect_remote(self.port.url,
                                       config=_client_config(lancedb_tpu_torch)),
            ref_remote.connect_remote(self.ref.url, config=_client_config(lancedb_tpu)),
        )
        return self

    def __exit__(self, *exc):
        self.port.stop()
        self.ref.stop()


@pytest.fixture(scope="module")
def served(base, tmp_path_factory):
    """Module-scoped servers over copies of ``base``, for the cases that
    only read."""
    with _Servers(tmp_path_factory.mktemp("remote_served"), base) as s:
        yield s.dbs


@pytest.fixture()
def pair(base, tmp_path):
    """Fresh servers over fresh copies of ``base``, for the cases that write."""
    with _Servers(tmp_path, base) as s:
        yield s.dbs


@pytest.fixture()
def empty_pair(tmp_path):
    with _Servers(tmp_path) as s:
        yield s.dbs


def _same(got, want, path="result"):
    """Results of one call in each package: tables column by column (the
    tolerances of the module's docstring), containers element by element,
    the rest equal."""
    if isinstance(want, pa.Table):
        assert isinstance(got, pa.Table), path
        assert got.column_names == want.column_names, (path, got.column_names, want.column_names)
        assert got.num_rows == want.num_rows, (path, got.num_rows, want.num_rows)
        for name in want.column_names:
            g, w = got.column(name), want.column(name)
            assert g.type == w.type, (path, name, g.type, w.type)
            if name == "_distance":
                np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1.3e-5,
                                           atol=1e-5 * QN2, err_msg=f"{path}.{name}")
            elif name in ("_score", "_relevance_score"):
                np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                                           err_msg=f"{path}.{name}")
            else:
                assert g.equals(w), (path, name, g, w)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, got, want)
        for key in want:
            _same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _both(dbs, fn):
    got, want = (fn(db) for db in dbs)
    _same(got, want)
    return got, want


def _plan(text: str) -> list[tuple[str, str]]:
    """A plan's operators (its one TPU word read as the port's: "MXU
    matmul scan" is "matmul scan"), each with its output rows and without
    its times."""
    out = []
    for line in text.replace("MXU matmul scan", "matmul scan").splitlines():
        if line.startswith("elapsed_ms="):
            line = line.split(" ", 1)[1]
        head, _, metrics = line.partition(", metrics=[")
        rows = re.search(r"output_rows=\d+", metrics)
        out.append((re.sub(r" elapsed=[0-9.]+ms", "", head), rows.group(0) if rows else ""))
    return out


# ---------------------------------------------------------- 1. reads


def test_list_describe_count(served):
    def run(db):
        t = db.open_table("t")
        desc = t.describe()
        return [db.table_names(), db.table_names(limit=1), db.table_names(page_token="docs"),
                str(t.schema), t.version, t.stats(), desc["schema"], t.count_rows(),
                t.count_rows("category < 3")]

    _both(served, run)


def test_open_missing_is_404(served):
    msgs = []
    for db, err in zip(served, (port_errors, ref_errors)):
        with pytest.raises(err.HttpError) as e:
            db.open_table("nope")
        assert e.value.status_code == 404
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


VECTOR_CASES = {
    "raw": lambda t: t.search(Q[0]).nprobes(4).limit(5),
    "refined": lambda t: t.search(Q[1]).nprobes(2).refine_factor(10).limit(5),
    "filtered": lambda t: t.search(Q[2]).nprobes(4).where("category < 5").limit(5),
    "filtered_refined": lambda t: t.search(Q[3]).nprobes(4).refine_factor(5)
    .where("price > 30").limit(5),
    "postfilter": lambda t: t.search(Q[0]).nprobes(4).where("category < 5", prefilter=False)
    .limit(8),
    "select_offset": lambda t: t.search(Q[1]).nprobes(4).select(["id", "label"]).offset(2)
    .limit(4),
    "nprobes_bounds": lambda t: t.search(Q[2]).minimum_nprobes(1).maximum_nprobes(4).limit(5),
    "bypass": lambda t: t.search(Q[3]).bypass_vector_index().limit(5),
    "distance_range": lambda t: t.search(Q[0]).nprobes(4).distance_range(0.0, 25.0).limit(10),
    "with_row_id": lambda t: t.search(Q[1]).nprobes(4).with_row_id(True).limit(3),
    "multi_vector": lambda t: t.search(Q[:3]).nprobes(4).refine_factor(4).limit(4),
}


@pytest.mark.parametrize("case", sorted(VECTOR_CASES))
def test_vector_query(served, case):
    _both(served, lambda db: VECTOR_CASES[case](db.open_table("t")).to_arrow())


def test_vector_query_equals_local_search(served, base):
    """Through the wire, the port's hits are its local search's."""
    got = VECTOR_CASES["refined"](served[0].open_table("t")).to_arrow()
    local = lancedb_tpu_torch.connect(str(base), device="cpu").open_table("t")
    _same(got, VECTOR_CASES["refined"](local).to_arrow())


def test_fts_query(served):
    _both(served, lambda db: db.open_table("t").search("beta gamma").limit(6).to_arrow())


STRUCTURED_FTS = {
    "boolean": lambda q: q.BooleanQuery([(q.Occur.MUST, q.MatchQuery("quick", "text")),
                                         (q.Occur.MUST_NOT, q.MatchQuery("fox", "text"))]),
    "phrase": lambda q: q.PhraseQuery("brown fox", "text"),
    "multi_match": lambda q: q.MultiMatchQuery("dog", ["text", "title"]),
}


@pytest.mark.parametrize("case", sorted(STRUCTURED_FTS))
def test_structured_fts(served, case):
    def run(db):
        pkg = lancedb_tpu_torch if db is served[0] else lancedb_tpu
        query = STRUCTURED_FTS[case](pkg.query_fts)
        return db.open_table("docs").search(query, query_type="fts").limit(5).to_arrow()

    _both(served, run)


@pytest.mark.parametrize("opts", [{"nprobes": 4}, {"minimum_nprobes": 2, "maximum_nprobes": 4,
                                                   "refine_factor": 3, "filter": "id < 300"}])
def test_explain_plan(served, opts):
    got, want = (db.open_table("t").explain_plan(Q[0], k=5, **opts) for db in served)
    assert got == want.replace("MXU matmul scan", "matmul scan")


def test_analyze_plan_modes(served):
    for mode in ("aggregate", "per_worker", "full"):
        got, want = (db.open_table("t").analyze_plan(Q[1].tolist(), k=3, mode=mode, nprobes=4)
                     for db in served)
        assert _plan(got) == _plan(want)
        assert "output_rows=" in got


PLAIN_SCANS = {
    "where": lambda t: t.search(None).where("id >= 590").limit(100),
    "select_offset": lambda t: t.search(None).select(["id", "text"]).limit(5).offset(10),
}


@pytest.mark.parametrize("case", sorted(PLAIN_SCANS))
def test_plain_scan(served, case):
    _both(served, lambda db: PLAIN_SCANS[case](db.open_table("t")).to_arrow())


SQL = {
    "group_by": "SELECT category, COUNT(*) AS n, AVG(price) AS p FROM t GROUP BY category "
                "ORDER BY category",
    "fts": "SELECT id, _score FROM fts(t, 'beta', 5)",
    "explain": "EXPLAIN SELECT id FROM t WHERE category = 3",
}


@pytest.mark.parametrize("case", sorted(SQL))
def test_sql(served, case):
    _both(served, lambda db: db.sql(SQL[case]))


def test_sql_analyze_and_error(served):
    got, want = (db.sql("EXPLAIN ANALYZE SELECT COUNT(*) AS n FROM t").column("plan")[0].as_py()
                 for db in served)
    assert _plan(got) == _plan(want) and "output_rows=" in got
    msgs = []
    for db, err in zip(served, (port_errors, ref_errors)):
        with pytest.raises(err.HttpError) as e:
            db.sql("SELECT FROM WHERE")
        msgs.append((e.value.status_code, str(e.value)))
    assert msgs[0] == msgs[1]


def test_retry_on_unreachable():
    for pkg, err in ((lancedb_tpu_torch, port_errors), (lancedb_tpu, ref_errors)):
        db = pkg.remote.connect_remote("http://127.0.0.1:1", config=_client_config(pkg))
        with pytest.raises(err.HttpError, match="connection failed"):
            db.table_names()


# --------------------------------------------------------- 2. writes


def test_create_list_drop_rename(empty_pair):
    def run(db):
        db.create_table("t1", TABLE.slice(0, 50))
        db.create_table("t2", TABLE.slice(0, 5))
        out = [db.table_names(), db.open_table("t1").count_rows()]
        db.rename_table("t2", "t3")
        db.drop_table("t1")
        return out + [db.table_names()]

    _both(empty_pair, run)


def test_insert_update_delete(pair):
    def run(db):
        t = db.open_table("t")
        t.add(_rows(np.arange(N, N + 20), X[:20] + 0.5, 2))
        upd = t.update(where="id < 5", values={"price": 0.0, "label": "x"})
        upd_sql = t.update(where="category = 9", values_sql={"price": "price * 2"})
        deleted = t.delete("id >= 610")
        scan = t.search(None).limit(1000).to_arrow().sort_by("id")
        return [upd, upd_sql, deleted, t.count_rows(), t.count_rows("price = 0.0"), scan,
                t.search(Q[0]).nprobes(4).refine_factor(5).limit(5).to_arrow()]

    _both(pair, run)


def test_merge_insert(pair):
    def run(db):
        t = db.open_table("t")
        src = _rows(np.array([2, 4, 900, 901]), X[:4] * 0.5, 3)
        stats = (t.merge_insert("id").when_matched_update_all().when_not_matched_insert_all()
                 .execute(src))
        stats2 = (t.merge_insert("id").when_matched_update_all("target.price > 1000")
                  .execute(src))
        return [stats, stats2, t.search(None).where("id IN (2, 4, 900, 901)").limit(10)
                .to_arrow().sort_by("id")]

    _both(pair, run)


def _index_view(indexes):
    return [{k: ix[k] for k in ("name", "index_type", "columns") if k in ix} for ix in indexes]


def test_index_lifecycle(pair):
    def run(db):
        t = db.open_table("t")
        before = _index_view(t.list_indices())
        t.create_index(index_type="IVF_FLAT", num_partitions=4, vector_column_name="vector")
        after = _index_view(t.list_indices())
        stats = t.index_stats("vector_idx")
        hits = t.search(Q[2]).nprobes(4).limit(5).to_arrow()
        t.drop_index("vector_idx")
        return [before, after, {k: stats[k] for k in ("index_type", "num_indexed_rows",
                                                      "num_unindexed_rows")},
                hits, _index_view(t.list_indices())]

    _both(pair, run)


def test_create_index_options_wire_through(empty_pair):
    def run(db):
        t = db.create_table("t", TABLE)
        t.create_index(num_partitions=4, num_sub_vectors=4, num_bits=4, sample_rate=64)
        params = t.index_stats("vector_idx")["params"]
        d = db.create_table("docs", {"id": [1, 2], "text": ["Running quickly", "runs fast"]})
        d.create_fts_index("text", stem=False, with_position=False)
        hits = d.search("Running", query_type="fts").limit(5).to_arrow()
        return [params["num_bits"], params["num_sub_vectors"], hits.column("id").to_pylist()]

    got, _ = _both(empty_pair, run)
    assert got == [4, 4, [1]]


def test_versions_tags_restore(pair):
    def run(db):
        t = db.open_table("t")
        v1 = t.version
        t.add(TABLE.slice(0, 5))
        t.tags.create("v1", v1)
        t.tags.create("head")
        tags = sorted(t.tags.list())
        t.tags.update("head", v1)
        t.tags.delete("v1")
        t.checkout(v1)
        pinned = [t.count_rows(), t.version]
        t.checkout_latest()
        latest = t.count_rows()
        t.restore(v1)
        return [tags, sorted(t.tags.list()), pinned, latest, t.count_rows(),
                len(t.list_versions()) - v1]

    _both(pair, run)


def test_branches(pair):
    def run(db):
        t = db.open_table("t")
        t.create_branch("dev")
        names = sorted(t.list_branches())
        t.checkout_branch("dev")
        t.add(TABLE.slice(0, 5))
        on_dev = t.count_rows()
        t.checkout_branch("main")
        on_main = t.count_rows()
        diff = t.diff_branch("dev")
        merged = t.merge_branch("dev")
        after = t.count_rows()
        t.delete_branch("dev")
        return [names, on_dev, on_main, sorted(diff) if isinstance(diff, dict) else bool(diff),
                bool(merged), after, sorted(t.list_branches())]

    _both(pair, run)


def test_schema_evolution(pair):
    def run(db):
        t = db.open_table("t")
        t.add_columns({"double_price": "price * 2"})
        t.alter_columns({"path": "double_price", "rename": "p2"})
        names = t.schema.names
        t.drop_columns(["p2"])
        return [names, t.schema.names,
                t.search(None).select(["id", "price"]).limit(3).to_arrow()]

    _both(pair, run)


def test_blobs(empty_pair):
    """A blob column declared by its field's metadata on create (the
    reference's remote case): full reads, ranges and lazy handles."""
    payloads = [b"hello world", b"\x00\x01\x02" * 500, None]
    media = lancedb_tpu_torch.blob_field("media").with_type(pa.large_binary())
    tbl = pa.table({"id": pa.array([0, 1, 2], pa.int64()),
                    "media": pa.array(payloads, pa.large_binary())},
                   schema=pa.schema([pa.field("id", pa.int64()), media]))

    def run(db):
        t = db.create_table("b", tbl)
        rids = t.search(None).with_row_id(True).limit(10).to_arrow().column("_rowid").to_pylist()
        files = t.fetch_blob_files("media", rids)
        with files[0] as bf:
            bf.seek(6)
            tail = bf.read()
        return [t.fetch_blobs("media", rids),
                t.fetch_blob_ranges("media", rids[:2], [(0, 5), (3, 6)]),
                files[2] is None, files[1].size(), tail]

    got, _ = _both(empty_pair, run)
    assert got[0] == payloads and got[4] == b"world"


def test_permutation(pair):
    def run(db):
        t = db.open_table("t")
        a = t.permutation_builder(dest="perm").split_random(fractions=[0.7, 0.3], seed=7) \
            .shuffle(seed=3).execute()
        b = t.permutation_builder().split_calculated("CASE WHEN price < 50 THEN 0 ELSE 1 END") \
            .filter("id >= 10").execute()
        c = t.permutation_builder().split_sequential([200, 400]).execute()
        return [a, {k: v for k, v in b.items() if k != "table"}, c["split_sizes"],
                db.open_table("perm").count_rows(),
                db.open_table("perm").search(None).limit(600).to_arrow()]

    _both(pair, run)


def test_multipart_insert(tmp_path):
    out = []
    for pkg, kw in ((lancedb_tpu_torch, {"device": "cpu"}), (lancedb_tpu, {})):
        with pkg.remote.QueryServer(str(tmp_path / pkg.__name__), **kw) as server:
            db = pkg.remote.connect_remote(server.url,
                                           config=_client_config(pkg, max_insert_bytes=4096))
            db.create_table("t", TABLE.slice(0, 10))
            t = db.open_table("t")
            t.add(TABLE.slice(10, 300))  # far above 4096 bytes: several parts
            out.append([t.count_rows(), len(t.list_versions()),
                        t.search(None).limit(400).to_arrow().sort_by("id")])
    _same(*out)


def test_jobs(empty_pair):
    def run(db, err):
        t = db.create_table("jt", TABLE)
        job = t.create_index_async(index_type="IVF_PQ", num_partitions=4, num_sub_vectors=4)
        info = job.wait(timeout=120)
        listed = any(j["id"] == job.id for j in db.list_jobs())
        hist = any(j["id"] == job.id and j["status"] == "SUCCEEDED" for j in db.job_history())
        bad = t.create_index_async(index_type="IVF_PQ", num_partitions=2, num_sub_vectors=7)
        with pytest.raises(err.JobFailureError):
            bad.wait(timeout=60)
        with pytest.raises(err.HttpError) as missing:
            db.get_job("nope")
        ghost = type(t)(t._c, "ghost")
        with pytest.raises(err.HttpError):
            ghost.create_index_async(num_partitions=2, num_sub_vectors=2)
        return [info["status"], listed, hist, db.get_job(job.id).status(), bad.status(),
                missing.value.status_code, _index_view(t.list_indices())]

    got, want = run(empty_pair[0], port_errors), run(empty_pair[1], ref_errors)
    _same(got, want)
    assert got[:5] == ["SUCCEEDED", True, True, "SUCCEEDED", "FAILED"]


def test_ts_sdk_wire_sequence(empty_pair):
    """The HTTP sequence nodejs/__test__/table.test.ts drives, including
    ``order_by`` on the wire, posted raw to each server."""
    def run(db):
        pkg = lancedb_tpu_torch if db is empty_pair[0] else lancedb_tpu
        base = db._client.base_url

        def post(path, body=None, raw=None, ctype="application/json"):
            data = raw if raw is not None else json.dumps(body or {}).encode()
            req = urllib.request.Request(base + path, data=data, method="POST")
            req.add_header("content-type", ctype)
            with urllib.request.urlopen(req, timeout=60) as r:
                payload = r.read()
                if r.headers.get("content-type", "").startswith("application/json"):
                    return json.loads(payload or b"{}")
                return pkg.remote.protocol.ipc_to_table(payload)

        post("/v1/table/ts/create", raw=pkg.remote.protocol.table_to_ipc(TABLE),
             ctype="application/vnd.apache.arrow.stream")
        desc = post("/v1/table/ts/describe")
        return [desc["table"], desc["schema"], post("/v1/table/ts/count_rows", {"predicate": "id < 5"}),
                post("/v1/table/ts/query", {"vector": Q[0].tolist(), "k": 3}),
                post("/v1/table/ts/query", {"k": 4, "filter": "id >= 46", "vector": []}),
                post("/v1/table/ts/update", {"predicate": "id = 0",
                                             "updates": [["label", "'updated'"]]}),
                post("/v1/table/ts/query", {"k": 5, "vector": [],
                                            "order_by": [["id", "descending"]]})]

    got, _ = _both(empty_pair, run)
    ids = got[6].column("id").to_pylist()
    assert len(ids) == 5 and ids == sorted(ids, reverse=True)


def test_describe_carries_embedding_metadata(tmp_path):
    """A table with an embedding function exposes its definition through
    describe, the TS SDK's reconnect contract."""
    import lancedb_tpu.embeddings
    import lancedb_tpu_torch.embeddings

    out = []
    for pkg, kw in ((lancedb_tpu_torch, {"device": "cpu"}), (lancedb_tpu, {})):
        root = str(tmp_path / pkg.__name__)
        pkg.connect(root, **kw).create_table(
            "docs", [{"text": "alpha"}, {"text": "bravo"}],
            embedding_functions=[pkg.embeddings.EmbeddingDefinition(
                source_column="text", vector_column="vector", function_name="hash",
                config={"ndims": 8})],
        )
        with pkg.remote.QueryServer(root, **kw) as server:
            desc = pkg.remote.connect_remote(server.url).open_table("docs").describe()
            out.append([desc["schema"], json.loads(desc["schema"]["metadata"]
                                                   ["embedding_functions"])])
    _same(*out)
    assert out[0][1][0]["name"] == "hash" and out[0][1][0]["model"] == {"ndims": 8}


# ------------------------------------------------ 3. cross-package pairs


def _scenario(db):
    """One round of calls for the cross-package pairs."""
    t = db.create_table("c", TABLE.slice(0, 200))
    t.add(TABLE.slice(200, 100))
    t.update(where="id < 3", values={"label": "z"})
    return [db.table_names(), t.count_rows(), t.search(Q[0]).limit(5).to_arrow(),
            t.search(None).where("label = 'z'").limit(10).to_arrow(),
            db.sql("SELECT label, COUNT(*) AS n FROM c GROUP BY label ORDER BY label")]


@pytest.mark.parametrize("client", ["port", "ref"])
def test_cross_package_pairs(tmp_path, client):
    """The port's client against the reference's server, and the
    reference's against the port's, give what the same-package pair does."""
    with _Servers(tmp_path) as s:
        same = _scenario(s.dbs[0] if client == "port" else s.dbs[1])
        other_pkg = lancedb_tpu_torch if client == "port" else lancedb_tpu
        other_url = s.ref.url if client == "port" else s.port.url
        cross = _scenario(other_pkg.remote.connect_remote(other_url))
    _same(cross, same)


class _Recorder(BaseHTTPRequestHandler):
    """Records each request's method, path, headers (but the random
    request id) and body, and answers with a canned body."""

    log: list = []

    def log_message(self, *a):
        pass

    def _answer(self, method):
        n = int(self.headers.get("content-length") or 0)
        body = self.rfile.read(n) if n else b""
        headers = sorted((k.lower(), v) for k, v in self.headers.items()
                         if k.lower() not in ("x-request-id", "host"))
        self.log.append((method, self.path, headers, body))
        if "/query" in self.path:
            sink = io.BytesIO()
            empty = pa.table({"id": pa.array([], pa.int64())})
            with pa.ipc.new_stream(sink, empty.schema) as w:
                w.write_table(empty)
            payload, ctype = sink.getvalue(), "application/vnd.apache.arrow.stream"
        else:
            payload, ctype = json.dumps({"tables": []} if method == "GET" else {}).encode(), \
                "application/json"
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._answer("GET")

    def do_POST(self):
        self._answer("POST")


CALLS = {
    "table_names": lambda db: db.table_names(limit=3),
    "create_table": lambda db: db.create_table("t", TABLE.slice(0, 20)),
    "query": lambda db: db.open_table("t").search(Q[0]).where("id < 9").nprobes(3)
    .refine_factor(2).select(["id"]).limit(4).to_arrow(),
    "update": lambda db: db.open_table("t").update(where="id = 1", values={"label": "a'b"}),
    "merge_insert": lambda db: db.open_table("t").merge_insert("id").when_matched_update_all()
    .when_not_matched_insert_all().execute(TABLE.slice(0, 3)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_clients_send_equal_bytes(call):
    handler = type("Rec", (_Recorder,), {"log": []})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        sent = []
        for pkg in (lancedb_tpu_torch, lancedb_tpu):
            handler.log.clear()
            CALLS[call](pkg.remote.connect_remote(url, api_key="k"))
            sent.append(list(handler.log))
    finally:
        httpd.shutdown()
        thread.join(timeout=5)
    assert not thread.is_alive()
    assert sent[0] and sent[0] == sent[1]


# -------------------------------------------------- 4. micro-batching


@pytest.fixture()
def batched(base, tmp_path):
    """A port server with a long batching window over a copy of ``base``,
    the local table, and the server's batcher."""
    shutil.copytree(base, tmp_path / "db")
    with port_remote.QueryServer(str(tmp_path / "db"), device="cpu", batch_window_ms=200.0,
                                 max_batch=64) as server:
        local = lancedb_tpu_torch.connect(str(tmp_path / "db"), device="cpu").open_table("t")
        yield server, local, server._httpd.RequestHandlerClass._batcher


def _queries_counted(table: str) -> float:
    from lancedb_tpu_torch.metrics import snapshot_metrics

    return sum(c["value"] for c in snapshot_metrics()["counters"]
               if c["name"] == "lancedb.queries" and c["labels"].get("table") == table)


def _in_threads(fn, n: int) -> list:
    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def work(i):
        try:
            barrier.wait(timeout=30)
            results[i] = fn(i)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    return results


def test_concurrent_singles_coalesce(batched):
    """16 concurrent single-vector requests run in fewer search calls than
    16, and each client gets its own rows: its vector's local search, ids
    exactly. The distances are held to the module's tolerance, not bit for
    bit: torch's CPU matmul rounds a 1-row and a many-row product
    differently (a few ulp of |q|² seen in the l2 expansion)."""
    server, local, _ = batched
    qs = (X[np.arange(16) * 37] + 0.01).astype(np.float32)
    before = _queries_counted("t")

    def search(i):
        db = port_remote.connect_remote(server.url)
        return db.open_table("t").search(qs[i]).nprobes(4).limit(5).to_arrow()

    got = _in_threads(search, 16)
    calls = _queries_counted("t") - before
    assert 1 <= calls < 16, calls
    for i in range(16):
        want = local.search(qs[i]).nprobes(4).limit(5).to_arrow()
        assert got[i].column_names == want.column_names
        np.testing.assert_array_equal(np.asarray(got[i]["id"]), np.asarray(want["id"]))
        np.testing.assert_allclose(np.asarray(got[i]["_distance"]),
                                   np.asarray(want["_distance"]), rtol=1.3e-5,
                                   atol=1e-5 * float((qs[i].astype(np.float64) ** 2).sum()))
        assert got[i]["id"][0].as_py() == int(np.arange(16)[i] * 37)


def test_filtered_queries_bypass_the_batcher(batched, monkeypatch):
    server, local, batcher = batched
    submitted = []
    real = batcher.submit
    monkeypatch.setattr(batcher, "submit",
                        lambda *a, **kw: submitted.append(1) or real(*a, **kw))
    t = port_remote.connect_remote(server.url).open_table("t")
    out = t.search(Q[0]).nprobes(4).where("id < 100").limit(5).to_arrow()
    assert submitted == [] and all(i < 100 for i in out.column("id").to_pylist())
    _same(out, local.search(Q[0]).nprobes(4).where("id < 100").limit(5).to_arrow())
    t.search(Q[0]).nprobes(4).limit(5).to_arrow()
    assert submitted == [1]


@pytest.mark.parametrize("pkg", [lancedb_tpu_torch, lancedb_tpu], ids=["port", "ref"])
def test_micro_batcher_unit(pkg):
    from importlib import import_module

    batching = import_module(f"{pkg.__name__}.remote.batching")
    mb = batching.MicroBatcher(window_s=0.05, max_batch=8)
    calls = []

    def run_batch(items):
        calls.append(list(items))
        return [x * 10 for x in items]

    out = _in_threads(lambda i: mb.submit("k", i, run_batch), 6)
    assert out == [i * 10 for i in range(6)]
    assert len(calls) <= 2 and sum(len(c) for c in calls) == 6
    # errors reach every waiter; max_batch closes a group
    def boom(items):
        raise RuntimeError("kaput")

    with pytest.raises(RuntimeError, match="kaput"):
        batching.MicroBatcher(window_s=0.0).submit("k", 1, boom)
    assert batching.MicroBatcher(window_s=0.0, max_batch=2).submit(
        "k", 7, lambda items: [len(items)]) == 1
    mb2 = batching.MicroBatcher(window_s=0.2, max_batch=3)
    sizes = _in_threads(lambda i: mb2.submit("k", i, lambda items: [len(items)] * len(items)), 6)
    assert max(sizes) <= 3


def test_count_launch_under_16_threads():
    """Every increment of the locked launch-count helper is counted, from
    16 threads at once, with the interpreter switching threads every
    microsecond."""
    import sys

    from lancedb_tpu_torch.ops import cuda_build

    saved, interval = dict(cuda_build.launch_counts), sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        cuda_build.launch_counts["group_plan"] = 0
        _in_threads(lambda i: [cuda_build.count_launch("group_plan") for _ in range(5000)], 16)
        assert cuda_build.launch_counts["group_plan"] == 16 * 5000
    finally:
        sys.setswitchinterval(interval)
        cuda_build.launch_counts.update(saved)


def test_serving_mesh_reaches_the_tables(base, tmp_path):
    """A server with a serving mesh (two CPU shards) serves each table it
    opens sharded: the hits of the local table on the same mesh."""
    from lancedb_tpu_torch.parallel import make_mesh

    shutil.copytree(base, tmp_path / "db")
    mesh = make_mesh(devices=["cpu", "cpu"])
    local = lancedb_tpu_torch.connect(str(tmp_path / "db"), device="cpu").open_table("t")
    local.enable_sharded_serving(mesh)
    with port_remote.QueryServer(str(tmp_path / "db"), device="cpu", serving_mesh=mesh,
                                 batch_window_ms=0) as server:
        t = port_remote.connect_remote(server.url).open_table("t")
        for case in ("raw", "refined", "filtered"):
            _same(VECTOR_CASES[case](t).to_arrow(), VECTOR_CASES[case](local).to_arrow())
        served = server._httpd.RequestHandlerClass._table_cache["t"]
        assert served._serving_mesh is mesh


def test_server_device_rules(tmp_path):
    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu")
    with port_remote.QueryServer(db, device="cpu") as server:  # the same device: accepted
        assert server._conn is db
    with pytest.raises(port_errors.InvalidInputError, match="runs on cpu"):
        port_remote.QueryServer(db, device="meta")
    with port_remote.QueryServer(str(tmp_path), device="cpu") as server:
        assert server._conn.device.type == "cpu"
    with pytest.raises(port_errors.InvalidInputError, match="server's device"):
        lancedb_tpu_torch.connect("db://x", device="cpu", host_override="http://127.0.0.1:1")
    with pytest.raises(port_errors.InvalidInputError, match="host_override"):
        lancedb_tpu_torch.connect("db://x")


# ------------------------------------------------------- 5. transport


@pytest.mark.parametrize("pkg", [lancedb_tpu_torch, lancedb_tpu], ids=["port", "ref"])
def test_mock_transport(pkg):
    client = pkg.remote.client
    calls, seen = [], {}

    def flaky(method, url, headers, body):
        calls.append(url)
        return (503, b'{"error": "overloaded"}') if len(calls) < 3 else (200, b'{"ok": true}')

    c = client.RestClient("http://fake", config=client.ClientConfig(
        retry_config=client.RetryConfig(retries=3, backoff_factor=0.0)), transport=flaky)
    assert c.post_json("/x")["ok"] is True and len(calls) == 3
    calls.clear()
    bad = client.RestClient("http://fake", transport=lambda *a: calls.append(1) or
                            (400, b'{"error": "bad request"}'))
    with pytest.raises(pkg.errors.HttpError, match="bad request") as e:
        bad.post_json("/x")
    assert e.value.status_code == 400 and calls == [1]
    c = client.RestClient("http://fake", config=client.ClientConfig(
        header_provider=lambda: {"authorization": "Bearer tok"}),
        transport=lambda m, u, h, b: seen.update(h) or (200, b"{}"))
    c.post_json("/x")
    assert seen["authorization"] == "Bearer tok" and len(seen["x-request-id"]) == 32


def _mock_idp(calls, expires_in=3600, issuer="https://idp.example.com"):
    def transport(method, url, headers, body):
        calls.append((method, url, body))
        if url.endswith("/.well-known/openid-configuration"):
            return 200, json.dumps({"token_endpoint": f"{issuer}/oauth/token"}).encode()
        if url.endswith("/oauth/token"):
            form = dict(p.split("=", 1) for p in body.decode().split("&"))
            assert form["grant_type"] == "client_credentials" and form["client_id"] == "cid"
            return 200, json.dumps({"access_token": f"tok{len(calls)}",
                                    "expires_in": expires_in}).encode()
        return 404, b"{}"
    return transport


OAUTH = ("client_credentials", "refresh", "https_outside_loopback", "azure_imds", "in_client")


@pytest.mark.parametrize("case", OAUTH)
def test_oauth(case):
    """Each package's token source through the same mock transports: the
    same requests, the same headers."""
    out = []
    for pkg in (lancedb_tpu_torch, lancedb_tpu):
        cfg, prov = pkg.remote.OAuthConfig, pkg.remote.OAuthHeaderProvider
        calls = []
        if case == "client_credentials":
            p = prov(cfg(issuer_url="https://idp.example.com", client_id="cid",
                         client_secret="sec", scopes=["api://app/.default"]),
                     transport=_mock_idp(calls))
            out.append([p(), p(), calls])
        elif case == "refresh":
            p = prov(cfg(issuer_url="https://idp.example.com", client_id="cid",
                         client_secret="sec", scopes=["s"], refresh_buffer_secs=0),
                     transport=_mock_idp(calls, expires_in=0))
            first, second = p()["authorization"], p()["authorization"]
            assert first != second
            out.append([first, second, calls])
        elif case == "https_outside_loopback":
            errs = []
            for kw in ({"issuer_url": "http://idp.example.com", "scopes": ["x"],
                        "client_secret": "s"},
                       {"issuer_url": "https://x", "scopes": [], "client_secret": "s"},
                       {"issuer_url": "https://x", "scopes": ["s"]}):
                with pytest.raises(pkg.errors.InvalidInputError) as e:
                    prov(cfg(client_id="c", **kw))
                errs.append(str(e.value))
            prov(cfg(issuer_url="http://127.0.0.1:9", client_id="cid", client_secret="s",
                     scopes=["x"]), transport=_mock_idp(calls))  # loopback: accepted
            out.append(errs)
        elif case == "azure_imds":
            def imds(method, url, headers, body):
                calls.append((url, headers.get("Metadata")))
                return 200, json.dumps({"access_token": "aztok", "expires_in": "3600"}).encode()

            p = prov(cfg(flow="azure_managed_identity", scopes=["api://app/.default"]),
                     transport=imds)
            out.append([p(), p(), calls])
        else:
            p = prov(cfg(issuer_url="https://idp.example.com", client_id="cid",
                         client_secret="sec", scopes=["s"]), transport=_mock_idp(calls))
            got = {}
            client = pkg.remote.client.RestClient(
                "https://db.example.com", config=pkg.remote.client.ClientConfig(header_provider=p),
                transport=lambda m, u, h, b: got.update(h) or (200, b"{}"))
            client.request("GET", "/v1/table/")
            out.append(got["authorization"])
    _same(out[0], out[1])


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    import subprocess

    if shutil.which("openssl") is None:
        pytest.skip("openssl not available")
    d = tmp_path_factory.mktemp("certs")

    def ossl(*args):
        subprocess.run(["openssl", *args], check=True, capture_output=True, timeout=60)

    ossl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2", "-keyout",
         str(d / "ca.key"), "-out", str(d / "ca.crt"), "-subj", "/CN=test-ca")
    ossl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(d / "srv.key"), "-out",
         str(d / "srv.csr"), "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1")
    ossl("x509", "-req", "-in", str(d / "srv.csr"), "-CA", str(d / "ca.crt"), "-CAkey",
         str(d / "ca.key"), "-CAcreateserial", "-days", "2", "-copy_extensions", "copy",
         "-out", str(d / "srv.crt"))
    ossl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(d / "cli.key"), "-out",
         str(d / "cli.csr"), "-subj", "/CN=test-client")
    ossl("x509", "-req", "-in", str(d / "cli.csr"), "-CA", str(d / "ca.crt"), "-CAkey",
         str(d / "ca.key"), "-CAcreateserial", "-days", "2", "-out", str(d / "cli.crt"))
    return d


def _tls_server(certs, path):
    return port_remote.QueryServer(str(path), device="cpu", tls_cert=str(certs / "srv.crt"),
                                   tls_key=str(certs / "srv.key"),
                                   tls_client_ca=str(certs / "ca.crt"))


def test_mtls_round_trip(certs, tmp_path):
    from lancedb_tpu_torch.remote import ClientConfig, TlsConfig

    with _tls_server(certs, tmp_path / "db") as server:
        assert server.url.startswith("https://")
        cfg = ClientConfig(tls_config=TlsConfig(ca_file=str(certs / "ca.crt"),
                                                cert_file=str(certs / "cli.crt"),
                                                key_file=str(certs / "cli.key")))
        rdb = port_remote.connect_remote(server.url, config=cfg)
        t = rdb.create_table("m", {"id": [1, 2, 3]})
        assert t.count_rows() == 3 and rdb.table_names() == ["m"]


def test_mtls_rejects_a_client_without_a_certificate(certs, tmp_path):
    from lancedb_tpu_torch.remote import ClientConfig, RetryConfig, TlsConfig

    with _tls_server(certs, tmp_path / "db") as server:
        cfg = ClientConfig(tls_config=TlsConfig(ca_file=str(certs / "ca.crt")),
                           retry_config=RetryConfig(**FAST_RETRY))
        # refused in the handshake (HttpError) or, under TLS 1.3, at the
        # first read (ssl.SSLError, an OSError)
        with pytest.raises((port_errors.HttpError, OSError)):
            port_remote.connect_remote(server.url, config=cfg).table_names()
    with pytest.raises(ValueError, match="tls_client_ca requires"):
        port_remote.QueryServer(str(tmp_path / "db"), host="0.0.0.0", device="cpu",
                                tls_client_ca=str(certs / "ca.crt"))


def test_api_key(tmp_path):
    """tests/test_advice_fixes.py's API-key cases on the port's server."""
    lancedb_tpu_torch.connect(str(tmp_path / "db"), device="cpu").create_table(
        "t", pa.table({"x": pa.array([1, 2, 3])}))
    with port_remote.QueryServer(str(tmp_path / "db"), api_key="sekrit", device="cpu") as srv:
        for headers in ({}, {"x-api-key": "wrong"}):
            req = urllib.request.Request(f"{srv.url}/v1/table", headers=headers)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=5)
            assert ei.value.code == 401
        req = urllib.request.Request(f"{srv.url}/v1/table", headers={"x-api-key": "sekrit"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert json.loads(resp.read())["tables"] == ["t"]
        rdb = lancedb_tpu_torch.connect("db://test", host_override=srv.url, api_key="sekrit")
        assert rdb.table_names() == ["t"]
    with pytest.raises(ValueError, match="api_key"):
        port_remote.QueryServer(str(tmp_path / "db"), host="0.0.0.0", device="cpu")


# ----------------------------------------------- 6. the TS SDK fixtures


FIXTURES = REPO / "nodejs" / "__test__" / "protocol_fixtures.json"


def _fixture_ipc(columns: dict, vector_dim) -> bytes:
    arrays = []
    for name, values in columns.items():
        if name == "vector" and vector_dim:
            flat = [x for row in values for x in row]
            arrays.append(pa.FixedSizeListArray.from_arrays(pa.array(flat, pa.float32()),
                                                            vector_dim))
        else:
            arrays.append(pa.array(values))
    tbl = pa.table(dict(zip(columns, arrays)))
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return sink.getvalue()


def _subst(template: str, saved: dict) -> str:
    def repl(m):
        cur = saved
        for part in m.group(1).split("."):
            cur = cur[int(part)] if isinstance(cur, list) else cur[part]
        return str(cur)

    return re.sub(r"\$\{([^}]+)\}", repl, template)


def _replay(url: str, scenario: list) -> list:
    saved, statuses = {}, []
    for i, entry in enumerate(scenario):
        path = _subst(entry["path"], saved)
        if "arrow_columns" in entry:
            body = _fixture_ipc(entry["arrow_columns"], entry.get("vector_dim"))
            ctype = "application/vnd.apache.arrow.stream"
        elif "json" in entry:
            body, ctype = _subst(json.dumps(entry["json"]), saved).encode(), "application/json"
        else:
            body = ctype = None
        req = urllib.request.Request(url + path, data=body, method=entry["method"])
        if ctype:
            req.add_header("content-type", ctype)
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                status, payload = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, payload = e.code, e.read()
        want = entry["expect_status"]
        assert status in (want if isinstance(want, list) else [want]), (i, entry["op"], payload)
        statuses.append(status)
        if status >= 300:
            continue
        if entry.get("expect_arrow"):
            tbl = pa.ipc.open_stream(io.BytesIO(payload)).read_all()
            if "expect_rows" in entry:
                assert tbl.num_rows == entry["expect_rows"], (i, entry["op"])
        else:
            decoded = json.loads(payload) if payload else None
            for key in entry.get("expect_keys", []):
                assert isinstance(decoded, dict) and key in decoded, (i, entry["op"], decoded)
            if "expect_value" in entry:
                assert decoded == entry["expect_value"], (i, entry["op"], decoded)
            if entry.get("save_as"):
                saved[entry["save_as"]] = decoded
    return statuses


def test_ts_sdk_fixtures_replay_against_the_port(tmp_path):
    """Every fixture of nodejs/__test__/protocol_fixtures.json against the
    port's server, with the statuses the reference's server gives."""
    scenario = json.loads(FIXTURES.read_text())["scenario"]
    statuses = []
    for pkg, kw in ((lancedb_tpu_torch, {"device": "cpu"}), (lancedb_tpu, {})):
        with pkg.remote.QueryServer(str(tmp_path / pkg.__name__), **kw) as server:
            statuses.append(_replay(server.url.rstrip("/"), scenario))
    assert len(statuses[0]) == len(scenario) and statuses[0] == statuses[1]


def test_every_fixture_op_has_a_port_handler():
    handler = port_server_mod._Handler
    for entry in json.loads(FIXTURES.read_text())["scenario"]:
        m = re.match(r"^/v1/table/[^/]+/([a-z_]+)", entry["path"])
        if m:
            assert hasattr(handler, f"op_{m.group(1)}"), m.group(1)
