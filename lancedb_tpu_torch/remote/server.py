"""Query server: serves a local database over the Cloud REST protocol.

The reference's server side is LanceDB Cloud (closed); its client
endpoints are documented in remote/table.rs + docs/openapi.yml. This
server implements that surface over our engine so (a) the remote client
has a real peer, (b) multi-host deployments can front card hosts with
the same protocol, and (c) tests exercise client/server exactly the way
the reference's python suite spins a localhost server
(test_remote_db.py).

The server owns the device: its connection's, the card by default.
Each request runs on its own handler thread, so concurrent searches
share the card and the table cache; concurrent unfiltered single-vector
queries coalesce into one search call (batching.py).

Stdlib-only (ThreadingHTTPServer): no external web framework.
"""

from __future__ import annotations

import re
import threading
import traceback
import uuid as _uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pyarrow as pa
import torch

from ..db import LanceDBConnection
from ..errors import InvalidInputError, LanceDBError, TableNotFoundError
from ..ops.util import resolve_device
from ..query import VectorQueryRequest, execute_vector_query
from .protocol import (
    CONTENT_ARROW,
    CONTENT_JSON,
    REQUEST_ID_HEADER,
    dumps,
    ipc_to_table,
    loads,
    schema_to_json,
    table_to_ipc,
)


def _same_device(a, b) -> bool:
    """``cuda`` and ``cuda:0`` name one card where 0 is the current one."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _vector_req_from_body(body: dict, vectors: list) -> VectorQueryRequest:
    """Wire body → VectorQueryRequest. `nprobes` sets both bounds unless
    `minimum_nprobes`/`maximum_nprobes` override it; `ef` reaches HNSW
    sub-indexes (reference VectorQueryRequest fields, query.rs:1067-1114,
    serialized by remote/table.rs)."""
    nprobes = body.get("nprobes", 20)
    return VectorQueryRequest(
        column=body.get("vector_column"),
        query_vectors=[np.asarray(v, np.float32) for v in vectors],
        k=body.get("k", 10),
        offset=body.get("offset", 0),
        filter=body.get("filter"),
        prefilter=body.get("prefilter", True),
        minimum_nprobes=body.get("minimum_nprobes", nprobes),
        maximum_nprobes=body.get("maximum_nprobes", nprobes),
        refine_factor=body.get("refine_factor"),
        distance_type=body.get("distance_type"),
        lower_bound=body.get("lower_bound"),
        upper_bound=body.get("upper_bound"),
        ef=body.get("ef"),
        use_index=not body.get("bypass_vector_index", False),
        fast_search=body.get("fast_search", False),
        with_row_id=body.get("with_row_id", False),
        select=body.get("columns"),
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "lancedb-tpu-torch-server/0.1"
    conn: LanceDBConnection = None  # injected by make_server
    api_key: str | None = None  # injected by make_server

    # silence default stderr logging
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # ------------------------------------------------------------ plumbing
    def _read_body(self) -> bytes:
        length = int(self.headers.get("content-length", 0))
        return self.rfile.read(length) if length else b""

    def _respond(self, code: int, body: bytes = b"", content_type: str = CONTENT_JSON):
        self.send_response(code)
        self.send_header("content-type", content_type)
        self.send_header("content-length", str(len(body)))
        rid = self.headers.get(REQUEST_ID_HEADER) or _uuid.uuid4().hex
        self.send_header(REQUEST_ID_HEADER, rid)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _error(self, code: int, message: str):
        self._respond(code, dumps({"error": message}))

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def _route(self, method: str):
        try:
            if self.api_key is not None:
                import hmac

                presented = self.headers.get("x-api-key") or ""
                if not hmac.compare_digest(presented, self.api_key):
                    return self._error(401, "invalid or missing x-api-key")
            path = self.path.split("?")[0].rstrip("/")
            if path == "/v1/table" and method == "GET":
                return self._list_tables()
            if path == "/v1/sql" and method == "POST":
                return self.op_sql()
            # connection-level job APIs (reference connection.rs:526-556)
            if path == "/v1/jobs" and method == "GET":
                return self.op_jobs_list()
            if path == "/v1/jobs/history" and method == "GET":
                return self.op_jobs_history()
            mj = re.match(r"^/v1/jobs/([^/]+)/cancel$", path)
            if mj and method == "POST":
                return self.op_jobs_cancel(mj.group(1))
            mj = re.match(r"^/v1/jobs/([^/]+)$", path)
            if mj and method == "GET":
                return self.op_jobs_get(mj.group(1))
            m = re.match(r"^/v1/table/([^/]+)/(.+)$", path)
            if not m:
                return self._error(404, f"no route {path}")
            name, op = m.group(1), m.group(2)
            handler = getattr(self, f"op_{op.replace('/', '_')}", None)
            if handler is None:
                return self._error(404, f"unknown operation {op!r}")
            return handler(name)
        except TableNotFoundError as e:
            return self._error(404, str(e))
        except LanceDBError as e:
            return self._error(400, str(e))
        except Exception as e:  # pragma: no cover - defensive
            traceback.print_exc()
            return self._error(500, f"{type(e).__name__}: {e}")

    def _open(self, name, body=None):
        """Open a table honoring per-request time-travel params (the
        server is stateless across requests, so reads at a version/tag/
        branch pass them per request — reference remote/table.rs passes
        version with each read)."""
        body = body or {}
        if body.get("version") or body.get("tag") or body.get("branch"):
            return self.conn.open_table(
                name,
                version=body.get("version"),
                tag=body.get("tag"),
                branch=body.get("branch"),
            )
        with self._table_cache_lock:
            t = self._table_cache.get(name)
            fresh = t is None
            if fresh:
                t = self.conn.open_table(name)
                if self.serving_mesh is not None:
                    # only an IVF_PQ index is sharded; the others serve
                    # from the table's device
                    t.enable_sharded_serving(self.serving_mesh)
                t._serve_refresh_lock = threading.Lock()
                self._table_cache[name] = t
        if not fresh:
            # revalidate against the branch head OUTSIDE the global cache
            # lock (it is manifest IO — on object storage a network round
            # trip) and under a PER-TABLE lock so concurrent requests to
            # other tables never serialize behind it
            with t._serve_refresh_lock:
                t._background_refresh()
        return t

    def op_sql(self):
        """Run a SQL SELECT over the database (Arrow IPC response) —
        the remote face of DBConnection.sql; cached tables serve scans
        so sharded/device-resident indexes stay warm behind fts()."""
        body = loads(self._read_body())
        from ..sql import analyze_select, execute_select, explain_select

        query = body["query"]
        stripped = query.lstrip()
        if stripped[:7].upper() == "EXPLAIN":
            rest = stripped[7:].lstrip()
            if rest[:7].upper() == "ANALYZE":
                plan, _ = analyze_select(rest[7:].lstrip(), self._open)
                return self._respond(200, dumps({"plan": plan}))
            return self._respond(200, dumps({"plan": explain_select(rest)}))
        out = execute_select(query, self._open)
        self._respond(200, table_to_ipc(out), content_type=CONTENT_ARROW)

    # ---------------------------------------------------------- tables
    def _list_tables(self):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        names = self.conn.table_names(
            page_token=params.get("page_token"),
            limit=int(params["limit"]) if "limit" in params else None,
        )
        self._respond(200, dumps({"tables": names}))

    def op_create(self, name):
        body = self._read_body()
        if body:
            data = ipc_to_table(body)
            self.conn.create_table(name, data, mode="create")
        else:
            return self._error(400, "create requires an Arrow IPC body")
        self._respond(200, dumps({}))

    def _evict(self, name):
        with self._table_cache_lock:
            self._table_cache.pop(name, None)

    def op_drop(self, name):
        self.conn.drop_table(name)
        self._evict(name)
        self._respond(200, dumps({}))

    def op_rename(self, name):
        body = loads(self._read_body())
        self.conn.rename_table(name, body["new_name"])
        self._evict(name)
        self._respond(200, dumps({}))

    def op_describe(self, name):
        body = loads(self._read_body()) if self.headers.get("content-length") else {}
        t = self._open(name, body)
        self._respond(
            200,
            dumps(
                {
                    "table": name,
                    "version": t.version,
                    "schema": schema_to_json(t.schema),
                    "stats": t.stats(),
                }
            ),
        )

    def op_count_rows(self, name):
        body = loads(self._read_body())
        t = self._open(name, body)
        self._respond(200, dumps(t.count_rows(body.get("predicate"))))

    def op_insert(self, name):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        data = ipc_to_table(self._read_body())
        t = self._open(name, {"branch": params.get("branch")})
        t.add(data, mode=params.get("mode", "append"))
        self._respond(200, dumps({"version": t.version}))

    # ----------------------------------------------------------- queries
    def op_query(self, name):
        body = loads(self._read_body())
        t = self._open(name, body)

        def _maybe_sort(tbl):
            order = body.get("order_by")
            if order:
                tbl = tbl.sort_by([(c, d) for c, d in order])
            return tbl

        if body.get("vector") in (None, []) and "full_text_query" not in body:
            # plain (no-vector) scan: filter/select/limit/offset
            qb = t.search(None)
            if body.get("filter"):
                qb = qb.where(body["filter"])
            if body.get("columns"):
                qb = qb.select(body["columns"])
            if body.get("with_row_id"):
                qb = qb.with_row_id(True)
            if body.get("k"):
                qb = qb.limit(body["k"])
            if body.get("offset"):
                qb = qb.offset(body["offset"])
            return self._respond(200, table_to_ipc(_maybe_sort(qb.to_arrow())), CONTENT_ARROW)
        if "full_text_query" in body and body.get("vector") in (None, []):
            fq = body["full_text_query"]
            if "query" in fq:
                fts_query = fq["query"]
                if isinstance(fts_query, dict):
                    from ..query_fts import fts_query_from_json

                    fts_query = fts_query_from_json(fts_query)
            else:
                # structured AST document (MatchQuery.to_json shape) —
                # what the python/TS clients send for non-string queries
                from ..query_fts import fts_query_from_json

                fts_query = fts_query_from_json(fq)
            out = t._execute_fts(
                fts_query,
                columns=fq.get("columns"),
                k=body.get("k", 10),
                offset=body.get("offset", 0),
                filter=body.get("filter"),
                prefilter=body.get("prefilter", True),
                select=body.get("columns"),
                with_row_id=body.get("with_row_id", False),
            )
        else:
            vec = body.get("vector")
            multi = bool(vec) and isinstance(vec[0], list)
            if not multi and self._batchable(body):
                out = self._batched_vector_query(name, body, vec)
                return self._respond(200, table_to_ipc(_maybe_sort(out)), CONTENT_ARROW)
            req = _vector_req_from_body(body, vec if multi else [vec])
            out = execute_vector_query(t, req)
        self._respond(200, table_to_ipc(_maybe_sort(out)), CONTENT_ARROW)

    # ------------------------------------------------ dynamic batching
    def _batchable(self, body: dict) -> bool:
        """Single-vector queries with no filter coalesce into one device
        dispatch (remote/batching.py). Filtered queries pass through:
        per-query penalty masks don't share a dispatch."""
        return (
            self._batcher is not None
            and body.get("filter") is None
            and not body.get("order_by")
            and body.get("version") is None
            and body.get("branch") is None
            and not body.get("offset")
        )

    def _batched_vector_query(self, name: str, body: dict, vec: list) -> pa.Table:
        key = (
            name, body.get("vector_column"), body.get("k", 10),
            body.get("nprobes", 20), body.get("minimum_nprobes"),
            body.get("maximum_nprobes"), body.get("ef"),
            body.get("refine_factor"),
            body.get("distance_type"), body.get("lower_bound"),
            body.get("upper_bound"), body.get("bypass_vector_index", False),
            body.get("fast_search", False), body.get("with_row_id", False),
            tuple(body.get("columns") or ()) or None, len(vec),
        )

        def run_batch(vectors: list) -> list[pa.Table]:
            t = self._open(name, body)
            req = _vector_req_from_body(body, vectors)
            out = execute_vector_query(t, req)
            if len(vectors) == 1:
                return [out]
            qcol = out.column("query_index")
            parts = []
            for qi in range(len(vectors)):
                sub = out.filter(pa.compute.equal(qcol, qi))
                parts.append(sub.drop_columns(["query_index"]))
            return parts

        return self._batcher.submit(key, vec, run_batch)

    def op_explain_plan(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        req = _vector_req_from_body(body, [body.get("vector")])
        from ..query import explain_vector_plan

        self._respond(200, dumps({"plan": explain_vector_plan(t, req)}))

    def op_analyze_plan(self, name):
        """Execute + per-operator metrics. The response carries a
        per-worker breakdown (reference analyze_plan distributed
        metrics, query.rs:671-693 — Cloud workers each report their
        operator metrics; this server is one worker, a mesh-serving
        deployment reports one section per host)."""
        import socket

        body = loads(self._read_body())
        t = self._open(name)
        req = _vector_req_from_body(body, [body.get("vector")])
        from ..query import analyze_vector_plan

        plan = analyze_vector_plan(t, req)
        self._respond(200, dumps({
            "plan": plan,
            "workers": [{"worker": socket.gethostname(), "plan": plan}],
        }))

    # --------------------------------------------------------- mutation
    def op_update(self, name):
        body = loads(self._read_body())
        t = self._open(name, {"branch": body.get("branch")})
        updates = {c: e for c, e in body.get("updates", [])}
        stats = t.update(where=body.get("predicate"), values_sql=updates)
        self._respond(200, dumps(stats))

    def op_delete(self, name):
        body = loads(self._read_body())
        t = self._open(name, {"branch": body.get("branch")})
        n = t.delete(body["predicate"])
        self._respond(200, dumps({"deleted_rows": n, "version": t.version}))

    def op_merge_insert(self, name):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        data = ipc_to_table(self._read_body())
        t = self._open(name, {"branch": params.get("branch")})
        on = params.get("on", "").split(",")
        b = t.merge_insert(on)
        if params.get("when_matched_update_all") == "true":
            b.when_matched_update_all(params.get("when_matched_update_all_filt") or None)
        if params.get("when_not_matched_insert_all") == "true":
            b.when_not_matched_insert_all()
        if params.get("when_not_matched_by_source_delete") == "true":
            b.when_not_matched_by_source_delete(
                params.get("when_not_matched_by_source_delete_filt") or None
            )
        stats = b.execute(data)
        self._respond(200, dumps(stats))

    # ----------------------------------------------------------- indexes
    def _do_create_index(self, name, body):
        t = self.conn.open_table(name)
        index_type = body.get("index_type", "IVF_PQ").upper()
        if index_type == "FTS":
            fts_kw = {
                k: body[k]
                for k in (
                    "with_position", "tokenizer_name", "base_tokenizer",
                    "language", "max_token_length", "lower_case", "stem",
                    "remove_stop_words", "ascii_folding",
                    "ngram_min_length", "ngram_max_length", "prefix_only",
                )
                if k in body
            }
            t.create_fts_index(body["column"], **fts_kw)
        elif index_type in ("BTREE", "BITMAP", "LABEL_LIST", "FM"):
            t.create_scalar_index(body["column"], index_type=index_type)
        elif index_type.startswith("IVF_HNSW") and (
            body.get("m") is not None or body.get("ef_construction") is not None
        ):
            # graph knobs live on the Hnsw* config dataclasses
            from ..index import HnswFlat, HnswPq, HnswSq

            cls = {
                "IVF_HNSW_FLAT": HnswFlat,
                "IVF_HNSW_SQ": HnswSq,
                "IVF_HNSW_PQ": HnswPq,
            }[index_type]
            kw = {"distance_type": body.get("metric_type", "l2")}
            if body.get("num_partitions") is not None:
                kw["num_partitions"] = body["num_partitions"]
            if body.get("m") is not None:
                kw["m"] = body["m"]
            if body.get("ef_construction") is not None:
                kw["ef_construction"] = body["ef_construction"]
            if index_type == "IVF_HNSW_PQ" and body.get("num_sub_vectors") is not None:
                kw["num_sub_vectors"] = body["num_sub_vectors"]
            t.create_index(vector_column_name=body.get("column"), config=cls(**kw))
        else:
            extra = {
                k: body[k]
                for k in ("num_bits", "sample_rate", "max_iterations")
                if body.get(k) is not None
            }
            t.create_index(
                metric=body.get("metric_type", body.get("distance_type", "l2")),
                num_partitions=body.get("num_partitions"),
                num_sub_vectors=body.get("num_sub_vectors"),
                vector_column_name=body.get("column"),
                index_type=index_type,
                **extra,
            )

    def op_create_index(self, name):
        body = loads(self._read_body())
        self._do_create_index(name, body)
        self._respond(200, dumps({}))

    def op_create_index_async(self, name):
        """Server-side background index build returning a job id the
        client polls via /v1/jobs (reference index.rs:313
        create_index_async → Job over REST)."""
        body = loads(self._read_body())
        # validate the table exists before accepting the job
        self.conn.open_table(name)
        job = self.conn._jobs.submit(
            "create_index", lambda: self._do_create_index(name, body)
        )
        self._respond(202, dumps({"job": job._info.to_dict()}))

    # ---- connection-level job APIs (reference connection.rs:526-556) --
    def op_jobs_list(self):
        qs = self.path.split("?", 1)[1] if "?" in self.path else ""
        include_finished = "include_finished=false" not in qs
        self._respond(200, dumps({"jobs": self.conn.list_jobs(include_finished)}))

    def op_jobs_history(self):
        self._respond(200, dumps({"jobs": self.conn.job_history()}))

    def op_jobs_get(self, job_id):
        job = self.conn.get_job(job_id)
        if job is None:
            return self._error(404, f"no job {job_id!r}")
        self._respond(200, dumps({"job": job._info.to_dict()}))

    def op_jobs_cancel(self, job_id):
        job = self.conn.get_job(job_id)
        if job is None:
            return self._error(404, f"no job {job_id!r}")
        cancelled = job.cancel()
        self._respond(200, dumps({"cancelled": bool(cancelled),
                                  "job": job._info.to_dict()}))

    def op_index_list(self, name):
        t = self.conn.open_table(name)
        self._respond(200, dumps({"indexes": t.list_indices()}))

    def op_index_stats(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        stats = t.index_stats(body["index_name"])
        if stats is None:
            return self._error(404, f"index {body['index_name']} not found")
        self._respond(200, dumps(stats))

    def op_index_drop(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.drop_index(body["index_name"])
        self._respond(200, dumps({}))

    # ----------------------------------------------------------- versions
    def op_version_list(self, name):
        t = self.conn.open_table(name)
        self._respond(200, dumps({"versions": t.list_versions()}))

    def op_checkout(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.checkout(body["version"])
        self._respond(200, dumps({"version": t.version}))

    def op_restore(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.restore(body.get("version"))
        self._respond(200, dumps({"version": t.version}))

    # -------------------------------------------------------------- tags
    def op_tags_list(self, name):
        t = self.conn.open_table(name)
        self._respond(200, dumps(t.tags.list()))

    def op_tags_create(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.tags.create(body["tag"], body.get("version"))
        self._respond(200, dumps({}))

    def op_tags_delete(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.tags.delete(body["tag"])
        self._respond(200, dumps({}))

    def op_tags_update(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.tags.update(body["tag"], body["version"])
        self._respond(200, dumps({}))

    # ----------------------------------------------------------- optimize
    def op_optimize(self, name):
        t = self.conn.open_table(name)
        self._respond(200, dumps(t.optimize()))

    # -------------------------------------------------------- permutation
    def op_permutation(self, name):
        """Build a dataloader permutation table server-side (reference
        nodejs permutation.ts PermutationBuilder over the native builder;
        python data/permutation.py is the engine). Body:
        ``{dest?, filter?, shuffle?: {seed, clump_size,
        memory_budget_bytes}, split?: {kind: random|hash|sequential|
        calculated, ...strategy args}}``. Returns the created table name
        plus per-split sizes."""
        from ..data.permutation import permutation_builder

        body = loads(self._read_body())
        t = self.conn.open_table(name)
        b = permutation_builder(t, body.get("dest"))
        split = body.get("split") or {}
        kind = split.get("kind", "none")
        if kind == "random":
            b.split_random(
                seed=split.get("seed", 42),
                fractions=split.get("fractions"),
                counts=split.get("counts"),
                clump_size=split.get("clump_size"),
            )
        elif kind == "hash":
            b.split_hash(
                split["columns"],
                split["split_weights"],
                split.get("discard_weight", 0),
            )
        elif kind == "sequential":
            b.split_sequential(split.get("sizes"))
        elif kind == "calculated":
            b.split_calculated(split["sql"])
        elif kind != "none":
            raise InvalidInputError(f"unknown split kind {kind!r}")
        if body.get("shuffle") is not None:
            sh = body["shuffle"] or {}
            b.shuffle(
                seed=sh.get("seed", 42),
                clump_size=sh.get("clump_size"),
                memory_budget_bytes=sh.get("memory_budget_bytes", 100 << 20),
            )
        if body.get("filter"):
            b.filter(body["filter"])
        perm = b.execute()
        self._respond(
            200,
            dumps({
                "table": perm.perm_table.name,
                "num_rows": len(perm),
                "num_splits": perm.num_splits,
                "split_sizes": {
                    str(s): perm.split_size(s)
                    for s in sorted(perm._split_offsets)
                },
            }),
        )

    # ---------------------------------------------------------- branches
    def op_branches_list(self, name):
        t = self.conn.open_table(name)
        self._respond(200, dumps({"branches": t.list_branches()}))

    def op_branches_create(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.create_branch(body["branch"], body.get("version"))
        self._respond(200, dumps({}))

    def op_branches_delete(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.delete_branch(body["branch"])
        self._respond(200, dumps({}))

    def op_branches_diff(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        self._respond(200, dumps(t.diff_branch(body["branch"])))

    def op_branches_merge(self, name):
        body = loads(self._read_body())
        # "branch" is the merge SOURCE; the checkout base rides separately
        t = self._open(name, {"branch": body.get("base_branch")})
        self._respond(200, dumps(t.merge_branch(body["branch"])))

    # --------------------------------------------------- schema evolution
    def op_add_columns(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.add_columns(dict(body["new_columns"]))
        self._respond(200, dumps({"version": t.version}))

    def op_alter_columns(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.alter_columns(*body["alterations"])
        self._respond(200, dumps({"version": t.version}))

    def op_drop_columns(self, name):
        body = loads(self._read_body())
        t = self.conn.open_table(name)
        t.drop_columns(body["columns"])
        self._respond(200, dumps({"version": t.version}))

    # ---------------------------------------------------------- multipart
    # reference remote/table.rs multipart_write/{create,complete,abort}:
    # large inserts stream as bounded parts, committed atomically at
    # complete. Parts buffer server-side keyed by upload id.
    _uploads: dict = {}
    _uploads_lock = threading.Lock()

    def op_multipart_create(self, name):
        uid = _uuid.uuid4().hex
        with self._uploads_lock:
            self._uploads[uid] = {}
        self._respond(200, dumps({"id": uid}))

    def op_multipart_put(self, name):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        uid, part = params["id"], int(params["part"])
        data = ipc_to_table(self._read_body())
        with self._uploads_lock:
            if uid not in self._uploads:
                return self._error(404, f"unknown upload {uid}")
            self._uploads[uid][part] = data
        self._respond(200, dumps({}))

    def op_multipart_complete(self, name):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        uid = params["id"]
        with self._uploads_lock:
            parts = self._uploads.pop(uid, None)
        if parts is None:
            return self._error(404, f"unknown upload {uid}")
        data = pa.concat_tables([parts[k] for k in sorted(parts)])
        t = self.conn.open_table(name)
        t.add(data, mode=params.get("mode", "append"))
        self._respond(200, dumps({"version": t.version, "rows": data.num_rows}))

    def op_multipart_abort(self, name):
        import urllib.parse

        q = urllib.parse.urlparse(self.path).query
        params = dict(urllib.parse.parse_qsl(q))
        with self._uploads_lock:
            self._uploads.pop(params["id"], None)
        self._respond(200, dumps({}))

    # ------------------------------------------------------------- blobs
    def op_blob_describe(self, name):
        """Blob descriptors by row address (reference
        remote/table/blobs.rs): {column, row_ids} → {blobs: [{file,
        position, size} | null]} — the client builds range-backed
        lazy handles from these."""
        from ..blob import fetch_blob_files

        body = loads(self._read_body())
        t = self._open(name, body)
        files = fetch_blob_files(
            t._dataset, body["column"], np.asarray(body["row_ids"], dtype=np.uint64)
        )
        root = t._dataset.root
        self._respond(
            200,
            dumps({
                "blobs": [
                    None if bf is None
                    else {
                        "file": bf._path[len(root) + 1:],
                        "position": bf._base,
                        "size": bf.size(),
                    }
                    for bf in files
                ]
            }),
        )

    def op_blob_read(self, name):
        """Blob payloads (optionally ranged) as one Arrow IPC stream
        with a nullable `data: binary` column — {column, row_ids,
        ranges?: [[start, length] | null]}."""
        from ..blob import fetch_blob_files

        body = loads(self._read_body())
        t = self._open(name, body)
        files = fetch_blob_files(
            t._dataset, body["column"], np.asarray(body["row_ids"], dtype=np.uint64)
        )
        ranges = body.get("ranges")
        payloads: list[bytes | None] = []
        for i, bf in enumerate(files):
            if bf is None:
                payloads.append(None)
                continue
            r = ranges[i] if ranges is not None else None
            payloads.append(bf.read() if r is None else bf.read_range(int(r[0]), int(r[1])))
        out = pa.table({"data": pa.array(payloads, type=pa.large_binary())})
        self._respond(200, table_to_ipc(out), CONTENT_ARROW)


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets the sixth of
    # a burst of concurrent connections, the clients the batcher serves
    request_queue_size = 128


class QueryServer:
    """A lancedb-tpu-torch server over one database directory."""

    def __init__(
        self,
        uri: str,
        host: str = "127.0.0.1",
        port: int = 0,
        api_key: str | None = None,
        batch_window_ms: float = 2.0,
        max_batch: int = 64,
        serving_mesh=None,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        tls_client_ca: str | None = None,
        device=None,
    ):
        """``uri`` may also be an existing connection object (its table/
        session caches are then shared with the server); it keeps its own
        device, and a different ``device`` beside it is refused. A URI is
        connected on ``device`` (None: the card, raising without one).
        ``serving_mesh`` (a ``parallel.make_mesh`` grid of devices) turns
        on mesh-sharded IVF_PQ serving for every table the server opens
        (Table.enable_sharded_serving). ``tls_cert``/``tls_key``
        serve HTTPS; ``tls_client_ca`` additionally REQUIRES a client
        certificate signed by that CA (mTLS — the server face of the
        reference's ClientConfig TLS identity, remote/client.rs:66-285)."""
        if tls_client_ca is not None and tls_cert is None:
            raise ValueError(
                "tls_client_ca requires tls_cert/tls_key: client-cert "
                "enforcement only happens on a TLS-wrapped socket"
            )
        mtls = tls_client_ca is not None and tls_cert is not None
        if api_key is None and not mtls and host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(
                "QueryServer exposes mutating endpoints (drop/delete/update/"
                "restore); binding to a non-loopback host requires api_key= "
                "or mTLS (tls_client_ca=)"
            )
        from .batching import MicroBatcher

        if hasattr(uri, "open_table"):
            if device is not None and not _same_device(resolve_device(device), uri.device):
                raise InvalidInputError(
                    f"the connection runs on {uri.device}; a server over it cannot take "
                    f"device {device!r}"
                )
            self._conn = uri
        else:
            self._conn = LanceDBConnection(uri, device=device)
        self._serving_mesh = serving_mesh
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "conn": self._conn,
                "api_key": api_key,
                "serving_mesh": serving_mesh,
                # latest-version table cache: keeps per-table serving
                # state (sharded searchers) resident across requests;
                # time-travel opens stay uncached
                "_table_cache": {},
                "_table_cache_lock": threading.Lock(),
                # per-server multipart upload buffers
                "_uploads": {},
                "_uploads_lock": threading.Lock(),
                # dynamic micro-batching of concurrent vector queries
                # (remote/batching.py); 0 disables
                "_batcher": (
                    MicroBatcher(window_s=batch_window_ms / 1000.0, max_batch=max_batch)
                    if batch_window_ms > 0
                    else None
                ),
            },
        )
        self._httpd = _HTTPServer((host, port), handler)
        self._scheme = "http"
        if tls_cert is not None:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            if tls_client_ca is not None:
                ctx.verify_mode = ssl.CERT_REQUIRED
                ctx.load_verify_locations(tls_client_ca)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
            self._scheme = "https"
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{self._scheme}://{host}:{port}"

    def start(self) -> "QueryServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main():  # pragma: no cover - CLI entry
    import argparse

    ap = argparse.ArgumentParser(description="lancedb-tpu-torch query server")
    ap.add_argument("uri", help="database directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument(
        "--api-key",
        default=None,
        help="require this x-api-key on every request "
        "(mandatory for non-loopback hosts; env LANCEDB_TPU_API_KEY)",
    )
    ap.add_argument("--device", default=None,
                    help="the torch device the tables run on (default: the CUDA card)")
    args = ap.parse_args()
    import os

    api_key = args.api_key or os.environ.get("LANCEDB_TPU_API_KEY")
    server = QueryServer(args.uri, args.host, args.port, api_key=api_key, device=args.device)
    print(f"serving {args.uri} at {server.url} port={server.port}", flush=True)
    server._httpd.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
