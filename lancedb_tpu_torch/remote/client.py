"""Remote database client: REST + Arrow IPC with retries.

Reference: remote/client.rs (ClientConfig `:66-285`, retry w/ backoff +
jitter on 409/429/5xx `:753` + retry.rs, request-id header `:16`),
remote/db.rs `RemoteDatabase`, remote/table.rs `RemoteTable` (full
BaseTable over POST /v1/table/{id}/...). Stdlib urllib — no external
HTTP dependency.
"""

from __future__ import annotations

import random
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pyarrow as pa

from ..errors import HttpError, InvalidInputError, RetryError
from .protocol import (
    CONTENT_ARROW,
    CONTENT_JSON,
    REQUEST_ID_HEADER,
    dumps,
    ipc_to_table,
    loads,
    table_to_ipc,
)


@dataclass
class TimeoutConfig:
    """Reference remote/client.rs:186 TimeoutConfig."""

    connect_timeout: float = 120.0
    read_timeout: float = 300.0


@dataclass
class RetryConfig:
    """Reference remote/client.rs:222-284 RetryConfig."""

    retries: int = 3
    connect_retries: int = 3
    read_retries: int = 3
    backoff_factor: float = 0.25
    backoff_jitter: float = 0.25
    statuses: tuple[int, ...] = (409, 429, 500, 502, 503)


@dataclass
class TlsConfig:
    """TLS / mTLS identity (reference remote/client.rs:66-285
    ClientConfig TLS options): `ca_file` pins the trust root,
    `cert_file`+`key_file` present a client certificate (mTLS),
    `assert_hostname=False` disables hostname verification,
    `skip_verify=True` disables certificate verification entirely
    (reference ssl_skip_verify; never use outside tests)."""

    ca_file: str | None = None
    cert_file: str | None = None
    key_file: str | None = None
    assert_hostname: bool = True
    skip_verify: bool = False


@dataclass
class ClientConfig:
    """Reference remote/client.rs:66 ClientConfig."""

    user_agent: str = "lancedb-tpu-python/0.1.0"
    retry_config: RetryConfig = field(default_factory=RetryConfig)
    timeout_config: TimeoutConfig = field(default_factory=TimeoutConfig)
    tls_config: "TlsConfig | None" = None
    extra_headers: dict[str, str] = field(default_factory=dict)
    # callable returning per-request headers (reference remote/client.rs
    # header providers — rotating OAuth tokens etc.)
    header_provider: Any | None = None
    # inserts larger than this stream through the multipart endpoints
    # (reference insert batching, client.rs:50 — 8 GiB there)
    max_insert_bytes: int = 256 * 1024 * 1024


class RestClient:
    def __init__(
        self,
        base_url: str,
        api_key: str | None = None,
        config: ClientConfig | None = None,
        transport: Any | None = None,
    ):
        """`transport` swaps the HTTP send layer for tests — the
        reference's MockSender (remote/client.rs:930-1050): a callable
        (method, url, headers, body) -> (status, body_bytes)."""
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.config = config or ClientConfig()
        self.transport = transport
        self._ssl_ctx = None

    def _ssl_context(self):
        """SSL context for https URLs, honoring TlsConfig (mTLS client
        identity, pinned CA, verification switches). Built once."""
        if self._ssl_ctx is not None:
            return self._ssl_ctx
        import ssl

        tls = self.config.tls_config or TlsConfig()
        ctx = ssl.create_default_context(cafile=tls.ca_file)
        if tls.cert_file:
            ctx.load_cert_chain(tls.cert_file, tls.key_file)
        if not tls.assert_hostname or tls.skip_verify:
            ctx.check_hostname = False
        if tls.skip_verify:
            ctx.verify_mode = ssl.CERT_NONE
        self._ssl_ctx = ctx
        return ctx

    def request(
        self,
        method: str,
        path: str,
        *,
        json_body: Any | None = None,
        raw_body: bytes | None = None,
        params: dict | None = None,
        content_type: str = CONTENT_JSON,
    ) -> tuple[int, bytes, dict]:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        body = raw_body if raw_body is not None else (dumps(json_body) if json_body is not None else None)
        rc = self.config.retry_config
        request_id = _uuid.uuid4().hex
        last_err: Exception | None = None
        for attempt in range(rc.retries + 1):
            headers = {
                "user-agent": self.config.user_agent,
                REQUEST_ID_HEADER: request_id,
                "content-type": content_type,
            }
            if self.api_key:
                headers["x-api-key"] = self.api_key
            headers.update(self.config.extra_headers)
            if self.config.header_provider is not None:
                headers.update(self.config.header_provider())
            if self.transport is not None:
                status, payload = self.transport(method, url, headers, body)
                if status < 400:
                    return status, payload, {}
                if status in rc.statuses and attempt < rc.retries:
                    time.sleep(rc.backoff_factor * (2**attempt))
                    last_err = HttpError(f"status {status}", status_code=status)
                    continue
                message = payload.decode(errors="replace")
                try:
                    message = loads(payload).get("error", message)
                except Exception:
                    pass
                raise HttpError(message, status_code=status, request_id=request_id)
            req = urllib.request.Request(url, data=body, method=method)
            for k, v in headers.items():
                req.add_header(k, v)
            try:
                ctx = self._ssl_context() if url.startswith("https") else None
                with urllib.request.urlopen(
                    req, timeout=self.config.timeout_config.read_timeout, context=ctx
                ) as resp:
                    return resp.status, resp.read(), dict(resp.headers)
            except urllib.error.HTTPError as e:
                payload = e.read()
                if e.code in rc.statuses and attempt < rc.retries:
                    delay = rc.backoff_factor * (2**attempt)
                    delay += random.uniform(0, rc.backoff_jitter)
                    time.sleep(delay)
                    last_err = e
                    continue
                message = payload.decode(errors="replace")
                try:
                    message = loads(payload).get("error", message)
                except Exception:
                    pass
                raise HttpError(message, status_code=e.code, request_id=request_id) from None
            except urllib.error.URLError as e:
                if attempt < rc.connect_retries:
                    time.sleep(rc.backoff_factor * (2**attempt))
                    last_err = e
                    continue
                raise HttpError(f"connection failed: {e.reason}", request_id=request_id) from None
        raise RetryError(
            f"retries exhausted after {rc.retries + 1} attempts: {last_err}",
            request_id=request_id,
        )

    def post_json(self, path: str, body: Any | None = None, params: dict | None = None) -> dict:
        _, data, _ = self.request("POST", path, json_body=body or {}, params=params)
        return loads(data)

    def post_arrow_in(self, path: str, tbl: pa.Table, params: dict | None = None) -> dict:
        _, data, _ = self.request(
            "POST", path, raw_body=table_to_ipc(tbl), params=params, content_type=CONTENT_ARROW
        )
        return loads(data)

    def post_arrow_out(self, path: str, body: Any) -> pa.Table:
        _, data, _ = self.request("POST", path, json_body=body)
        return ipc_to_table(data)

    def get_json(self, path: str, params: dict | None = None) -> dict:
        _, data, _ = self.request("GET", path, params=params)
        return loads(data)


class RemoteTable:
    """Client-side table handle (reference remote/table.rs:270)."""

    def __init__(self, client: RestClient, name: str):
        self._c = client
        self.name = name

    def _p(self, op: str) -> str:
        return f"/v1/table/{urllib.parse.quote(self.name)}/{op}/"

    # ---- reads ----
    @property
    def schema(self) -> pa.Schema:
        desc = self.describe()
        fields = [
            pa.field(f["name"], _parse_type(f["type"]), nullable=f["nullable"])
            for f in desc["schema"]["fields"]
        ]
        return pa.schema(fields)

    # client-side read pin: the server is stateless per request, so
    # checkout() records the version/branch here and every read sends it
    # (reference RemoteTable passes the read version with each request)
    _read_version = None
    _read_branch = None

    def _read_params(self) -> dict:
        out = {}
        if self._read_version is not None:
            out["version"] = self._read_version
        if self._read_branch is not None:
            out["branch"] = self._read_branch
        return out

    def describe(self) -> dict:
        return self._c.post_json(self._p("describe"), self._read_params() or None)

    @property
    def version(self) -> int:
        return self.describe()["version"]

    def count_rows(self, filter: str | None = None) -> int:
        return self._c.post_json(
            self._p("count_rows"), {"predicate": filter, **self._read_params()}
        )

    def stats(self) -> dict:
        return self.describe()["stats"]

    # ---- search ----
    def search(self, query=None, vector_column_name=None, query_type="auto", fts_columns=None):
        from .query import RemoteQueryBuilder

        return RemoteQueryBuilder(self, query, vector_column_name, query_type, fts_columns)

    def _query(self, body: dict) -> pa.Table:
        return self._c.post_arrow_out(self._p("query"), {**self._read_params(), **body})

    def explain_plan(self, vector, k: int = 10, **options) -> str:
        """Extra keyword options (nprobes, minimum_nprobes,
        maximum_nprobes, ef, refine_factor, filter, ...) pass through to
        the plan request body."""
        return self._c.post_json(
            self._p("explain_plan"),
            {"vector": list(map(float, vector)), "k": k, **options},
        )["plan"]

    def analyze_plan(self, vector, k: int = 10, mode: str = "aggregate", **options) -> str:
        """mode: 'aggregate' (merged plan), 'per_worker' or 'full'
        (one section per worker — reference analyze_plan distributed
        display modes, query.rs:671-693)."""
        doc = self._c.post_json(
            self._p("analyze_plan"),
            {"vector": list(map(float, vector)), "k": k, **options},
        )
        mode = mode.lower()
        if mode in ("per_worker", "full") and doc.get("workers"):
            sections = []
            for w in doc["workers"]:
                sections.append(f"--- worker {w['worker']} ---\n{w['plan']}")
            if mode == "full":
                sections.insert(0, f"--- aggregate ---\n{doc['plan']}")
            return "\n".join(sections)
        return doc["plan"]

    # ---- writes ----
    def add(self, data, mode: str = "append") -> None:
        from ..arrow import to_arrow_table

        tbl = to_arrow_table(data)
        if tbl.nbytes > self._c.config.max_insert_bytes:
            return self._add_multipart(tbl, mode)
        params = {"mode": mode}
        if self._read_branch:
            params["branch"] = self._read_branch
        self._c.post_arrow_in(self._p("insert"), tbl, params=params)

    def _add_multipart(self, tbl: pa.Table, mode: str) -> None:
        """Stream a large insert as bounded parts committed atomically at
        complete (reference remote/table.rs multipart_write endpoints)."""
        uid = self._c.post_json(self._p("multipart/create"))["id"]
        try:
            budget = max(1, self._c.config.max_insert_bytes)
            rows_per_part = max(1, int(tbl.num_rows * budget / max(tbl.nbytes, 1)))
            part = 0
            for start in range(0, tbl.num_rows, rows_per_part):
                chunk = tbl.slice(start, rows_per_part)
                self._c.post_arrow_in(
                    self._p("multipart/put"), chunk,
                    params={"id": uid, "part": str(part)},
                )
                part += 1
            self._c.post_json(
                self._p("multipart/complete"), params={"id": uid, "mode": mode}
            )
        except Exception:
            try:
                self._c.post_json(self._p("multipart/abort"), params={"id": uid})
            finally:
                raise

    def update(self, where: str | None = None, values: dict | None = None, *, values_sql: dict | None = None) -> dict:
        updates = []
        for col, val in (values or {}).items():
            if isinstance(val, str):
                updates.append([col, "'" + val.replace("'", "''") + "'"])
            else:
                updates.append([col, repr(val)])
        for col, expr in (values_sql or {}).items():
            updates.append([col, expr])
        return self._c.post_json(
            self._p("update"),
            {"predicate": where, "updates": updates, **self._read_params()},
        )

    def delete(self, predicate: str) -> int:
        return self._c.post_json(
            self._p("delete"), {"predicate": predicate, **self._read_params()}
        )["deleted_rows"]

    def merge_insert(self, on: str | list[str]):
        from ..table import MergeInsertBuilder

        on = [on] if isinstance(on, str) else list(on)
        outer = self

        class _RemoteMergeBuilder(MergeInsertBuilder):
            def __init__(self):
                self._on = on
                self._update_all = False
                self._update_condition = None
                self._insert_all = False
                self._delete_missing = False
                self._delete_condition = None

            def execute(self, new_data, timeout=None) -> dict:
                from ..arrow import to_arrow_table

                params = {
                    "on": ",".join(self._on),
                    "when_matched_update_all": str(self._update_all).lower(),
                    "when_not_matched_insert_all": str(self._insert_all).lower(),
                    "when_not_matched_by_source_delete": str(self._delete_missing).lower(),
                }
                if self._update_condition:
                    params["when_matched_update_all_filt"] = self._update_condition
                if self._delete_condition:
                    params["when_not_matched_by_source_delete_filt"] = self._delete_condition
                if outer._read_branch:
                    params["branch"] = outer._read_branch
                return outer._c.post_arrow_in(
                    outer._p("merge_insert"), to_arrow_table(new_data), params=params
                )

        return _RemoteMergeBuilder()

    # ---- indexes ----
    def create_index(
        self,
        metric: str = "l2",
        num_partitions: int | None = None,
        num_sub_vectors: int | None = None,
        vector_column_name: str | None = None,
        index_type: str = "IVF_PQ",
        **kw,
    ) -> None:
        self._c.post_json(
            self._p("create_index"),
            {
                "column": vector_column_name,
                "index_type": index_type,
                "metric_type": metric,
                "num_partitions": num_partitions,
                "num_sub_vectors": num_sub_vectors,
                **{k: v for k, v in kw.items()
                   if k in ("num_bits", "sample_rate", "max_iterations")},
            },
        )

    def create_index_async(
        self,
        metric: str = "l2",
        num_partitions: int | None = None,
        num_sub_vectors: int | None = None,
        vector_column_name: str | None = None,
        index_type: str = "IVF_PQ",
        **kw,
    ) -> "RemoteJob":
        """Server-side background index build; returns a RemoteJob the
        caller polls/waits on (reference index.rs:313 create_index_async
        returning a Job over REST)."""
        doc = self._c.post_json(
            self._p("create_index_async"),
            {
                "column": vector_column_name,
                "index_type": index_type,
                "metric_type": metric,
                "num_partitions": num_partitions,
                "num_sub_vectors": num_sub_vectors,
                **{k: v for k, v in kw.items()
                   if k in ("num_bits", "sample_rate", "max_iterations")},
            },
        )
        return RemoteJob(self._c, doc["job"])

    def create_scalar_index(self, column: str, index_type: str = "BTREE", **kw) -> None:
        self._c.post_json(self._p("create_index"), {"column": column, "index_type": index_type})

    def create_fts_index(self, field_names, **kw) -> None:
        self._c.post_json(
            self._p("create_index"),
            {"column": field_names, "index_type": "FTS", **{k: v for k, v in kw.items() if isinstance(v, (str, int, bool))}},
        )

    def list_indices(self) -> list[dict]:
        return self._c.post_json(self._p("index/list"))["indexes"]

    def index_stats(self, index_name: str) -> dict:
        return self._c.post_json(self._p("index/stats"), {"index_name": index_name})

    def drop_index(self, name: str) -> None:
        self._c.post_json(self._p("index/drop"), {"index_name": name})

    # ---- versions / tags ----
    def list_versions(self) -> list[dict]:
        return self._c.post_json(self._p("version/list"))["versions"]

    def checkout(self, version: int) -> None:
        self._read_version = version

    def checkout_latest(self) -> None:
        self._read_version = None

    def checkout_branch(self, name: str) -> None:
        self._read_branch = name if name != "main" else None
        self._read_version = None

    def restore(self, version: int | None = None) -> None:
        self._c.post_json(
            self._p("restore"), {"version": version or self._read_version}
        )
        self._read_version = None

    def optimize(self) -> dict:
        return self._c.post_json(self._p("optimize"))

    def permutation_builder(self, dest: str | None = None) -> "RemotePermutationBuilder":
        """Server-side dataloader permutation build (reference
        nodejs/lancedb/permutation.ts PermutationBuilder; the engine is
        data/permutation.py running inside the server)."""
        return RemotePermutationBuilder(self._c, self.name, dest)

    # ---- blobs (reference remote/table/blobs.rs) ----
    def fetch_blobs(self, column: str, row_ids: list[int]) -> list[bytes | None]:
        """Materialize blob payloads over the wire (one request)."""
        tbl = self._c.post_arrow_out(
            self._p("blob_read"), {"column": column, "row_ids": list(map(int, row_ids))}
        )
        return tbl.column("data").to_pylist()

    def fetch_blob_ranges(
        self, column: str, row_ids: list[int], ranges: list[tuple[int, int]]
    ) -> list[bytes | None]:
        """Per-blob (start, length) range reads — HTTP-range-equivalent
        through the server's object-store range reads."""
        tbl = self._c.post_arrow_out(
            self._p("blob_read"),
            {
                "column": column,
                "row_ids": list(map(int, row_ids)),
                "ranges": [list(r) for r in ranges],
            },
        )
        return tbl.column("data").to_pylist()

    def fetch_blob_files(self, column: str, row_ids: list[int]) -> "list[RemoteBlobFile | None]":
        """Lazy seekable handles: one describe round trip now, then each
        read issues a ranged blob_read (reference fetch_blob_files over
        HTTP range reads)."""
        doc = self._c.post_json(
            self._p("blob_describe"),
            {"column": column, "row_ids": list(map(int, row_ids))},
        )
        out: list[RemoteBlobFile | None] = []
        for i, d in enumerate(doc["blobs"]):
            if d is None:
                out.append(None)
            else:
                out.append(
                    RemoteBlobFile(self, column, int(row_ids[i]), d["size"])
                )
        return out

    # ---- branches (reference remote/table.rs branches/*) ----
    def list_branches(self) -> dict:
        return self._c.post_json(self._p("branches/list"))["branches"]

    def create_branch(self, name: str, version: int | None = None) -> None:
        self._c.post_json(
            self._p("branches/create"), {"branch": name, "version": version}
        )

    def delete_branch(self, name: str) -> None:
        self._c.post_json(self._p("branches/delete"), {"branch": name})

    def diff_branch(self, name: str) -> dict:
        return self._c.post_json(self._p("branches/diff"), {"branch": name})

    def merge_branch(self, name: str) -> dict:
        body = {"branch": name}
        if self._read_branch:
            body["base_branch"] = self._read_branch
        return self._c.post_json(self._p("branches/merge"), body)

    # ---- schema evolution (reference remote/table.rs add/alter/drop) ----
    def add_columns(self, transforms: dict[str, str]) -> None:
        self._c.post_json(
            self._p("add_columns"), {"new_columns": list(transforms.items())}
        )

    def alter_columns(self, *alterations: dict) -> None:
        self._c.post_json(self._p("alter_columns"), {"alterations": list(alterations)})

    def drop_columns(self, columns: list[str]) -> None:
        self._c.post_json(self._p("drop_columns"), {"columns": list(columns)})

    @property
    def tags(self):
        outer = self

        class _Tags:
            def list(self):
                return outer._c.post_json(outer._p("tags/list"))

            def create(self, name, version=None):
                outer._c.post_json(outer._p("tags/create"), {"tag": name, "version": version})

            def delete(self, name):
                outer._c.post_json(outer._p("tags/delete"), {"tag": name})

            def update(self, name, version):
                outer._c.post_json(outer._p("tags/update"), {"tag": name, "version": version})

        return _Tags()


class RemotePermutationBuilder:
    """Fluent remote twin of data/permutation.py `PermutationBuilder`
    (reference nodejs/lancedb/permutation.ts): accumulates the split/
    shuffle/filter spec client-side, POSTs one /permutation request on
    execute, and returns the created permutation table's handle + sizes."""

    def __init__(self, client: "RestClient", table: str, dest: str | None = None):
        self._c = client
        self._table = table
        self._body: dict = {"dest": dest}

    def split_random(self, *, seed: int = 42, fractions=None, counts=None,
                     clump_size=None) -> "RemotePermutationBuilder":
        self._body["split"] = {
            "kind": "random", "seed": seed, "fractions": fractions,
            "counts": counts, "clump_size": clump_size,
        }
        return self

    def split_hash(self, columns, split_weights, discard_weight: int = 0):
        self._body["split"] = {
            "kind": "hash", "columns": list(columns),
            "split_weights": list(split_weights),
            "discard_weight": discard_weight,
        }
        return self

    def split_sequential(self, sizes=None) -> "RemotePermutationBuilder":
        self._body["split"] = {"kind": "sequential", "sizes": sizes}
        return self

    def split_calculated(self, sql: str) -> "RemotePermutationBuilder":
        self._body["split"] = {"kind": "calculated", "sql": sql}
        return self

    def shuffle(self, seed: int = 42, clump_size=None,
                memory_budget_bytes: int = 100 << 20) -> "RemotePermutationBuilder":
        self._body["shuffle"] = {
            "seed": seed, "clump_size": clump_size,
            "memory_budget_bytes": memory_budget_bytes,
        }
        return self

    def filter(self, predicate: str) -> "RemotePermutationBuilder":
        self._body["filter"] = predicate
        return self

    def execute(self) -> dict:
        return self._c.post_json(
            f"/v1/table/{urllib.parse.quote(self._table)}/permutation/", self._body
        )


class RemoteBlobFile:
    """File-like lazy handle over one remote blob (the remote twin of
    blob.py `BlobFile`; reference remote/table/blobs.rs HTTP-range
    reads): read/seek/tell, each read is one ranged blob_read call."""

    def __init__(self, table: "RemoteTable", column: str, row_id: int, size: int):
        self._t = table
        self._column = column
        self._row_id = row_id
        self._size = size
        self._pos = 0
        self._closed = False

    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = 0) -> int:
        import io as _io

        if whence == _io.SEEK_SET:
            self._pos = offset
        elif whence == _io.SEEK_CUR:
            self._pos += offset
        elif whence == _io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        self._pos = max(0, min(self._pos, self._size))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("read on a closed RemoteBlobFile")
        length = self._size - self._pos if n < 0 else min(n, self._size - self._pos)
        if length <= 0:
            return b""
        data = self.read_range(self._pos, length)
        self._pos += len(data)
        return data

    def read_range(self, start: int, length: int) -> bytes:
        res = self._t.fetch_blob_ranges(
            self._column, [self._row_id], [(start, length)]
        )[0]
        return res if res is not None else b""

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RemoteJob:
    """Client handle over a server-side job (reference job.rs:16-31:
    status/wait/cancel). State refreshes by polling GET /v1/jobs/<id>."""

    _TERMINAL = ("SUCCEEDED", "FAILED", "CANCELLED")

    def __init__(self, client: RestClient, info: dict):
        self._c = client
        self._info = dict(info)

    @property
    def id(self) -> str:
        return self._info["id"]

    def refresh(self) -> dict:
        self._info = self._c.get_json(f"/v1/jobs/{self.id}")["job"]
        return dict(self._info)

    def status(self) -> str:
        if self._info.get("status") not in self._TERMINAL:
            self.refresh()
        return self._info["status"]

    def done(self) -> bool:
        return self.status() in self._TERMINAL

    def wait(self, timeout: float | None = None, poll_interval: float = 0.1) -> dict:
        """Poll until the job reaches a terminal state; raises
        JobFailureError on FAILED/CANCELLED, TimeoutError on timeout."""
        import time as _time

        from ..errors import JobFailureError

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            status = self.status()
            if status == "SUCCEEDED":
                return dict(self._info)
            if status in ("FAILED", "CANCELLED"):
                raise JobFailureError(
                    f"job {self.id} {status.lower()}: {self._info.get('error')}"
                )
            if deadline is not None and _time.monotonic() > deadline:
                raise TimeoutError(f"job {self.id} still {status} after {timeout}s")
            _time.sleep(poll_interval)

    def cancel(self) -> bool:
        doc = self._c.post_json(f"/v1/jobs/{self.id}/cancel")
        self._info = doc["job"]
        return bool(doc["cancelled"])


class RemoteDBConnection:
    """Reference remote/db.rs `RemoteDatabase` equivalent."""

    def __init__(self, url: str, api_key: str | None = None, config: ClientConfig | None = None):
        self._client = RestClient(url, api_key, config)
        self.uri = url

    def table_names(self, page_token: str | None = None, limit: int | None = None) -> list[str]:
        params = {}
        if page_token:
            params["page_token"] = page_token
        if limit:
            params["limit"] = str(limit)
        return self._client.get_json("/v1/table", params or None)["tables"]

    def create_table(self, name: str, data=None, schema=None, mode: str = "create", **kw) -> RemoteTable:
        from ..arrow import to_arrow_table

        tbl = to_arrow_table(data, schema=schema)
        self._client.post_arrow_in(f"/v1/table/{urllib.parse.quote(name)}/create/", tbl)
        return RemoteTable(self._client, name)

    def open_table(self, name: str, **kw) -> RemoteTable:
        t = RemoteTable(self._client, name)
        t.describe()  # 404s if missing
        return t

    def sql(self, query: str):
        """Run a SQL SELECT server-side (remote face of DBConnection.sql;
        EXPLAIN [ANALYZE] returns a (plan_type, plan) table)."""
        import pyarrow as pa

        stripped = query.lstrip()
        if stripped[:7].upper() == "EXPLAIN":
            doc = self._client.post_json("/v1/sql", {"query": query})
            plan_type = (
                "Plan with Metrics"
                if stripped[7:].lstrip()[:7].upper() == "ANALYZE"
                else "physical_plan"
            )
            return pa.table({"plan_type": [plan_type], "plan": [doc["plan"]]})
        return self._client.post_arrow_out("/v1/sql", {"query": query})

    def drop_table(self, name: str) -> None:
        self._client.post_json(f"/v1/table/{urllib.parse.quote(name)}/drop/")

    def rename_table(self, old: str, new: str) -> None:
        self._client.post_json(
            f"/v1/table/{urllib.parse.quote(old)}/rename/", {"new_name": new}
        )

    def drop_all_tables(self) -> None:
        for n in self.table_names():
            self.drop_table(n)

    # ---- jobs (reference connection.rs:526-556) -----------------------
    def list_jobs(self, include_finished: bool = True) -> list[dict]:
        params = None if include_finished else {"include_finished": "false"}
        return self._client.get_json("/v1/jobs", params)["jobs"]

    def get_job(self, job_id: str) -> "RemoteJob":
        return RemoteJob(self._client, self._client.get_json(f"/v1/jobs/{job_id}")["job"])

    job = get_job

    def cancel_job(self, job_id: str) -> bool:
        return self.get_job(job_id).cancel()

    def job_history(self) -> list[dict]:
        return self._client.get_json("/v1/jobs/history")["jobs"]


def _parse_type(type_str: str) -> pa.DataType:
    """Parse the subset of Arrow type strings the server emits."""
    s = type_str.strip()
    simple = {
        "int8": pa.int8(), "int16": pa.int16(), "int32": pa.int32(), "int64": pa.int64(),
        "uint8": pa.uint8(), "uint16": pa.uint16(), "uint32": pa.uint32(), "uint64": pa.uint64(),
        "float": pa.float32(), "double": pa.float64(), "halffloat": pa.float16(),
        "string": pa.string(), "large_string": pa.large_string(), "bool": pa.bool_(),
        "binary": pa.binary(), "large_binary": pa.large_binary(),
        "date32[day]": pa.date32(), "timestamp[us]": pa.timestamp("us"),
    }
    if s in simple:
        return simple[s]
    import re as _re

    m = _re.match(r"^fixed_size_list<item: (\w+)>\[(\d+)\]$", s)
    if m:
        return pa.list_(simple.get(m.group(1), pa.float32()), int(m.group(2)))
    m = _re.match(r"^list<item: (\w+)>$", s)
    if m:
        return pa.list_(simple.get(m.group(1), pa.float32()))
    raise InvalidInputError(f"cannot parse remote type {type_str!r}")


def connect_remote(url: str, api_key: str | None = None, config: ClientConfig | None = None) -> RemoteDBConnection:
    return RemoteDBConnection(url, api_key, config)
