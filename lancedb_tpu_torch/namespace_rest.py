"""REST namespace catalog protocol: client + server.

Reference: the lance-namespace REST protocol consumed by
`LanceNamespaceDatabase` (rust database/namespace.rs:10-25 — catalog
ops delegated to a namespace service, delimiter-joined object ids,
default "$") together with the read-freshness signaling of
database/read_freshness.rs:1-80 (`x-lancedb-min-timestamp`).

Split of planes, as in the reference:

* CONTROL plane over HTTP JSON — create/describe/drop/list for
  namespaces and tables, rename, exists. ``DescribeTable`` returns the
  table's storage ``location``; the client then opens the dataset
  DIRECTLY against the object store (data plane never proxies through
  the catalog).
* READ FRESHNESS — the server may serve table metadata from a TTL
  cache. Reads carry ``x-lancedb-min-timestamp`` (epoch seconds, float)
  = max(per-table baseline, now - read_consistency_interval); the
  server refreshes any cache entry older than the floor. Baselines
  bump on every write through a namespace-opened table handle and on
  ``checkout_latest``.

DEVICE — a table the client opens runs on the client's ``device``
(None: the card, raising without one); the catalogue server's own
connection, which writes and describes tables but searches none, takes
a device by the same rule.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import pyarrow as pa

from .errors import HttpError, InvalidInputError, TableNotFoundError
from .namespace import LanceNamespaceConnection
from .remote.client import ClientConfig, RestClient
from .remote.protocol import ipc_to_table

DEFAULT_DELIMITER = "$"  # reference database/namespace.rs:61
MIN_TIMESTAMP_HEADER = "x-lancedb-min-timestamp"  # read_freshness.rs:25


def _join_id(ident: list[str], delimiter: str) -> str:
    return delimiter.join(ident)


def _split_id(obj_id: str, delimiter: str) -> list[str]:
    return obj_id.split(delimiter) if obj_id else []


def compute_min_timestamp(
    baseline: float | None, interval: float | None, now: float
) -> float | None:
    """max(baseline, now - interval) — reference read_freshness.rs:32-48."""
    interval_based = None if interval is None else max(now - interval, 0.0)
    if interval_based is None and baseline is None:
        return None
    if interval_based is None:
        return baseline
    if baseline is None:
        return interval_based
    return max(interval_based, baseline)


class FreshnessBaselines:
    """Per-table monotonic freshness floors (read_freshness.rs:50-78)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._baselines: dict[str, float] = {}

    def bump(self, key: str) -> None:
        now = time.time()
        with self._lock:
            prev = self._baselines.get(key)
            self._baselines[key] = now if prev is None else max(prev, now)

    def get(self, key: str) -> float | None:
        with self._lock:
            return self._baselines.get(key)


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------


class _NsHandler(BaseHTTPRequestHandler):
    server_version = "lancedb-tpu-torch-namespace/0.1"

    def log_message(self, *args):  # quiet
        pass

    def do_POST(self):
        try:
            self._route()
        except TableNotFoundError as exc:
            self._json(404, {"error": str(exc)})
        except InvalidInputError as exc:
            self._json(400, {"error": str(exc)})
        except Exception as exc:  # pragma: no cover - defensive
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    # -- plumbing ----------------------------------------------------------
    def _body(self) -> bytes:
        n = int(self.headers.get("content-length") or 0)
        return self.rfile.read(n) if n else b""

    def _json(self, code: int, obj: dict) -> None:
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _route(self) -> None:
        srv: "NamespaceServer" = self.server.ns_server  # type: ignore[attr-defined]
        if srv.api_key and self.headers.get("x-api-key") != srv.api_key:
            return self._json(401, {"error": "invalid or missing x-api-key"})
        path, _, query = self.path.partition("?")
        params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        delimiter = params.get("delimiter", DEFAULT_DELIMITER)
        parts = [p for p in path.split("/") if p]
        # /v1/namespace/{id}/{op}   or   /v1/table/{id}/{op}
        # root-namespace ops have no id: /v1/namespace/{op} with op known
        if len(parts) < 3 or parts[0] != "v1":
            return self._json(404, {"error": f"unknown route {path}"})
        kind = parts[1]
        if len(parts) == 3:
            obj_id, op = "", parts[2]
        else:
            obj_id, op = parts[2], parts[3]
        ident = _split_id(obj_id, delimiter)
        min_ts = self.headers.get(MIN_TIMESTAMP_HEADER)
        min_ts = float(min_ts) if min_ts else None
        body = self._body()
        is_json = self.headers.get("content-type", "").startswith("application/json")
        doc = json.loads(body) if body and is_json else {}
        if kind == "namespace":
            return self._json(200, srv.handle_namespace(op, ident, doc))
        if kind == "table":
            return self._json(200, srv.handle_table(op, ident, doc, body, min_ts))
        return self._json(404, {"error": f"unknown object kind {kind!r}"})


class NamespaceServer:
    """Serves the catalog protocol over a LanceNamespaceConnection.

    ``describe_cache_ttl`` makes DescribeTable serve from a cache for
    that many seconds — the staleness window the min-timestamp header
    exists to pierce (read_freshness.rs module docs)."""

    def __init__(
        self,
        uri: str,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        api_key: str | None = None,
        describe_cache_ttl: float = 0.0,
        storage_options: dict | None = None,
        device=None,
    ):
        self.ns = LanceNamespaceConnection(uri, storage_options, device=device)
        self.api_key = api_key
        self.describe_cache_ttl = describe_cache_ttl
        self._describe_cache: dict[str, tuple[float, dict]] = {}
        self._httpd = ThreadingHTTPServer((host, port), _NsHandler)
        self._httpd.ns_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> "NamespaceServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- control-plane dispatch ----------------------------------------------
    def handle_namespace(self, op: str, ident: list[str], doc: dict) -> dict:
        if op == "create":
            self.ns.create_namespace(ident, doc.get("properties"), mode=doc.get("mode", "create"))
            return {"namespace": ident}
        if op == "describe":
            return self.ns.describe_namespace(ident)
        if op == "drop":
            self.ns.drop_namespace(ident, force=bool(doc.get("force")))
            return {}
        if op == "exists":
            return {"exists": self.ns.namespace_exists(ident) or not ident}
        if op == "list":
            return {"namespaces": self.ns.list_namespaces(ident)}
        if op == "table_list":
            return {"tables": self.ns.list_tables(ident)}
        raise InvalidInputError(f"unknown namespace op {op!r}")

    def handle_table(
        self, op: str, ident: list[str], doc: dict, raw: bytes, min_ts: float | None
    ) -> dict:
        if op == "describe":
            return self._describe(ident, min_ts)
        if op == "exists":
            return {"exists": self.ns.table_exists(ident)}
        if op == "create":
            data = ipc_to_table(raw) if raw else None
            schema = data.schema if data is not None else None
            tbl = self.ns.create_table(ident, data, schema=schema)
            self._describe_cache.pop("$".join(ident), None)
            return {"location": self._location(ident), "version": tbl.version}
        if op == "drop":
            self.ns.drop_table(ident)
            self._describe_cache.pop("$".join(ident), None)
            return {}
        if op == "rename":
            new_ident = doc["new_id"]
            if ident[:-1] != new_ident[:-1]:
                raise InvalidInputError("rename cannot move tables across namespaces")
            self.ns._table_conn(ident[:-1]).rename_table(ident[-1], new_ident[-1])
            self._describe_cache.pop("$".join(ident), None)
            return {}
        raise InvalidInputError(f"unknown table op {op!r}")

    def _describe(self, ident: list[str], min_ts: float | None) -> dict:
        key = "$".join(ident)
        cached = self._describe_cache.get(key)
        now = time.time()
        if cached is not None:
            fetched_at, doc = cached
            fresh_enough = now - fetched_at <= self.describe_cache_ttl and (
                min_ts is None or fetched_at >= min_ts
            )
            if fresh_enough:
                return doc
        tbl = self.ns.open_table(ident)
        doc = {
            "location": self._location(ident),
            "version": tbl.version,
            "schema": tbl.schema.to_string(),
        }
        if self.describe_cache_ttl > 0:
            self._describe_cache[key] = (now, doc)
        return doc

    def _location(self, ident: list[str]) -> str:
        parts = [self.ns.uri, *ident[:-1], f"{ident[-1]}.lance"]
        return "/".join(parts)


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------


class RestNamespace:
    """Catalog client speaking the namespace REST protocol.

    Mirrors `LanceNamespaceConnection`'s surface; `open_table` resolves
    the storage location through DescribeTable then opens the dataset
    directly (data plane bypasses the catalog, as in the reference), on
    ``device``."""

    def __init__(
        self,
        base_url: str,
        *,
        api_key: str | None = None,
        delimiter: str = DEFAULT_DELIMITER,
        read_consistency_interval: float | None = None,
        storage_options: dict | None = None,
        config: ClientConfig | None = None,
        transport: Any | None = None,
        device=None,
    ):
        self._client = RestClient(base_url, api_key=api_key, config=config, transport=transport)
        self.device = device
        self.delimiter = delimiter
        self.read_consistency_interval = read_consistency_interval
        self.storage_options = storage_options
        self._freshness = FreshnessBaselines()

    # -- plumbing ------------------------------------------------------------
    def _params(self) -> dict:
        return {"delimiter": self.delimiter} if self.delimiter != DEFAULT_DELIMITER else {}

    def _post(self, kind: str, ident: list[str], op: str, body: dict | None = None,
              *, freshness_key: str | None = None) -> dict:
        obj_id = _join_id(ident, self.delimiter)
        path = f"/v1/{kind}/{obj_id}/{op}" if obj_id else f"/v1/{kind}/{op}"
        headers = {}
        if freshness_key is not None:
            floor = compute_min_timestamp(
                self._freshness.get(freshness_key), self.read_consistency_interval, time.time()
            )
            if floor is not None:
                headers = {MIN_TIMESTAMP_HEADER: repr(floor)}
        saved = dict(self._client.config.extra_headers)
        try:
            self._client.config.extra_headers.update(headers)
            return self._client.post_json(path, body or {}, params=self._params())
        finally:
            self._client.config.extra_headers = saved

    def _key(self, ident: list[str]) -> str:
        return _join_id(ident, self.delimiter)

    # -- namespaces -----------------------------------------------------------
    def create_namespace(self, ident: list[str], properties: dict | None = None,
                         mode: str = "create") -> None:
        self._post("namespace", ident, "create", {"properties": properties, "mode": mode})

    def describe_namespace(self, ident: list[str]) -> dict:
        return self._post("namespace", ident, "describe")

    def drop_namespace(self, ident: list[str], *, force: bool = False) -> None:
        self._post("namespace", ident, "drop", {"force": force})

    def namespace_exists(self, ident: list[str]) -> bool:
        return bool(self._post("namespace", ident, "exists")["exists"])

    def list_namespaces(self, parent: list[str] | None = None) -> list[str]:
        return self._post("namespace", parent or [], "list")["namespaces"]

    def list_tables(self, namespace: list[str] | None = None) -> list[str]:
        return self._post("namespace", namespace or [], "table_list")["tables"]

    # -- tables ----------------------------------------------------------------
    def table_exists(self, ident: list[str]) -> bool:
        return bool(self._post("table", ident, "exists")["exists"])

    def describe_table(self, ident: list[str]) -> dict:
        return self._post("table", ident, "describe", freshness_key=self._key(ident))

    def create_table(self, ident: list[str], data: Any = None, schema: pa.Schema | None = None):
        from .arrow import to_arrow_table

        obj_id = _join_id(ident, self.delimiter)
        if data is None and schema is None:
            raise InvalidInputError("either data or schema is required")
        tbl = to_arrow_table(data, schema=schema) if data is not None else pa.table(
            {f.name: pa.array([], type=f.type) for f in schema}
        )
        self._client.post_arrow_in(f"/v1/table/{obj_id}/create", tbl, params=self._params())
        self._freshness.bump(self._key(ident))
        return self.open_table(ident)

    def open_table(self, ident: list[str]):
        doc = self.describe_table(ident)
        table = self._open_location(doc["location"], ident)
        return table

    def drop_table(self, ident: list[str]) -> None:
        self._post("table", ident, "drop")
        self._freshness.bump(self._key(ident))

    def rename_table(self, ident: list[str], new_ident: list[str]) -> None:
        self._post("table", ident, "rename", {"new_id": new_ident})
        self._freshness.bump(self._key(ident))
        self._freshness.bump(self._key(new_ident))

    def checkout_latest(self, ident: list[str]) -> None:
        """Force subsequent describes past any server cache
        (read_freshness.rs: checkout_latest bumps the baseline)."""
        self._freshness.bump(self._key(ident))

    # -- data plane -------------------------------------------------------------
    def _open_location(self, location: str, ident: list[str]):
        from .db import LanceDBConnection

        base, _, name_lance = location.rpartition("/")
        if not name_lance.endswith(".lance"):
            raise HttpError(f"describe returned a non-table location {location!r}")
        conn = LanceDBConnection(base, device=self.device, storage_options=self.storage_options)
        table = conn.open_table(name_lance[: -len(".lance")])
        key = self._key(ident)
        table._on_write = lambda: self._freshness.bump(key)
        return table


def connect_namespace_client(base_url: str, **kwargs) -> RestNamespace:
    """Open a REST namespace catalog (reference connect_namespace_client,
    python namespace.py); ``device=`` is where its tables run."""
    return RestNamespace(base_url, **kwargs)
