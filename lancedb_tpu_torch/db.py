"""Database connections: URI routing, table CRUD and connection management.

Port of the local part of the reference's db.py: a database is a
directory of ``<name>.lance`` table datasets on an object store (local
paths and ``memory://``). The connection owns the device that every
table, index build and searcher under it uses: ``connect(uri)`` means
the card, and a caller that wants the CPU passes ``device="cpu"``. It
also owns the read-consistency interval (with a background refresher
when the interval is positive), the session's searcher cache and the
registry of background jobs. ``create_table`` takes a pyarrow schema or a
pydantic ``LanceModel``, binds embedding functions into the schema's
metadata and stores blob columns out of line. ``connect_async`` (in
``aio.py``) wraps a connection. ``sql`` runs a SELECT over the tables
(``sql.py``, on the host). The namespace methods go to a directory
catalogue over the same root (``namespace.py``) on the connection's
device. ``connect("db://...", host_override=url)`` returns the remote
client (``remote/``), which runs no device code: the server it talks to
owns the device.
"""

from __future__ import annotations

import json
from typing import Any

import pyarrow as pa

from .arrow import sanitize_vectors, to_arrow_table
from .errors import InvalidInputError, TableAlreadyExistsError, TableNotFoundError
from .io.object_store import ObjectStore, resolve_uri
from .jobs import JobRegistry
from .ops.util import resolve_device
from .session import BackgroundRefresher, Session
from .storage.dataset import Dataset
from .storage.manifest import VERSIONS_DIR
from .table import Table

TABLE_SUFFIX = ".lance"


class DBConnection:
    """The connection surface every database shares (reference db.py:79):
    table CRUD, and SQL over whatever ``open_table`` opens."""

    def table_names(self, page_token: str | None = None, limit: int | None = None) -> list[str]:
        raise NotImplementedError

    def create_table(self, name: str, data=None, schema=None, mode: str = "create", **kw) -> Table:
        raise NotImplementedError

    def open_table(self, name: str, **kw) -> Table:
        raise NotImplementedError

    def drop_table(self, name: str) -> None:
        raise NotImplementedError

    def rename_table(self, old: str, new: str) -> None:
        raise NotImplementedError

    def drop_all_tables(self) -> None:
        for n in self.table_names():
            self.drop_table(n)

    drop_database = drop_all_tables

    def sql(self, query: str) -> pa.Table:
        """Run a SQL SELECT over this database's tables (reference db.py:48):
        projection, aggregates, GROUP BY / HAVING / ORDER BY / LIMIT,
        sub-selects, joins and the ``fts(table, 'query' [, k])`` table
        function, on the host. A WHERE filters in the table's scan; under
        ``fts()`` it takes the scalar-index prefilter. ``EXPLAIN SELECT ...``
        returns the plan without running it and ``EXPLAIN ANALYZE SELECT
        ...`` runs it and annotates each operator with its rows and time,
        both as a (plan_type, plan) table."""
        from .sql import analyze_select, execute_select, explain_select

        stripped = query.lstrip()
        if stripped[:7].upper() == "EXPLAIN":
            rest = stripped[7:].lstrip()
            if rest[:7].upper() == "ANALYZE":
                plan, _ = analyze_select(rest[7:].lstrip(), self.open_table)
                return pa.table({"plan_type": ["Plan with Metrics"], "plan": [plan]})
            return pa.table({"plan_type": ["physical_plan"], "plan": [explain_select(rest)]})
        return execute_select(query, self.open_table)


class LanceDBConnection(DBConnection):
    def __init__(self, uri: str, *, device=None, read_consistency_interval: float | None = None,
                 storage_options: dict | None = None, session: Session | None = None,
                 storage_options_provider=None):
        self.uri = uri
        self.device = resolve_device(device)
        self.read_consistency_interval = read_consistency_interval
        self.storage_options = storage_options or {}
        # a callable returning fresh storage options (credential vending)
        self.storage_options_provider = storage_options_provider
        self.session = session or Session()
        self._refresher = (
            BackgroundRefresher(read_consistency_interval)
            if read_consistency_interval and read_consistency_interval > 0 else None
        )
        self._store, self._root = resolve_uri(uri, storage_options)
        self._jobs = JobRegistry()
        self._closed = False

    @classmethod
    def _over_store(cls, uri: str, store: ObjectStore, root: str, **kw) -> "LanceDBConnection":
        """A connection whose tables live under ``root`` of ``store``, an
        object store that a catalogue owns and shares (a namespace's tables)."""
        conn = cls(uri, **kw)
        conn._store, conn._root = store, root
        return conn

    def __repr__(self) -> str:
        return f"LanceDBConnection(uri={self.uri!r}, device={str(self.device)!r})"

    # ------------------------------------------------- container, lifecycle

    def __contains__(self, name: str) -> bool:
        return self.table_exists(name)

    def __getitem__(self, name: str) -> Table:
        return self.open_table(name)

    def __len__(self) -> int:
        return len(self.table_names())

    def __enter__(self) -> "LanceDBConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the background refresher; the connection is closed after."""
        if self._refresher is not None:
            self._refresher.stop()
        self._closed = True

    def is_open(self) -> bool:
        return not self._closed

    # ----------------------------------------------------------- tables

    def _table_root(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise InvalidInputError(f"invalid table name {name!r}")
        return f"{self._root}/{name}{TABLE_SUFFIX}"

    def table_exists(self, name: str) -> bool:
        return self._store.exists(f"{self._table_root(name)}/{VERSIONS_DIR}")

    def table_names(self, page_token: str | None = None, limit: int | None = None) -> list[str]:
        names = []
        for path in self._store.list(self._root):
            base = path.rsplit("/", 1)[-1]
            if base.endswith(TABLE_SUFFIX):
                names.append(base[: -len(TABLE_SUFFIX)])
        names.sort()
        if page_token is not None:
            names = [n for n in names if n > page_token]
        if limit is not None:
            names = names[:limit]
        return names

    def list_tables(self, **kw) -> list[str]:
        return self.table_names(**kw)

    def create_table(
        self,
        name: str,
        data: Any = None,
        schema: Any = None,
        mode: str = "create",
        exist_ok: bool = False,
        on_bad_vectors: str = "error",
        fill_value: float = 0.0,
        embedding_functions: list | None = None,
    ) -> Table:
        """Create a table from data and/or a schema (a pyarrow schema or a
        pydantic ``LanceModel``, whose SourceField / VectorField markers
        become embedding definitions). With embedding functions, each
        missing vector column is added, sized by its function, the
        definitions go into the schema's metadata, and the data goes
        through ``Table.add`` so that it is embedded as later appends are.
        Blob columns become descriptor columns and their payloads go to
        ``_blobs/`` (reference db.py:181-245)."""
        from .blob import blob_columns, encode_blobs, physical_schema

        if mode not in ("create", "overwrite"):
            raise InvalidInputError(f"unknown mode {mode!r}")
        if mode == "create" and exist_ok:
            mode = "exist_ok"
        if schema is not None and not isinstance(schema, pa.Schema):
            if not hasattr(schema, "to_arrow_schema"):
                raise InvalidInputError("schema must be a pyarrow.Schema or LanceModel")
            if not embedding_functions and hasattr(schema, "model_fields"):
                from .pydantic import parse_embedding_functions

                embedding_functions = parse_embedding_functions(schema) or None
            schema = schema.to_arrow_schema()
        if data is None and schema is None:
            raise InvalidInputError("either data or schema is required")
        embed_data = None
        if embedding_functions:
            from .embeddings.multimodal import MultiVectorEmbeddingFunction
            from .embeddings.registry import EmbeddingFunctionRegistry

            registry = EmbeddingFunctionRegistry.get_instance()
            if schema is None:
                schema = to_arrow_table(data).schema
            for d in embedding_functions:
                if d.vector_column not in schema.names:
                    fn = registry.get(d.function_name).create(**(d.config or {}))
                    inner = pa.list_(pa.float32(), fn.ndims())
                    # a multivector function's column holds bags of vectors
                    multi = isinstance(fn, MultiVectorEmbeddingFunction)
                    schema = schema.append(pa.field(d.vector_column,
                                                    pa.list_(inner) if multi else inner))
            schema = registry.attach_metadata(schema, embedding_functions)
            embed_data, data = data, None
        tbl = to_arrow_table(data, schema=schema) if data is not None else None
        if tbl is not None:
            tbl = sanitize_vectors(tbl, on_bad_vectors, fill_value)
        if schema is None:
            schema = tbl.schema
        root = self._table_root(name)
        if blob_columns(schema):
            if tbl is not None:
                tbl = encode_blobs(self._store, root, tbl, schema)
            schema = physical_schema(schema)
        try:
            ds = Dataset.create(self._store, root, schema, data=tbl, mode=mode)
        except TableAlreadyExistsError:
            raise TableAlreadyExistsError(name) from None
        table = Table(self, name, ds)
        if embed_data is not None:
            table.add(embed_data, on_bad_vectors=on_bad_vectors, fill_value=fill_value)
        return table

    def open_table(self, name: str, *, version: int | None = None, tag: str | None = None,
                   branch: str | None = None) -> Table:
        root = self._table_root(name)
        if not self._store.exists(f"{root}/{VERSIONS_DIR}"):
            raise TableNotFoundError(name)
        return Table(self, name, Dataset.open(self._store, root, version=version, tag=tag,
                                              branch=branch))

    def drop_table(self, name: str, ignore_missing: bool = False) -> None:
        root = self._table_root(name)
        if not self._store.exists(f"{root}/{VERSIONS_DIR}"):
            if ignore_missing:
                return
            raise TableNotFoundError(name)
        self.session.invalidate(root)
        self._store.delete(root)

    def rename_table(self, old: str, new: str) -> None:
        old_root, new_root = self._table_root(old), self._table_root(new)
        if not self._store.exists(f"{old_root}/{VERSIONS_DIR}"):
            raise TableNotFoundError(old)
        if self._store.exists(f"{new_root}/{VERSIONS_DIR}"):
            raise TableAlreadyExistsError(new)
        self.session.invalidate(old_root)
        self._store.rename_prefix(old_root, new_root)

    def clone_table(self, source: str, target: str, *, version: int | None = None,
                    tag: str | None = None) -> Table:
        """Copy a table, at a version or tag if given, into a new table
        (reference CloneTableBuilder, connection.rs:119-374)."""
        src = self.open_table(source)
        if tag is not None:
            src.checkout(tag)
        elif version is not None:
            src.checkout(version)
        data = src.to_arrow()
        return self.create_table(target, data if data.num_rows else None, schema=src.schema)

    # ------------------------------------------------------------- jobs

    def list_jobs(self, include_finished: bool = True) -> list[dict]:
        return self._jobs.list(include_finished)

    def get_job(self, job_id: str):
        return self._jobs.get(job_id)

    job = get_job

    def cancel_job(self, job_id: str) -> bool:
        return self._jobs.cancel(job_id)

    def job_history(self) -> list[dict]:
        return self._jobs.history()

    # ---------------------------------------------------- serialization

    def serialize(self) -> str:
        """This connection as JSON, for ``deserialize_conn`` in another
        process. It carries the device, so the copy runs where this one
        does."""
        return json.dumps({
            "connection_type": "local",
            "uri": self.uri,
            "device": str(self.device),
            "storage_options": self.storage_options,
            "read_consistency_interval_seconds": self.read_consistency_interval,
        })

    # ------------------------------------------------------- namespaces
    # a directory catalogue over this connection's root (namespace.py):
    # a namespace is a subdirectory with a .namespace.json marker

    @property
    def namespace_client(self):
        from .namespace import LanceNamespaceConnection

        if getattr(self, "_ns_client", None) is None:
            self._ns_client = LanceNamespaceConnection(self.uri, self.storage_options,
                                                       device=self.device)
        return self._ns_client

    def create_namespace(self, namespace_path: list[str], mode: str = "create",
                         properties: dict | None = None) -> None:
        return self.namespace_client.create_namespace(namespace_path, properties=properties,
                                                      mode=mode or "create")

    def drop_namespace(self, namespace_path: list[str], **kw) -> None:
        return self.namespace_client.drop_namespace(namespace_path, **kw)

    def list_namespaces(self, namespace_path: list[str] | None = None) -> list[str]:
        return self.namespace_client.list_namespaces(namespace_path)

    def namespace_exists(self, namespace_path: list[str]) -> bool:
        return self.namespace_client.namespace_exists(namespace_path)

    def describe_namespace(self, namespace_path: list[str]) -> dict:
        return self.namespace_client.describe_namespace(namespace_path)


def deserialize_conn(serialized: str) -> LanceDBConnection:
    """A connection from ``LanceDBConnection.serialize()``, on the device
    it names (a CUDA device raises where there is no card)."""
    doc = json.loads(serialized)
    if doc.get("connection_type") != "local":
        raise InvalidInputError(f"unknown connection_type {doc.get('connection_type')!r}")
    if "device" not in doc:
        raise InvalidInputError("a serialized connection must name its device")
    return LanceDBConnection(
        doc["uri"],
        device=doc["device"],
        storage_options=doc.get("storage_options") or None,
        read_consistency_interval=doc.get("read_consistency_interval_seconds"),
    )


def connect(
    uri: str,
    device=None,
    *,
    read_consistency_interval: float | None = None,
    storage_options: dict | None = None,
    session: Session | None = None,
    storage_options_provider=None,
    api_key: str | None = None,
    host_override: str | None = None,
    client_config=None,
):
    """Connect to a local or in-memory database (reference
    __init__.py:69 connect). ``device=None`` is the CUDA card; without
    one this raises rather than falling back to the CPU.
    ``read_consistency_interval``: None reads the version the table was
    opened at until this handle writes; 0 checks for a newer version
    before every read; a positive number of seconds refreshes in the
    background.

    ``db://name`` connects to a query server (``remote/``) at
    ``host_override``, with ``api_key`` (default ``$LANCEDB_API_KEY``) and
    a ``remote.ClientConfig``. The server owns the device, so a ``device``
    beside a ``db://`` URI is refused."""
    if uri.startswith("db://"):
        import os

        from .remote import connect_remote

        if device is not None:
            raise InvalidInputError(
                "a db:// connection runs on the server's device; pass no device"
            )
        if host_override is None:
            raise InvalidInputError("db:// URIs need host_override=<server url> in this build")
        api_key = api_key or os.environ.get("LANCEDB_API_KEY")
        return connect_remote(host_override, api_key=api_key, config=client_config)
    return LanceDBConnection(uri, device=device,
                             read_consistency_interval=read_consistency_interval,
                             storage_options=storage_options, session=session,
                             storage_options_provider=storage_options_provider)
