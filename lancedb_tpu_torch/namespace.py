"""Hierarchical namespace catalog.

Reference: the lance-namespace protocol consumed by
database/namespace.rs (`LanceNamespaceDatabase`) and the python
namespace connection (python namespace.py). Namespaces are nested
containers of tables addressed by id paths (["prod", "search",
"items"]); the directory implementation maps them onto the object
store: a namespace is a directory carrying a ``.namespace.json``
marker, a table is a ``<name>.lance`` dataset inside it.

The catalogue owns a device, as a connection does: every table it
creates or opens builds and searches there (``None`` is the card, and
raises without one). Its tables share one searcher cache.
"""

from __future__ import annotations

import json
import time
from typing import Any

import pyarrow as pa

from .db import TABLE_SUFFIX, LanceDBConnection
from .errors import InvalidInputError
from .io.object_store import resolve_uri
from .ops.util import resolve_device
from .session import Session
from .storage.manifest import VERSIONS_DIR

NS_MARKER = ".namespace.json"


def _validate_id(ident: list[str]) -> list[str]:
    if not isinstance(ident, (list, tuple)):
        raise InvalidInputError("namespace/table ids are lists of path segments")
    for seg in ident:
        if not seg or "/" in seg or seg.startswith("."):
            raise InvalidInputError(f"invalid id segment {seg!r}")
    return list(ident)


class LanceNamespaceConnection:
    """Catalog operations + table access through namespace ids."""

    def __init__(self, uri: str, storage_options: dict | None = None, device=None):
        self.uri = uri
        self.device = resolve_device(device)
        self.storage_options = storage_options or {}
        self.session = Session()
        self._store, self._root = resolve_uri(uri, storage_options)
        # root is implicitly a namespace
        if not self._store.exists(f"{self._root}/{NS_MARKER}"):
            self._store.write_bytes(
                f"{self._root}/{NS_MARKER}",
                json.dumps({"created_at": time.time(), "properties": {}}).encode(),
            )

    # ------------------------------------------------------------ paths
    def _ns_path(self, ident: list[str]) -> str:
        return "/".join([self._root, *_validate_id(ident)])

    # ------------------------------------------------------- namespaces
    def create_namespace(
        self, ident: list[str], properties: dict | None = None, mode: str = "create"
    ) -> None:
        path = self._ns_path(ident)
        marker = f"{path}/{NS_MARKER}"
        if self._store.exists(marker):
            if mode in ("exist_ok", "overwrite"):
                return
            raise InvalidInputError(f"namespace {ident} already exists")
        # parents must exist
        for i in range(1, len(ident)):
            if not self._store.exists(f"{self._ns_path(ident[:i])}/{NS_MARKER}"):
                raise InvalidInputError(f"parent namespace {ident[:i]} does not exist")
        self._store.write_bytes(
            marker, json.dumps({"created_at": time.time(), "properties": properties or {}}).encode()
        )

    def namespace_exists(self, ident: list[str]) -> bool:
        return self._store.exists(f"{self._ns_path(ident)}/{NS_MARKER}")

    def describe_namespace(self, ident: list[str]) -> dict:
        marker = f"{self._ns_path(ident)}/{NS_MARKER}"
        if not self._store.exists(marker):
            raise InvalidInputError(f"namespace {ident} does not exist")
        return json.loads(self._store.read_bytes(marker))

    def list_namespaces(self, parent: list[str] | None = None) -> list[str]:
        base = self._ns_path(parent or [])
        out = []
        for p in self._store.list(base):
            name = p.rsplit("/", 1)[-1]
            if name.endswith(TABLE_SUFFIX) or name.startswith("."):
                continue
            if self._store.exists(f"{p}/{NS_MARKER}"):
                out.append(name)
        return sorted(out)

    def drop_namespace(self, ident: list[str], *, force: bool = False) -> None:
        if not ident:
            raise InvalidInputError("cannot drop the root namespace")
        path = self._ns_path(ident)
        if not self._store.exists(f"{path}/{NS_MARKER}"):
            raise InvalidInputError(f"namespace {ident} does not exist")
        if not force:
            if self.list_tables(ident) or self.list_namespaces(ident):
                raise InvalidInputError(f"namespace {ident} is not empty; pass force=True")
        self._store.delete(path)

    # ------------------------------------------------------------ tables
    def list_tables(self, namespace: list[str] | None = None) -> list[str]:
        base = self._ns_path(namespace or [])
        out = []
        for p in self._store.list(base):
            name = p.rsplit("/", 1)[-1]
            if name.endswith(TABLE_SUFFIX):
                out.append(name[: -len(TABLE_SUFFIX)])
        return sorted(out)

    def _table_conn(self, namespace: list[str]) -> LanceDBConnection:
        ns_path = self._ns_path(namespace)
        if namespace and not self._store.exists(f"{ns_path}/{NS_MARKER}"):
            raise InvalidInputError(f"namespace {namespace} does not exist")
        return LanceDBConnection._over_store(f"{self.uri}/" + "/".join(namespace), self._store,
                                             ns_path, device=self.device,
                                             storage_options=self.storage_options,
                                             session=self.session)

    def create_table(self, ident: list[str], data: Any = None, schema: pa.Schema | None = None, **kw):
        ident = _validate_id(ident)
        ns, name = ident[:-1], ident[-1]
        tbl = self._table_conn(ns).create_table(name, data, schema, **kw)
        tbl._namespace_path = list(ns)
        return tbl

    def open_table(self, ident: list[str], **kw):
        ident = _validate_id(ident)
        tbl = self._table_conn(ident[:-1]).open_table(ident[-1], **kw)
        tbl._namespace_path = list(ident[:-1])
        return tbl

    def drop_table(self, ident: list[str]) -> None:
        ident = _validate_id(ident)
        self._table_conn(ident[:-1]).drop_table(ident[-1])

    def table_exists(self, ident: list[str]) -> bool:
        ident = _validate_id(ident)
        path = f"{self._ns_path(ident[:-1])}/{ident[-1]}{TABLE_SUFFIX}/{VERSIONS_DIR}"
        return self._store.exists(path)


def connect_namespace(uri: str, storage_options: dict | None = None,
                      device=None) -> LanceNamespaceConnection:
    """Open a namespace-backed database root (reference
    ConnectNamespaceBuilder, connection.rs:1090) whose tables run on
    ``device`` (None: the card)."""
    return LanceNamespaceConnection(uri, storage_options, device=device)
