"""Database connections: URI routing and table CRUD.

Port of the local part of the reference's db.py: a database is a
directory of ``<name>.lance`` table datasets on an object store (local
paths and ``memory://``). The connection owns the device that every
table, index build and searcher under it uses: ``connect(uri)`` means
the card, and a caller that wants the CPU passes ``device="cpu"``.
Remote and namespace connections, drop/rename/clone and async
connections wait for later slices (ROADMAP A4, A12).
"""

from __future__ import annotations

from typing import Any

import pyarrow as pa

from ._surface import NotPortedSurface
from .arrow import sanitize_vectors, to_arrow_table
from .errors import InvalidInputError, TableAlreadyExistsError, TableNotFoundError
from .io.object_store import resolve_uri
from .ops.util import resolve_device
from .session import Session
from .storage.dataset import Dataset
from .storage.manifest import VERSIONS_DIR
from .table import Table

TABLE_SUFFIX = ".lance"


class LanceDBConnection(NotPortedSurface):
    _NOT_PORTED = {
        **dict.fromkeys(
            ("drop_table", "rename_table", "clone_table", "drop_all_tables", "drop_database",
             "table_exists", "list_tables", "serialize", "close", "list_jobs", "get_job",
             "cancel_job"),
            "A4",
        ),
        **dict.fromkeys(
            ("sql", "namespace_client", "create_namespace", "drop_namespace",
             "list_namespaces", "namespace_exists", "describe_namespace"),
            "A12",
        ),
    }

    def __init__(self, uri: str, *, device=None, storage_options: dict | None = None,
                 session: Session | None = None):
        self.uri = uri
        self.device = resolve_device(device)
        self.session = session or Session()
        self._store, self._root = resolve_uri(uri, storage_options)

    def __repr__(self) -> str:
        return f"LanceDBConnection(uri={self.uri!r}, device={str(self.device)!r})"

    def _table_root(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise InvalidInputError(f"invalid table name {name!r}")
        return f"{self._root}/{name}{TABLE_SUFFIX}"

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

    def create_table(
        self,
        name: str,
        data: Any = None,
        schema: pa.Schema | None = None,
        mode: str = "create",
        exist_ok: bool = False,
        on_bad_vectors: str = "error",
        fill_value: float = 0.0,
    ) -> Table:
        """Create a table from data and/or a pyarrow schema. Embedding
        functions, pydantic models and blob columns wait for later
        slices (ROADMAP A12)."""
        if mode not in ("create", "overwrite"):
            raise InvalidInputError(f"unknown mode {mode!r}")
        if mode == "create" and exist_ok:
            mode = "exist_ok"
        if schema is not None and not isinstance(schema, pa.Schema):
            raise NotImplementedError(
                "only pyarrow schemas are ported to lancedb_tpu_torch yet (ROADMAP A12)"
            )
        if data is None and schema is None:
            raise InvalidInputError("either data or schema is required")
        tbl = to_arrow_table(data, schema=schema) if data is not None else None
        if tbl is not None:
            tbl = sanitize_vectors(tbl, on_bad_vectors, fill_value)
        if schema is None:
            schema = tbl.schema
        try:
            ds = Dataset.create(self._store, self._table_root(name), schema, data=tbl, mode=mode)
        except TableAlreadyExistsError:
            raise TableAlreadyExistsError(name) from None
        return Table(self, name, ds)

    def open_table(self, name: str, *, version: int | None = None) -> Table:
        root = self._table_root(name)
        if not self._store.exists(f"{root}/{VERSIONS_DIR}"):
            raise TableNotFoundError(name)
        return Table(self, name, Dataset.open(self._store, root, version=version))


def connect(
    uri: str,
    device=None,
    *,
    storage_options: dict | None = None,
    session: Session | None = None,
) -> LanceDBConnection:
    """Connect to a local or in-memory database (reference
    __init__.py:69 connect). ``device=None`` is the CUDA card; without
    one this raises rather than falling back to the CPU."""
    if uri.startswith("db://"):
        raise NotImplementedError(
            "remote connections are not ported to lancedb_tpu_torch yet (ROADMAP A12)"
        )
    return LanceDBConnection(uri, device=device, storage_options=storage_options, session=session)
