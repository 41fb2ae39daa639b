"""Versioned manifest model — the MVCC backbone of a table.

Design follows the reference's semantics (every write commits a new
immutable manifest version; reference SURVEY.md §2.9 "Dataset MVCC",
rust table.rs:1873-2228) but not its encoding: manifests here are JSON
documents under ``_versions/``, committed with an atomic
``put_if_absent`` so concurrent writers conflict-and-retry instead of
corrupting state.

Table directory layout::

    <name>.lance/
      _versions/00000000000000000001.json   one manifest per version
      _refs/tags/<tag>.json                 {"version": N}
      _refs/branches/<branch>.json          {"version": N}   (head cache)
      _data/<uuid>.arrow                    immutable fragment data (Arrow IPC)
      _deletions/<uuid>.npz                 deletion bitmaps
      _indices/<uuid>/                      index artifacts
"""

from __future__ import annotations

import base64
import json
import time
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any

import pyarrow as pa

from ..errors import VersionNotFoundError

VERSIONS_DIR = "_versions"
REFS_DIR = "_refs"
DATA_DIR = "_data"
DELETIONS_DIR = "_deletions"
INDICES_DIR = "_indices"
BLOBS_DIR = "_blobs"

MAIN_BRANCH = "main"


def new_uuid() -> str:
    return _uuid.uuid4().hex


def schema_to_b64(schema: pa.Schema) -> str:
    return base64.b64encode(schema.serialize().to_pybytes()).decode()


def schema_from_b64(b64: str) -> pa.Schema:
    return pa.ipc.read_schema(pa.BufferReader(base64.b64decode(b64)))


@dataclass
class FragmentMeta:
    """One immutable data file plus its deletion state.

    Stable row addresses: ``row_id = (fragment_id << 32) | local_offset``
    (the reference's lance row-address scheme). Deleting rows writes a
    new deletion bitmap; the data file itself is never rewritten.
    """

    id: int
    data_file: str
    physical_rows: int
    deletion_file: str | None = None
    num_deleted: int = 0

    @property
    def num_rows(self) -> int:
        return self.physical_rows - self.num_deleted

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "data_file": self.data_file,
            "physical_rows": self.physical_rows,
            "deletion_file": self.deletion_file,
            "num_deleted": self.num_deleted,
        }

    @staticmethod
    def from_json(d: dict) -> "FragmentMeta":
        return FragmentMeta(
            id=d["id"],
            data_file=d["data_file"],
            physical_rows=d["physical_rows"],
            deletion_file=d.get("deletion_file"),
            num_deleted=d.get("num_deleted", 0),
        )


@dataclass
class IndexMeta:
    """Catalog entry for one index segment.

    ``fragment_ids`` records coverage: fragments added after the index was
    built are searched by brute force and folded in by ``optimize``
    (delta-index semantics; reference SURVEY.md §2.9 "per-fragment delta
    indices + optimize merge").
    """

    name: str
    uuid: str
    columns: list[str]
    index_type: str  # "IVF_PQ", "IVF_FLAT", "BTREE", "FTS", ...
    params: dict = field(default_factory=dict)
    fragment_ids: list[int] = field(default_factory=list)
    num_indexed_rows: int = 0
    created_at: float = 0.0

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "uuid": self.uuid,
            "columns": self.columns,
            "index_type": self.index_type,
            "params": self.params,
            "fragment_ids": self.fragment_ids,
            "num_indexed_rows": self.num_indexed_rows,
            "created_at": self.created_at,
        }

    @staticmethod
    def from_json(d: dict) -> "IndexMeta":
        return IndexMeta(
            name=d["name"],
            uuid=d["uuid"],
            columns=d["columns"],
            index_type=d["index_type"],
            params=d.get("params", {}),
            fragment_ids=d.get("fragment_ids", []),
            num_indexed_rows=d.get("num_indexed_rows", 0),
            created_at=d.get("created_at", 0.0),
        )


@dataclass
class Manifest:
    version: int
    schema: pa.Schema
    fragments: list[FragmentMeta] = field(default_factory=list)
    indices: list[IndexMeta] = field(default_factory=list)
    max_fragment_id: int = -1
    parent_version: int | None = None
    branch: str = MAIN_BRANCH
    config: dict = field(default_factory=dict)
    transaction: dict = field(default_factory=dict)
    timestamp: float = 0.0

    # ---- derived ----
    @property
    def num_rows(self) -> int:
        return sum(f.num_rows for f in self.fragments)

    def fragment_by_id(self, fid: int) -> FragmentMeta | None:
        for f in self.fragments:
            if f.id == fid:
                return f
        return None

    def index_by_name(self, name: str) -> IndexMeta | None:
        for ix in self.indices:
            if ix.name == name:
                return ix
        return None

    # ---- evolution helpers (all return a NEW manifest draft) ----
    def child(self, op: str, **tx: Any) -> "Manifest":
        return Manifest(
            version=self.version + 1,
            schema=self.schema,
            fragments=[FragmentMeta.from_json(f.to_json()) for f in self.fragments],
            indices=[IndexMeta.from_json(i.to_json()) for i in self.indices],
            max_fragment_id=self.max_fragment_id,
            parent_version=self.version,
            branch=self.branch,
            config=dict(self.config),
            transaction={"op": op, **tx},
            timestamp=time.time(),
        )

    # ---- serialization ----
    def to_json_bytes(self) -> bytes:
        doc = {
            "format": "lancedb-tpu/1",
            "version": self.version,
            "schema": schema_to_b64(self.schema),
            "fragments": [f.to_json() for f in self.fragments],
            "indices": [i.to_json() for i in self.indices],
            "max_fragment_id": self.max_fragment_id,
            "parent_version": self.parent_version,
            "branch": self.branch,
            "config": self.config,
            "transaction": self.transaction,
            "timestamp": self.timestamp or time.time(),
        }
        return json.dumps(doc, separators=(",", ":")).encode()

    @staticmethod
    def from_json_bytes(data: bytes) -> "Manifest":
        d = json.loads(data)
        return Manifest(
            version=d["version"],
            schema=schema_from_b64(d["schema"]),
            fragments=[FragmentMeta.from_json(f) for f in d["fragments"]],
            indices=[IndexMeta.from_json(i) for i in d.get("indices", [])],
            max_fragment_id=d.get("max_fragment_id", -1),
            parent_version=d.get("parent_version"),
            branch=d.get("branch", MAIN_BRANCH),
            config=d.get("config", {}),
            transaction=d.get("transaction", {}),
            timestamp=d.get("timestamp", 0.0),
        )


def manifest_path(root: str, version: int) -> str:
    return f"{root}/{VERSIONS_DIR}/{version:020d}.json"


def version_from_path(path: str) -> int:
    name = path.rsplit("/", 1)[-1]
    if not name.endswith(".json"):
        raise VersionNotFoundError(name)
    return int(name[: -len(".json")])


# ---- row address helpers (lance-style u64 addresses) ----

FRAG_SHIFT = 32
OFFSET_MASK = (1 << FRAG_SHIFT) - 1


def make_row_id(fragment_id: int, offset: int) -> int:
    return (fragment_id << FRAG_SHIFT) | offset


def split_row_id(row_id: int) -> tuple[int, int]:
    return row_id >> FRAG_SHIFT, row_id & OFFSET_MASK
