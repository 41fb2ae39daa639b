"""Table API: the user-facing handle over one versioned dataset.

Port of the reference's table.py: data CRUD (add, delete, update,
merge_insert), search and plain scans, index CRUD (vector indexes of
every ported type, scalar and full-text indexes), schema evolution, time
travel with tags and branches, and optimize. The device chosen at
``connect()`` travels from the connection to every index build and
searcher of the table, ``optimize()``'s rebuilds included; scalar and
full-text indexes live on the host. The host layers of ingest follow the
reference: ``add`` stores blob payloads out of line (blob.py) and computes
missing vector columns with the table's embedding functions (embeddings/),
whose definitions live in the schema's metadata; ``merge_insert(...)
.use_lsm()`` writes to the LSM WAL (lsm.py), which ``flush_lsm`` folds into
the table. ``enable_sharded_serving(mesh)`` serves the IVF_PQ index over a
device mesh (parallel/). The async facade is ``aio.AsyncTable``.
"""

from __future__ import annotations

import sys
import threading
import time
import types
from dataclasses import dataclass
from typing import Any, Literal

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads

from .arrow import is_vector_type, sanitize_vectors, to_arrow_table
from .arrow import vector_column_name as _vector_column_name
from .errors import IndexNotFoundError, InvalidInputError
from .metrics import span
from .index import (
    FTS,
    SCALAR_INDEX_TYPES,
    Auto,
    Bitmap,
    BTree,
    Flat,
    Fm,
    HnswFlat,
    HnswPq,
    HnswSq,
    IvfFlat,
    IvfPq,
    IvfRq,
    IvfSq,
    LabelList,
)
from .query import DEFAULT_TOP_K, LanceEmptyQueryBuilder, LanceQueryBuilder, LanceVectorQueryBuilder
from .storage.dataset import Dataset

VECTOR_INDEX_TYPES = ("IVF_FLAT", "IVF_PQ", "IVF_SQ", "IVF_RQ", "FLAT", "IVF_HNSW_PQ",
                      "IVF_HNSW_SQ", "IVF_HNSW_FLAT")


@dataclass
class FtsToken:
    """One token produced by Table.tokenize (reference FtsToken)."""

    text: str
    position: int


def _supported_btree_type(t: pa.DataType) -> bool:
    """Types Index::Auto maps to BTREE (reference utils/mod.rs:228-242)."""
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or pa.types.is_time(t)
        or pa.types.is_date(t)
        or pa.types.is_timestamp(t)
        or pa.types.is_fixed_size_binary(t)
    )


class Tags:
    """Tag CRUD (reference trait Tags, table.rs:345-377)."""

    def __init__(self, table: "Table"):
        self._table = table

    def create(self, name: str, version: int | None = None) -> None:
        self._table._dataset.create_tag(name, version)

    def list(self) -> dict[str, dict]:
        return self._table._dataset.list_tags()

    def update(self, name: str, version: int) -> None:
        self._table._dataset.update_tag(name, version)

    def delete(self, name: str) -> None:
        self._table._dataset.delete_tag(name)

    def get_version(self, name: str) -> int:
        return self._table._dataset.tag_version(name)


class MergeInsertBuilder:
    """Fluent upsert builder (reference MergeInsertBuilder, merge.rs:66-223).
    As in the reference, it does not apply the table's embedding functions:
    the source rows carry their vectors."""

    _use_lsm = False

    def __init__(self, table: "Table", on: str | list[str]):
        self._table = table
        self._on = [on] if isinstance(on, str) else list(on)
        self._update_all = False
        self._update_condition: str | None = None
        self._insert_all = False
        self._delete_missing = False
        self._delete_condition: str | None = None

    def when_matched_update_all(self, where: str | None = None) -> "MergeInsertBuilder":
        self._update_all = True
        self._update_condition = where
        return self

    def when_not_matched_insert_all(self) -> "MergeInsertBuilder":
        self._insert_all = True
        return self

    def when_not_matched_by_source_delete(self, condition: str | None = None
                                          ) -> "MergeInsertBuilder":
        self._delete_missing = True
        self._delete_condition = condition
        return self

    def use_lsm(self, flag: bool = True) -> "MergeInsertBuilder":
        """Write this upsert to the LSM WAL instead of joining it against
        the table (reference merge.rs use_lsm; needs set_lsm_write_spec)."""
        self._use_lsm = flag
        return self

    def execute(self, new_data: Any, timeout: float | None = None) -> dict:
        """One commit: matched rows rewritten into a new fragment (their old
        copies deleted), unmatched source rows appended. With ``use_lsm``
        the rows go to the WAL of their shards, which serves only the
        upsert shape, on the spec's keys."""
        source = to_arrow_table(new_data, schema=None)
        if self._use_lsm:
            if not (self._update_all and self._insert_all) or self._delete_missing:
                raise InvalidInputError(
                    "LSM merge_insert supports the upsert shape only "
                    "(when_matched_update_all + when_not_matched_insert_all)"
                )
            spec = self._table._lsm.get_spec()
            if spec is None:
                raise InvalidInputError("no LSM spec; call set_lsm_write_spec first")
            if spec.key_columns != self._on:
                raise InvalidInputError(
                    f"merge keys {self._on} must match the LSM spec keys {spec.key_columns}"
                )
            return self._table._lsm.append(source)
        stats = self._table._dataset.merge_insert(
            source,
            on=self._on,
            when_matched_update_all=self._update_all,
            matched_condition=self._update_condition,
            when_not_matched_insert_all=self._insert_all,
            when_not_matched_by_source_delete=self._delete_missing,
            delete_condition=self._delete_condition,
        )
        self._table._invalidate_caches()
        return stats


class _ProgressAdapter:
    """The ``progress=`` forms of ``add`` as one event callback (reference
    table.py _ProgressAdapter): a callable gets dicts with the reference's
    keys, a tqdm-like object gets total/update/set_postfix_str, and True
    builds a bar (tqdm when importable, else a line on stderr)."""

    def __init__(self, progress):
        self._t0 = time.time()
        self._rows = 0
        self._bytes = 0
        self._total = None
        self._cb = None
        self._bar = None
        self._own_bar = False
        if progress is True:
            try:
                from tqdm import tqdm  # type: ignore

                self._bar = tqdm(unit="rows")
                self._own_bar = True
            except ImportError:
                self._cb = lambda p: print(
                    f"add: {p['output_rows']} rows" + (" done" if p["done"] else ""),
                    file=sys.stderr,
                )
        elif callable(progress):
            self._cb = progress
        elif hasattr(progress, "update"):
            self._bar = progress
        else:
            raise InvalidInputError(
                "progress must be a callable, a tqdm-like object, or a bool"
            )

    def __call__(self, ev: dict) -> None:
        stage = ev.get("stage")
        rows = int(ev.get("rows", 0))
        nbytes = int(ev.get("bytes", 0))
        if stage == "start":
            self._total = rows
            if self._bar is not None and getattr(self._bar, "total", None) is None:
                try:
                    self._bar.total = rows
                except AttributeError:  # a bar whose total is read-only
                    pass
            return
        if stage in ("fragment", "committed"):
            self._rows += rows
            self._bytes += nbytes
        done = stage == "committed"
        elapsed = max(time.time() - self._t0, 1e-9)
        if self._cb is not None:
            self._cb({
                "output_rows": self._rows,
                "output_bytes": self._bytes,
                "total_rows": self._total if self._total is not None else self._rows,
                "elapsed_seconds": elapsed,
                "active_tasks": 0 if done else 1,
                "total_tasks": 1,
                "done": done,
            })
        if self._bar is not None:
            if rows:
                self._bar.update(rows)
            if hasattr(self._bar, "set_postfix_str"):
                mbs = self._bytes / elapsed / 1e6
                self._bar.set_postfix_str(f"{mbs:.1f} MB/s, 1 workers")
            if hasattr(self._bar, "refresh"):
                self._bar.refresh()
            if done and self._own_bar and hasattr(self._bar, "close"):
                self._bar.close()


class Table:
    """A handle on one table of a database."""

    def __init__(self, connection, name: str, dataset: Dataset):
        self._conn = connection
        self.name = name
        # set by a namespace catalogue that creates or opens the table
        self._namespace_path: list[str] = []
        self.__dataset = dataset
        self._searchers: dict[str, Any] = {}
        self._fts_indexes: dict[str, Any] = {}
        # a batched hybrid search asks for the FTS index from several
        # threads at once: one of them loads it
        self._fts_lock = threading.Lock()
        # serializes the read-consistency refresh and the cache
        # invalidation it triggers between concurrent readers
        self._refresh_lock = threading.Lock()
        self._last_consistency_check = time.monotonic()
        self._embedding_functions: dict[str, Any] = {}
        self._load_embedding_config()
        if connection._refresher is not None:
            connection._refresher.register(self)

    @property
    def _device(self):
        return self._conn.device

    @property
    def _dataset(self) -> Dataset:
        """The dataset, reloaded to the latest version first when the
        connection's read-consistency interval has passed (reference
        table.py:257-275): 0 checks on every read, None never."""
        interval = self._conn.read_consistency_interval
        if interval is not None and not self.__dataset.pinned:
            if interval == 0 or time.monotonic() - self._last_consistency_check >= interval:
                with self._refresh_lock:
                    # another reader may have refreshed while this one waited
                    if interval == 0 or (
                        time.monotonic() - self._last_consistency_check >= interval
                    ):
                        self._refresh()
        return self.__dataset

    def _refresh(self) -> None:
        """Load the latest manifest; drop the searchers if it moved. The
        caller holds ``_refresh_lock``."""
        old = self.__dataset.version
        self.__dataset.checkout_latest()
        self._last_consistency_check = time.monotonic()
        if self.__dataset.version != old:
            self._invalidate_caches()

    def _background_refresh(self) -> None:
        """Called by the connection's BackgroundRefresher (eventual
        consistency, reference table.py:290-301)."""
        if self.__dataset.pinned:
            return
        with self._refresh_lock:
            self._refresh()

    # a write listener: a table opened through a REST namespace bumps its
    # read-freshness baseline on every write (namespace_rest.py)
    _on_write = None

    def _invalidate_caches(self) -> None:
        self._searchers.clear()
        self._fts_indexes.clear()
        self._conn.session.invalidate(self.__dataset.root)
        if self._on_write is not None:
            self._on_write()

    @property
    def schema(self) -> pa.Schema:
        return self._dataset.schema

    @property
    def version(self) -> int:
        return self._dataset.version

    @property
    def embedding_functions(self) -> dict:
        """The table's embedding functions by vector column."""
        return self._embedding_functions

    @property
    def blob_columns(self) -> list[str]:
        """The columns stored as out-of-line blobs."""
        from .blob import blob_columns

        return blob_columns(self.schema)

    @property
    def namespace(self) -> list[str]:
        """The namespace path of the table (empty at a database's root)."""
        return self._namespace_path

    @property
    def id(self) -> str:
        """The full identifier, ``namespace$name``."""
        return "$".join(self._namespace_path + [self.name])

    @classmethod
    def open(cls, db, name: str, **kw) -> "Table":
        return db.open_table(name, **kw)

    @classmethod
    def create(cls, db, name: str, data=None, schema=None, **kw) -> "Table":
        return db.create_table(name, data, schema, **kw)

    def initial_storage_options(self) -> dict | None:
        """The storage options the connection was opened with."""
        return dict(self._conn.storage_options) or None

    def latest_storage_options(self) -> dict | None:
        """Fresh options from the connection's provider where it has one
        (credential vending), else the initial ones."""
        provider = self._conn.storage_options_provider
        if provider is not None:
            fresh = provider()
            if fresh:
                self._conn.storage_options = {**self._conn.storage_options, **fresh}
                return dict(self._conn.storage_options)
        return self.initial_storage_options()

    def prewarm_data(self) -> None:
        """Open every fragment's reader ahead of queries."""
        ds = self._dataset
        for frag in ds.manifest.fragments:
            ds.reader(frag.id)

    def migrate_v2_manifest_paths(self) -> None:
        """Nothing to do: the dataset has one manifest path scheme."""

    @property
    def uri(self) -> str:
        """Storage location of the table's dataset."""
        base = self._conn.uri.rstrip("/")
        return f"{base}/{self.name}.lance" if base else self.__dataset.root

    def __repr__(self) -> str:
        return f"Table(name={self.name!r}, version={self.version}, rows={self.count_rows()})"

    def __len__(self) -> int:
        return self.count_rows()

    def count_rows(self, filter: str | None = None) -> int:
        return self._dataset.count_rows(filter)

    # ----------------------------------------------------------- outputs

    def to_arrow(self) -> pa.Table:
        return self._dataset.to_table()

    def to_pandas(self, flatten=None):
        from .arrow import flatten_columns

        return flatten_columns(self.to_arrow(), flatten).to_pandas()

    def to_polars(self):
        import polars as pl

        return pl.from_arrow(self.to_arrow())

    def head(self, n: int = 5) -> pa.Table:
        return self._dataset.to_table(limit=n)

    def to_lance(self) -> Dataset:
        """The underlying dataset handle (the storage layer)."""
        return self._dataset

    def take_offsets(self, offsets: list[int]) -> pa.Table:
        return self._dataset.take_offsets(np.asarray(offsets, dtype=np.int64))

    def take_row_ids(self, row_ids: list[int]) -> pa.Table:
        return self._dataset.take_rows(np.asarray(row_ids, dtype=np.uint64))

    def stats(self) -> dict:
        return self._dataset.stats()

    # ------------------------------------------------------------- write

    def add(
        self,
        data: Any,
        mode: Literal["append", "overwrite"] = "append",
        *,
        on_bad_vectors: str = "error",
        fill_value: float = 0.0,
        on_progress=None,
        progress=None,
    ) -> None:
        """Append (or overwrite with) rows. Blob payloads go out of line
        and missing vector columns are computed by the table's embedding
        functions. A RecordBatchReader, a generator of batches, or a
        pyarrow dataset or scanner is appended fragment by fragment in
        bounded memory, in one commit; into a table with embedding
        functions or blob columns, batch by batch, one commit each.
        ``on_progress``: a callback(dict) per written batch; ``progress``:
        a callback of the reference's progress dicts, a tqdm-like object,
        or True for a bar."""
        from .blob import blob_columns, encode_blobs

        if progress is not None and progress is not False and on_progress is None:
            on_progress = _ProgressAdapter(progress)
        if mode == "append" and isinstance(data, (pads.Dataset, pads.Scanner)):
            from .scannable import to_scannable

            data = to_scannable(data).reader()
        if mode == "append" and isinstance(data, (pa.RecordBatchReader, types.GeneratorType)):
            if self._embedding_functions or blob_columns(self.schema):
                # each batch is embedded (and its blobs stored) on its own
                for b in data:
                    self.add(pa.Table.from_batches([b]) if isinstance(b, pa.RecordBatch) else b,
                             on_bad_vectors=on_bad_vectors, fill_value=fill_value,
                             on_progress=on_progress)
                return

            def clean(batches):
                for b in batches:
                    t = pa.Table.from_batches([b]) if isinstance(b, pa.RecordBatch) else b
                    yield sanitize_vectors(t, on_bad_vectors, fill_value)

            self._dataset.append_stream(clean(data), on_batch=on_progress)
            if on_progress is not None:
                on_progress({"stage": "committed", "rows": 0, "bytes": 0,
                             "version": self._dataset.version})
            self._invalidate_caches()
            return
        bcols = blob_columns(self.schema) if mode == "append" else []
        if bcols:
            # align against the schema with raw binary in the blob columns,
            # then replace the payloads by their descriptors
            ingest = pa.schema([pa.field(f.name, pa.large_binary(), nullable=f.nullable)
                                if f.name in bcols else f for f in self.schema])
            ds = self._dataset
            tbl = encode_blobs(ds.store, ds.root, to_arrow_table(data, schema=ingest), self.schema)
        else:
            tbl = to_arrow_table(data, schema=self.schema if mode == "append" else None)
        tbl = self._apply_embeddings(tbl)
        tbl = sanitize_vectors(tbl, on_bad_vectors, fill_value)
        if on_progress is not None:
            on_progress({"stage": "start", "rows": tbl.num_rows, "bytes": tbl.nbytes})
        if mode == "append":
            self._dataset.append(tbl)
        elif mode == "overwrite":
            self._dataset.overwrite(tbl)
        else:
            raise InvalidInputError(f"unknown add mode {mode!r}")
        if on_progress is not None:
            on_progress({"stage": "committed", "rows": tbl.num_rows, "bytes": tbl.nbytes,
                         "version": self._dataset.version})
        self._invalidate_caches()

    def delete(self, where: str) -> int:
        n = self._dataset.delete(where)
        self._invalidate_caches()
        return n

    def update(
        self,
        where: str | None = None,
        values: dict | None = None,
        *,
        values_sql: dict[str, str] | None = None,
    ) -> dict:
        """Update rows: ``values`` are Python literals, ``values_sql`` SQL
        expressions. Matched rows are rewritten into a new fragment."""
        updates: dict[str, str] = {}
        for col, val in (values or {}).items():
            if isinstance(val, str):
                updates[col] = "'" + val.replace("'", "''") + "'"
            elif val is None:
                updates[col] = "NULL"
            elif isinstance(val, bool):
                updates[col] = "TRUE" if val else "FALSE"
            else:
                updates[col] = repr(val)
        if values_sql:
            updates.update(values_sql)
        if not updates:
            raise InvalidInputError("update requires values or values_sql")
        stats = self._dataset.update(updates, where=where)
        self._invalidate_caches()
        return stats

    def merge_insert(self, on: str | list[str]) -> MergeInsertBuilder:
        return MergeInsertBuilder(self, on)

    # ---------------------------------------------------------- LSM / WAL

    @property
    def _lsm(self):
        """The table's LSM store, kept so that its shard writers live
        across upserts (reference merge/lsm.rs:322-334)."""
        from .lsm import LsmStore

        cached = self.__dict__.get("_lsm_store")
        ds = self._dataset
        if cached is None or cached._ds is not ds:
            cached = self.__dict__["_lsm_store"] = LsmStore(ds)
        return cached

    def set_lsm_write_spec(
        self,
        mode: str = "unsharded",
        key_columns: list[str] | str = (),
        num_shards: int = 1,
        *,
        maintained_indexes: list[str] | None = None,
        writer_config: dict | None = None,
    ) -> None:
        """Install the LSM sharding spec (reference table.rs:379-530):
        ``mode`` bucket, identity or unsharded; ``maintained_indexes=None``
        keeps every current index fresh on flush (merge/lsm.rs:134-176)."""
        from .lsm import LsmSpec

        keys = [key_columns] if isinstance(key_columns, str) else list(key_columns)
        self._lsm.set_spec(LsmSpec(mode, keys, num_shards, maintained_indexes=maintained_indexes,
                                   writer_config=writer_config))

    def close_lsm_writers(self) -> None:
        """Drop the cached shard writers (reference close_lsm_writers)."""
        self._lsm.close_writers()

    def describe_lsm_spec(self) -> dict | None:
        spec = self._lsm.get_spec()
        return spec.to_json() if spec else None

    get_lsm_write_spec = describe_lsm_spec

    def drop_lsm_spec(self, *, force: bool = False) -> None:
        """Remove the spec and the WAL; a WAL that holds rows needs ``force``."""
        self._lsm.drop_spec(force=force)

    def unset_lsm_write_spec(self, *, force: bool = False) -> None:
        self.drop_lsm_spec(force=force)

    def flush_lsm(self) -> dict:
        """Seal every shard, fold the sealed generations into the table in
        one merge_insert commit, then rebuild the spec's maintained indexes
        that the fold left stale (on the table's device)."""
        lsm = self._lsm
        out = lsm.flush()
        spec = lsm.get_spec()
        if out.get("rows_flushed") and spec and spec.maintained_indexes:
            out["indexes_refreshed"] = self._reindex_stale(only=set(spec.maintained_indexes))
        self._invalidate_caches()
        return out

    def checkpoint_lsm(self, timeout: float = 60.0) -> dict:
        """Seal once, then flush until the sealed generations are in the
        table (reference table/checkpoint.rs)."""
        out = self._lsm.checkpoint(timeout=timeout)
        self._invalidate_caches()
        return out

    def lsm_stats(self) -> dict:
        return self._lsm.stats()

    def get_lsm_stats(self, *, include_generation_rows: bool = False) -> dict | None:
        """The stats, or None when no spec is installed."""
        s = self._lsm.stats()
        return s if s.get("enabled") else None

    def compact_lsm(self):
        """One flush in the background; returns its Job (reference
        compact_lsm)."""
        return self._conn._jobs.submit("compact_lsm", self.flush_lsm)

    # ------------------------------------------------------------ search

    def search(
        self,
        query: Any = None,
        vector_column_name: str | None = None,
        query_type: str = "auto",
        fts_columns: list[str] | None = None,
    ) -> LanceQueryBuilder:
        """Vector, full-text or hybrid search, or a plain scan for
        ``query=None`` (reference table.py:640 → LanceQueryBuilder.create)."""
        return LanceQueryBuilder.create(
            self, query, query_type=query_type,
            vector_column_name=vector_column_name, fts_columns=fts_columns,
        )

    def vector_search(self, vector) -> LanceVectorQueryBuilder:
        return LanceVectorQueryBuilder(self, vector, None)

    def query(self) -> LanceEmptyQueryBuilder:
        """A plain scan: filter, projection, order, offset and limit."""
        return LanceEmptyQueryBuilder(self)

    def _embed_query(self, text: str, vector_column_name: str | None = None) -> np.ndarray:
        """A text query's vector from the embedding function of the column
        (reference table.py:718), computed on the host."""
        col = vector_column_name or _vector_column_name(self.schema)
        fn = self._embedding_functions.get(col)
        if fn is None:
            raise InvalidInputError(
                f"cannot embed text query: no embedding function registered for "
                f"column {col!r}; pass a vector instead"
            )
        return np.asarray(fn.compute_query_embeddings(text)[0], dtype=np.float32)

    # ------------------------------------------------------- embeddings

    def _load_embedding_config(self) -> None:
        """The embedding functions named in the schema's metadata; a
        function that cannot be created leaves the table without any, as
        in the reference."""
        from .embeddings.registry import METADATA_KEY, EmbeddingFunctionRegistry

        raw = (self.__dataset.schema.metadata or {}).get(METADATA_KEY)
        if not raw:
            return
        registry = EmbeddingFunctionRegistry.get_instance()
        try:
            self._embedding_functions = registry.parse_functions_from_schema_metadata(raw)
        except Exception:
            self._embedding_functions = {}

    def _apply_embeddings(self, tbl: pa.Table) -> pa.Table:
        """Compute each vector column that is missing or all null from its
        source column (reference WithEmbeddings, embeddings.rs:130). A
        multivector function's bags become list<fixed_size_list> rows."""
        for vec_col, fn in self._embedding_functions.items():
            present = vec_col in tbl.schema.names
            if present and tbl.column(vec_col).null_count != tbl.num_rows:
                continue
            if fn.source_column not in tbl.schema.names:
                continue
            embedded = fn.compute_source_embeddings(tbl.column(fn.source_column).to_pylist())
            if isinstance(embedded, list) and embedded and np.asarray(embedded[0]).ndim == 2:
                inner = pa.list_(pa.float32(), int(np.asarray(embedded[0]).shape[1]))
                arr = pa.array([np.asarray(bag, dtype=np.float32).tolist() for bag in embedded],
                               type=pa.list_(inner))
            else:
                vecs = np.asarray(embedded, dtype=np.float32)
                arr = pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel(), type=pa.float32()),
                                                        vecs.shape[1])
            if present:
                i = tbl.schema.get_field_index(vec_col)
                tbl = tbl.set_column(i, tbl.schema.field(i).name, arr)
            else:
                tbl = tbl.append_column(vec_col, arr)
        return tbl

    # ------------------------------------------------------------- blobs

    def fetch_blobs(self, column: str, row_ids: list[int]) -> list[bytes | None]:
        """The blob payloads of rows by row address (reference table.rs:744)."""
        from .blob import fetch_blobs

        return fetch_blobs(self._dataset, column, np.asarray(row_ids, dtype=np.uint64))

    def fetch_blob_files(self, column: str, row_ids: list[int]):
        """Lazy seekable BlobFile handles of rows' blobs."""
        from .blob import fetch_blob_files

        return fetch_blob_files(self._dataset, column, np.asarray(row_ids, dtype=np.uint64))

    def fetch_blob_ranges(self, column: str, row_ids: list[int], ranges: list[tuple[int, int]]):
        """One (start, length) range of each row's blob."""
        from .blob import fetch_blob_ranges

        return fetch_blob_ranges(self._dataset, column, np.asarray(row_ids, dtype=np.uint64),
                                 ranges)

    _serving_mesh = None

    def enable_sharded_serving(self, mesh=None) -> None:
        """Serve this table's IVF_PQ index across a device mesh
        (parallel/serving.py): each shard scans its own blocks and the
        shards' top-k merge; prefiltered and deletion-masked queries fan
        out too. ``mesh=None`` is a one-row mesh over every device of the
        table's device type: every card for a CUDA table, one ``cpu`` for
        a table on the CPU. Writes drop the sharded searchers with the
        others, so a rebuilt index is dealt anew."""
        from .parallel.mesh import make_mesh, one_process_only

        dev = self._device
        if mesh is None:
            mesh = make_mesh(devices=None if dev.type == "cuda" else [dev])
        one_process_only(mesh, "sharded serving runs")
        kinds = {d.type for d in mesh.devices.flat}
        if kinds != {dev.type}:
            raise InvalidInputError(
                f"the mesh's devices ({', '.join(sorted(kinds))}) are not of the "
                f"table's device type ({dev.type})"
            )
        self._serving_mesh = mesh
        self._searchers.clear()

    def disable_sharded_serving(self) -> None:
        self._serving_mesh = None
        self._searchers.clear()

    def _get_searcher(self, index_meta):
        from .index.vector import load_searcher

        key = index_meta.uuid
        ds = self._dataset

        def load_single():
            return self._conn.session.get_or_load(
                f"{ds.root}/{key}", lambda: load_searcher(ds, index_meta, self._device)
            )

        # read, then assign: a concurrent invalidation between the two must
        # not raise a KeyError
        mesh = self._serving_mesh
        if mesh is not None and index_meta.index_type == "IVF_PQ":
            skey = f"sharded:{key}"
            s = self._searchers.get(skey)
            if s is None:
                from .parallel.serving import make_sharded_searcher

                try:
                    s = make_sharded_searcher(mesh, ds, index_meta)
                except InvalidInputError:
                    # a metric the sharded scan does not serve: the
                    # single-device searcher's results (the reference's
                    # routing)
                    s = load_single()
                self._searchers[skey] = s
            return s
        s = self._searchers.get(key)
        if s is None:
            s = load_single()
            self._searchers[key] = s
        return s

    # ------------------------------------------------------------- index

    def create_index(
        self,
        metric: str = "l2",
        num_partitions: int | None = None,
        num_sub_vectors: int | None = None,
        vector_column_name: str | None = None,
        replace: bool = True,
        index_type: str = "IVF_PQ",
        num_bits: int = 8,
        sample_rate: int = 256,
        max_iterations: int = 50,
        *,
        config: IvfPq | IvfFlat | IvfSq | IvfRq | Flat | HnswFlat | HnswSq | HnswPq | Auto
        | None = None,
        name: str | None = None,
    ) -> None:
        """Build a FLAT, IVF_FLAT, IVF_SQ, IVF_PQ, IVF_RQ or IVF_HNSW_*
        vector index on the connection's device (reference table.py:2604
        create_index). AUTO picks IVF_PQ for a vector column and a BTREE
        scalar index for a scalar one (reference table.py:764-772). A
        multivector column gets its token-level FLAT index whatever the
        index type (reference table.py:779-783). The build is one
        ``index.build`` span, its commit ``table.commit``."""
        from .arrow import is_multivector_type
        from .index.hnsw import HNSW_INDEX_TYPES, build_hnsw_index
        from .index.multivector import build_multivector_index
        from .index.vector import PORTED_INDEX_TYPES, build_vector_index, unsupported_index_type

        with span("index.build"):
            column = vector_column_name or _vector_column_name(self.schema)
            if (config is not None and config.index_type == "AUTO") or (
                config is None and index_type.upper() == "AUTO"
            ):
                # Index::Auto (reference table/create_index.rs:186-213)
                if config is not None:
                    metric = config.distance_type
                config = None
                field_type = self.schema.field(column).type
                if is_vector_type(field_type) or is_multivector_type(field_type):
                    index_type = "IVF_PQ"
                elif _supported_btree_type(field_type):
                    self.create_scalar_index(column, index_type="BTREE", replace=replace)
                    return
                else:
                    raise InvalidInputError(
                        f"there are no indices supported for the field {column!r} "
                        f"with the data type {field_type}"
                    )
            if column in self.schema.names and is_multivector_type(self.schema.field(column).type):
                meta = build_multivector_index(self._dataset, column, config,
                                               name=name or f"{column}_idx")
                with span("table.commit"):
                    self._dataset.add_index(meta, replace=replace)
                    self._invalidate_caches()
                return
            if config is None:
                it = index_type.upper()
                if it == "IVF_PQ":
                    config = IvfPq(
                        distance_type=metric,
                        num_partitions=num_partitions,
                        num_sub_vectors=num_sub_vectors,
                        num_bits=num_bits,
                        sample_rate=sample_rate,
                        max_iterations=max_iterations,
                    )
                elif it == "IVF_FLAT":
                    config = IvfFlat(
                        distance_type=metric,
                        num_partitions=num_partitions,
                        sample_rate=sample_rate,
                        max_iterations=max_iterations,
                    )
                elif it in ("IVF_SQ", "IVF_RQ"):
                    config = (IvfSq if it == "IVF_SQ" else IvfRq)(
                        distance_type=metric,
                        num_partitions=num_partitions,
                        sample_rate=sample_rate,
                        max_iterations=max_iterations,
                    )
                elif it == "FLAT":
                    config = Flat(distance_type=metric)
                elif it in HNSW_INDEX_TYPES:
                    cls = {"IVF_HNSW_FLAT": HnswFlat, "IVF_HNSW_SQ": HnswSq,
                           "IVF_HNSW_PQ": HnswPq}[it]
                    kwargs = dict(distance_type=metric, num_partitions=num_partitions)
                    if it == "IVF_HNSW_PQ":
                        kwargs["num_sub_vectors"] = num_sub_vectors
                    config = cls(**kwargs)
                else:
                    raise unsupported_index_type(it)
            if config.index_type in HNSW_INDEX_TYPES:
                build = build_hnsw_index
            elif config.index_type in PORTED_INDEX_TYPES:
                build = build_vector_index
            else:
                raise unsupported_index_type(config.index_type)
            meta = build(self._dataset, column, config, name=name or f"{column}_idx",
                         device=self._device)
            with span("table.commit"):
                self._dataset.add_index(meta, replace=replace)
                self._invalidate_caches()

    def create_scalar_index(
        self,
        column: str,
        *,
        index_type: str = "BTREE",
        replace: bool = True,
        config: BTree | Bitmap | LabelList | Fm | None = None,
    ) -> None:
        """Build a BTREE, BITMAP, LABEL_LIST or FM index on a scalar column
        (reference table.py:848); prefilters use it when it covers the table."""
        from .index.scalar import build_scalar_index

        if config is None:
            cls = {"BTREE": BTree, "BITMAP": Bitmap, "LABEL_LIST": LabelList,
                   "FM": Fm}.get(index_type.upper())
            if cls is None:
                raise InvalidInputError(f"unknown scalar index type {index_type!r}")
            config = cls()
        meta = build_scalar_index(self._dataset, column, config)
        self._dataset.add_index(meta, replace=replace)

    @staticmethod
    def infer_tokenizer_configs(tokenizer_name: str) -> dict:
        """Expand a lance-style tokenizer shorthand ("default", "raw",
        "whitespace", "ngram", "<language>_stem") into the full FTS
        tokenizer kwargs (reference table.py:3205)."""
        base = {
            "base_tokenizer": "simple",
            "language": "English",
            "max_token_length": 40,
            "lower_case": True,
            "stem": False,
            "remove_stop_words": False,
            "ascii_folding": False,
            "ngram_min_length": 3,
            "ngram_max_length": 3,
            "prefix_only": False,
        }
        if tokenizer_name == "default":
            return base
        if tokenizer_name in ("raw", "whitespace"):
            return {**base, "base_tokenizer": tokenizer_name,
                    "max_token_length": None, "lower_case": False}
        if tokenizer_name == "ngram":
            return {**base, "base_tokenizer": "ngram"}
        if tokenizer_name.endswith("_stem"):
            code = tokenizer_name[: -len("_stem")].lower()
            iso = {
                "en": "English", "fr": "French", "de": "German",
                "es": "Spanish", "it": "Italian", "pt": "Portuguese",
            }
            return {
                **base, "stem": True,
                "language": iso.get(code, code.capitalize()),
            }
        raise InvalidInputError(f"unknown tokenizer name {tokenizer_name!r}")

    def create_fts_index(
        self,
        field_names: str | list[str],
        *,
        replace: bool = True,
        with_position: bool = True,
        tokenizer_name: str | None = None,
        base_tokenizer: str = "simple",
        language: str = "English",
        max_token_length: int | None = 40,
        lower_case: bool = True,
        stem: bool = True,
        remove_stop_words: bool = True,
        ascii_folding: bool = True,
        ngram_min_length: int = 3,
        ngram_max_length: int = 3,
        prefix_only: bool = False,
        dict_path: str | None = None,
    ) -> None:
        """Build the BM25 inverted index on the host (reference
        table.py:905); the native builder serves the simple tokenizer.

        ``dict_path``: user dictionary for the jieba/lindera
        dictionary-backed CJK tokenizers ('word [freq [tag]]' lines).
        """
        from .index.fts import build_fts_index

        fields = [field_names] if isinstance(field_names, str) else list(field_names)
        if tokenizer_name is not None:
            cfgs = self.infer_tokenizer_configs(tokenizer_name)
            base_tokenizer = cfgs["base_tokenizer"]
            language = cfgs["language"]
            max_token_length = cfgs["max_token_length"]
            lower_case = cfgs["lower_case"]
            stem = cfgs["stem"]
            remove_stop_words = cfgs["remove_stop_words"]
            ascii_folding = cfgs["ascii_folding"]
        config = FTS(
            with_position=with_position,
            base_tokenizer=base_tokenizer,  # type: ignore[arg-type]
            language=language,
            max_token_length=max_token_length,
            lower_case=lower_case,
            stem=stem,
            remove_stop_words=remove_stop_words,
            ascii_folding=ascii_folding,
            ngram_min_length=ngram_min_length,
            ngram_max_length=ngram_max_length,
            prefix_only=prefix_only,
            dict_path=dict_path,
        )
        meta = build_fts_index(self._dataset, fields, config)
        self._dataset.add_index(meta, replace=replace)
        self._invalidate_caches()

    # --------------------------------------------------------------- fts

    def _get_fts_index(self, meta):
        from .index.fts import load_fts_index

        with self._fts_lock:
            fts = self._fts_indexes.get(meta.uuid)
            if fts is None:
                fts = load_fts_index(self._dataset, meta)
                self._fts_indexes[meta.uuid] = fts
        return fts

    def tokenize(
        self, query: str, *, column: str | None = None, index_name: str | None = None
    ) -> list[FtsToken]:
        """Tokenize a query with the tokenizer configured on an FTS index
        (reference table.py:1027). Specify at most one of ``column`` /
        ``index_name``; with neither, the table's first FTS index is used."""
        if column is not None and index_name is not None:
            raise InvalidInputError("specify only one of column / index_name")
        chosen = None
        for ix in self._dataset.manifest.indices:
            if ix.index_type != "FTS":
                continue
            if index_name is not None and ix.name != index_name:
                continue
            if column is not None and column not in ix.columns:
                continue
            chosen = ix
            break
        if chosen is None:
            raise InvalidInputError("no matching FTS index to tokenize with")
        tok = self._get_fts_index(chosen).tokenizer
        return [FtsToken(text=t, position=i) for i, t in enumerate(tok.tokenize(query))]

    def _execute_fts(
        self,
        query,
        columns=None,
        k: int = DEFAULT_TOP_K,
        offset: int = 0,
        filter: str | None = None,
        prefilter: bool = True,
        select=None,
        with_row_id: bool = False,
    ) -> pa.Table:
        from .index.fts import execute_fts_query

        return execute_fts_query(
            self, query, columns=columns, k=k, offset=offset, filter=filter,
            prefilter=prefilter, select=select, with_row_id=with_row_id,
        )

    # ------------------------------------------------- index management

    def create_index_async(self, **kwargs):
        """Build an index in the background; returns a Job (reference
        index.rs:313). The build runs on the table's device."""
        return self._conn._jobs.submit("create_index", lambda: self.create_index(**kwargs))

    def list_indices(self) -> list[dict]:
        return [
            {"name": ix.name, "index_type": ix.index_type, "columns": list(ix.columns)}
            for ix in self._dataset.manifest.indices
        ]

    def index_stats(self, index_name: str) -> dict | None:
        ix = self._dataset.manifest.index_by_name(index_name)
        if ix is None:
            return None
        covered = set(ix.fragment_ids)
        unindexed = sum(
            f.num_rows for f in self._dataset.manifest.fragments if f.id not in covered
        )
        return {
            "num_indexed_rows": ix.num_indexed_rows,
            "num_unindexed_rows": unindexed,
            "index_type": ix.index_type,
            "distance_type": ix.params.get("metric"),
            "num_indices": 1,
            # the build's scalar parameters
            "params": {
                k: v for k, v in ix.params.items()
                if isinstance(v, (str, int, float, bool)) and k != "metric"
            },
        }

    def drop_index(self, name: str) -> None:
        self._dataset.drop_index(name)
        self._invalidate_caches()

    def prewarm_index(self, name: str) -> None:
        """Load an index ahead of queries: a vector index's searcher onto
        the table's device, an FTS index's postings into host memory."""
        ix = self._dataset.manifest.index_by_name(name)
        if ix is None:
            raise IndexNotFoundError(name)
        if ix.index_type in VECTOR_INDEX_TYPES:
            self._get_searcher(ix)
        elif ix.index_type == "FTS":
            self._get_fts_index(ix)

    def wait_for_index(self, index_names: list[str], timeout: float = 300.0) -> None:
        """Poll until the named indexes exist (reference index/waiter.rs:16)."""
        deadline = time.monotonic() + timeout
        names = set(index_names)
        while time.monotonic() < deadline:
            if names <= {ix.name for ix in self._dataset.manifest.indices}:
                return
            time.sleep(0.1)
        raise TimeoutError(f"indexes {names} not ready after {timeout}s")

    # -------------------------------------------------- schema evolution

    def add_columns(self, transforms: dict[str, str]) -> None:
        self._dataset.add_columns(transforms)
        self._invalidate_caches()

    def alter_columns(self, *alterations: dict) -> None:
        self._dataset.alter_columns(*alterations)
        self._invalidate_caches()

    def drop_columns(self, columns: list[str]) -> None:
        self._dataset.drop_columns(columns)
        self._invalidate_caches()

    def merge(self, other_table, left_on: str, right_on: str | None = None, schema=None) -> None:
        """Left-join another table's columns onto this one (reference
        table.py:3324); rows without a match get nulls."""
        if isinstance(other_table, Table):
            other = other_table.to_arrow()
        else:
            other = to_arrow_table(other_table, schema=schema)
        self._dataset.merge(other, left_on, right_on)
        self._invalidate_caches()

    def update_field_metadata(self, field_name: str, new_metadata: dict) -> None:
        """Replace one field's schema metadata."""
        self._dataset.update_field_metadata(field_name, new_metadata)
        self._invalidate_caches()

    replace_field_metadata = update_field_metadata

    # ------------------------------------------------------- time travel

    def list_versions(self) -> list[dict]:
        return [v.to_dict() for v in self._dataset.list_versions()]

    def checkout(self, version: int | str) -> None:
        """Pin the table to a version (or a tag's version): reads see it,
        writes are refused until checkout_latest(). Searches load that
        version's indexes onto the device; the searchers of the version
        left are dropped."""
        if isinstance(version, str):
            self._dataset.checkout_tag(version)
        else:
            self._dataset.checkout(version)
        self._invalidate_caches()

    def checkout_latest(self) -> None:
        self._dataset.checkout_latest()
        self._invalidate_caches()

    def restore(self, version: int | None = None) -> None:
        """Commit the checked-out (or the given) version as the latest."""
        if version is not None:
            self.checkout(version)
        self._dataset.restore()
        self._invalidate_caches()

    @property
    def tags(self) -> Tags:
        return Tags(self)

    # ---------------------------------------------------------- branches

    def create_branch(self, name: str, version: int | None = None) -> None:
        self._dataset.create_branch(name, version)

    def checkout_branch(self, name: str) -> None:
        self._dataset.checkout_branch(name)
        self._invalidate_caches()

    def list_branches(self) -> dict:
        return self._dataset.list_branches()

    @property
    def branches(self) -> dict:
        return self.list_branches()

    def delete_branch(self, name: str) -> None:
        self._dataset.delete_branch(name)

    def diff_branch(self, name: str) -> dict:
        return self._dataset.diff_branch(name)

    def merge_branch(self, name: str) -> dict:
        out = self._dataset.merge_branch(name)
        self._invalidate_caches()
        return out

    @property
    def current_branch(self) -> str:
        return self._dataset.branch

    # ------------------------------------------------------- primary key

    def declare_primary_key(self, columns: list[str] | str) -> None:
        """Record an unenforced primary key in the table's config
        (reference table.rs:673)."""
        cols = [columns] if isinstance(columns, str) else list(columns)
        for c in cols:
            if c not in self.schema.names:
                raise InvalidInputError(f"unknown column {c!r}")

        def build(current):
            draft = current.child("declare_primary_key", columns=cols)
            draft.config["primary_key"] = cols
            return draft

        self._dataset._commit_with_rebase(build)

    set_unenforced_primary_key = declare_primary_key

    @property
    def primary_key(self) -> list[str] | None:
        return self._dataset.manifest.config.get("primary_key")

    # ---------------------------------------------------------- optimize

    def optimize(
        self,
        cleanup_older_than: float | None = None,
        delete_unverified: bool = False,
        retrain: bool = False,
    ) -> dict:
        """Compact fragments, rebuild stale indexes (vector indexes on the
        table's device), optionally prune old versions (reference
        OptimizeAction::All, table/optimize.rs:30-75)."""
        compact = self._dataset.compact_files()
        rebuilt = self._reindex_stale()
        prune = {}
        if cleanup_older_than is not None:
            prune = self._dataset.prune_versions(
                keep_latest=1, older_than_seconds=cleanup_older_than
            )
        self._invalidate_caches()
        return {"compaction": compact, "prune": prune, "indices_rebuilt": rebuilt}

    def _reindex_stale(self, only: set | None = None) -> int:
        """Rebuild every index (of ``only``'s names, where given: the LSM
        spec's maintained indexes) whose fragments are not the live ones. A
        vector index is rebuilt from ``_config_from_params``, as the
        reference rebuilds it (ROADMAP §C: the settings it drops)."""
        from .index.fts import build_fts_index
        from .index.scalar import build_scalar_index
        from .index.vector import build_vector_index

        ds = self._dataset
        live = {f.id for f in ds.manifest.fragments}
        rebuilt = 0
        for ix in list(ds.manifest.indices):
            if (only is not None and ix.name not in only) or set(ix.fragment_ids) == live:
                continue
            rebuilt += 1
            if ix.index_type in VECTOR_INDEX_TYPES:
                meta = build_vector_index(ds, ix.columns[0],
                                          _config_from_params(ix.index_type, ix.params),
                                          name=ix.name, device=self._device)
            elif ix.index_type == "FTS":
                cfg = FTS(**{k: v for k, v in ix.params.items()
                             if k in FTS.__dataclass_fields__ and k != "index_type"})
                meta = build_fts_index(ds, ix.columns, cfg, name=ix.name)
            elif ix.index_type in SCALAR_INDEX_TYPES:
                cfg = {"BTREE": BTree, "BITMAP": Bitmap, "LABEL_LIST": LabelList,
                       "FM": Fm}[ix.index_type]()
                meta = build_scalar_index(ds, ix.columns[0], cfg, name=ix.name)
            else:
                continue
            ds.add_index(meta, replace=True)
        return rebuilt

    def compact_files(self) -> dict:
        out = self._dataset.compact_files()
        self._invalidate_caches()
        return out

    def cleanup_old_versions(self, older_than_seconds: float = 0.0,
                             delete_unverified: bool = False) -> dict:
        return self._dataset.prune_versions(keep_latest=1, older_than_seconds=older_than_seconds)


def _config_from_params(index_type: str, params: dict):
    """The config ``optimize()`` rebuilds a vector index with: the
    reference's (table.py:1358-1378), which passes on only the metric, the
    partitions and, for IVF_PQ, the subvectors and bits, and rebuilds every
    other type (the IVF_HNSW ones among them) as FLAT."""
    common = dict(distance_type=params.get("metric", "l2"),
                  num_partitions=params.get("num_partitions"))
    if index_type == "IVF_PQ":
        return IvfPq(**common, num_sub_vectors=params.get("num_sub_vectors"),
                     num_bits=params.get("num_bits", 8))
    if index_type == "IVF_FLAT":
        return IvfFlat(**common)
    if index_type == "IVF_SQ":
        return IvfSq(**common)
    if index_type == "IVF_RQ":
        return IvfRq(**common)
    return Flat(distance_type=params.get("metric", "l2"))
