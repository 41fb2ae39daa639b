"""Versioned columnar dataset: fragments + manifest MVCC.

This is the TPU-framework equivalent of the lance Dataset layer the
reference builds on (SURVEY.md §2.9): append-only fragment files,
immutable JSON manifests per version, optimistic-concurrency commits,
deletion vectors, time travel (checkout/restore), tags and branches.

Every mutating operation follows the same shape:
  1. read current manifest
  2. write new immutable artifacts (fragment files, deletion bitmaps)
  3. build a child manifest and commit it with ``put_if_absent``
  4. on conflict, rebase-and-retry if the op commutes (appends do),
     else surface CommitConflictError

Reference semantics mirrored: table.rs:1873-2228 (versions/checkout/
restore), table.rs:345-377 (tags), branch_merge.rs (branches),
table/optimize.rs (compact/prune).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterator

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import (
    BranchNotFoundError,
    CommitConflictError,
    InvalidInputError,
    SchemaError,
    TagNotFoundError,
    VersionNotFoundError,
)
from ..filters.eval import evaluate_expression, evaluate_predicate_mask, referenced_columns
from ..filters.sql import parse_sql_expr
from ..io.object_store import ObjectStore
from ..metrics import recorder, span
from .fragments import (
    DEFAULT_FRAGMENT_ROWS,
    FragmentReader,
    deletion_mask,
    read_deletion_offsets,
    write_deletion_bitmap,
    write_fragment,
)
from .manifest import (
    INDICES_DIR,
    MAIN_BRANCH,
    REFS_DIR,
    VERSIONS_DIR,
    FragmentMeta,
    IndexMeta,
    Manifest,
    manifest_path,
    version_from_path,
)

ROW_ID_COL = "_rowid"

_COMMIT_RETRIES = 10


def _pair_table(target_row: pa.Table, source_row: pa.Table) -> pa.Table:
    """One-row table exposing target.<col> / source.<col> flat columns for
    merge_insert condition evaluation."""
    arrays, names = [], []
    for name in target_row.schema.names:
        arrays.append(target_row.column(name).combine_chunks())
        names.append(f"target.{name}")
    for name in source_row.schema.names:
        arrays.append(source_row.column(name).combine_chunks())
        names.append(f"source.{name}")
    return pa.Table.from_arrays(arrays, names=names)


@dataclass
class VersionInfo:
    version: int
    timestamp: float
    branch: str
    parent_version: int | None
    transaction: dict

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "timestamp": self.timestamp,
            "branch": self.branch,
            "parent_version": self.parent_version,
            "metadata": self.transaction,
        }


_NOT_CACHED = object()


class Dataset:
    """One versioned table on an object store."""

    def __init__(self, store: ObjectStore, root: str, manifest: Manifest, pinned: bool = False):
        self.store = store
        self.root = root
        self.manifest = manifest
        # pinned == time-travel checkout: reads allowed, writes refused
        self.pinned = pinned
        self._readers: dict[int, FragmentReader] = {}
        self._deletion_cache: dict[tuple[int, str | None], np.ndarray | None] = {}
        # take_rows hydration fast path: (version, columns) → either
        # (sorted_rowids, rowid-sorted table) or "skip" (too large)
        self._hydration_cache: dict[tuple, object] = {}
        self._hydration_hits: dict[tuple, int] = {}
        # one thread at a time reads a projection for the resident copy
        self._hydration_build = threading.Lock()

    # ------------------------------------------------------------ basic

    @property
    def schema(self) -> pa.Schema:
        return self.manifest.schema

    @property
    def version(self) -> int:
        return self.manifest.version

    @property
    def branch(self) -> str:
        return self.manifest.branch

    def __repr__(self) -> str:
        return f"Dataset(root={self.root!r}, version={self.version}, rows={self.manifest.num_rows})"

    # ----------------------------------------------------------- create

    @staticmethod
    def create(
        store: ObjectStore,
        root: str,
        schema: pa.Schema,
        data: pa.Table | None = None,
        mode: str = "create",
        config: dict | None = None,
    ) -> "Dataset":
        exists = store.exists(f"{root}/{VERSIONS_DIR}")
        if exists:
            if mode == "create":
                from ..errors import TableAlreadyExistsError

                raise TableAlreadyExistsError(root.rsplit("/", 1)[-1])
            if mode == "exist_ok":
                ds = Dataset.open(store, root)
                if data is not None and data.num_rows:
                    ds.append(data)
                return ds
            if mode == "overwrite":
                ds = Dataset.open(store, root)
                ds.overwrite(data if data is not None else schema.empty_table(), schema=schema)
                return ds
            raise InvalidInputError(f"unknown create mode {mode!r}")
        manifest = Manifest(
            version=1,
            schema=schema,
            config=config or {},
            transaction={"op": "create"},
            timestamp=time.time(),
        )
        if data is not None and data.num_rows:
            frag = write_fragment(store, root, data, fragment_id=0)
            manifest.fragments.append(frag)
            manifest.max_fragment_id = 0
        ok = store.put_if_absent(manifest_path(root, 1), manifest.to_json_bytes())
        if not ok:
            raise CommitConflictError(1, "table created concurrently")
        ds = Dataset(store, root, manifest)
        ds._update_branch_head(MAIN_BRANCH, 1)
        return ds

    @staticmethod
    def create_from_fragments(
        store: ObjectStore,
        root: str,
        schema: pa.Schema,
        fragments,
        max_fragment_id: int | None = None,
        config: dict | None = None,
    ) -> "Dataset":
        """Reconstruct a dataset with EXACT fragment ids, physical row
        offsets, and deletion vectors.

        ``fragments``: iterable of ``(fragment_id, physical_table,
        deleted_offsets | None)`` where ``physical_table`` holds ALL
        physical rows (deleted ones included, in stored order). Used by
        the dataloader's pickle support: permutation tables address
        rows as ``fragment_id << 32 | offset``, so a rebuilt base table
        must reproduce the layout bit-for-bit — re-ingesting through
        ``create_table`` would collapse fragments and shift offsets
        (reference parity: Lance's fragment-level write API)."""
        if store.exists(f"{root}/{VERSIONS_DIR}"):
            from ..errors import TableAlreadyExistsError

            raise TableAlreadyExistsError(root.rsplit("/", 1)[-1])
        manifest = Manifest(
            version=1,
            schema=schema,
            config=config or {},
            transaction={"op": "restore_physical"},
            timestamp=time.time(),
        )
        max_fid = -1
        for fid, data, deleted in fragments:
            meta = write_fragment(store, root, data, fragment_id=int(fid))
            if deleted is not None and len(deleted):
                off = np.asarray(deleted, dtype=np.int64)
                meta = replace(
                    meta,
                    deletion_file=write_deletion_bitmap(store, root, off),
                    num_deleted=len(off),
                )
            manifest.fragments.append(meta)
            max_fid = max(max_fid, int(fid))
        manifest.max_fragment_id = (
            max_fid if max_fragment_id is None else int(max_fragment_id)
        )
        ok = store.put_if_absent(manifest_path(root, 1), manifest.to_json_bytes())
        if not ok:
            raise CommitConflictError(1, "table created concurrently")
        ds = Dataset(store, root, manifest)
        ds._update_branch_head(MAIN_BRANCH, 1)
        return ds

    @staticmethod
    def open(
        store: ObjectStore,
        root: str,
        version: int | None = None,
        tag: str | None = None,
        branch: str | None = None,
    ) -> "Dataset":
        if tag is not None:
            version = Dataset._read_ref(store, root, "tags", tag)
        pinned = version is not None
        if version is None:
            version = Dataset._latest_version(store, root, branch or MAIN_BRANCH)
        data = Dataset._read_manifest(store, root, version)
        return Dataset(store, root, data, pinned=pinned)

    @staticmethod
    def _read_manifest(store: ObjectStore, root: str, version: int) -> Manifest:
        try:
            raw = store.read_bytes(manifest_path(root, version))
        except FileNotFoundError:
            raise VersionNotFoundError(version) from None
        return Manifest.from_json_bytes(raw)

    @staticmethod
    def _latest_version(store: ObjectStore, root: str, branch: str = MAIN_BRANCH) -> int:
        """Newest version on `branch`.

        Fast path: the branch-head cache (written after every commit, so
        it may lag by a crashed committer but never leads). One LIST
        finds versions newer than the cached head; only those manifests
        (usually zero) are read, plus one read to validate the head —
        O(1) GETs per open instead of O(versions).
        """
        head = None
        try:
            raw = store.read_bytes(f"{root}/{REFS_DIR}/branches/{branch}.json")
            head = int(json.loads(raw)["version"])
        except (FileNotFoundError, KeyError, ValueError, TypeError):
            pass
        versions = sorted(
            version_from_path(p)
            for p in store.list(f"{root}/{VERSIONS_DIR}")
            if p.endswith(".json")
        )
        if not versions:
            raise VersionNotFoundError("(no versions)")
        if head is not None:
            # check manifests committed after the cached head (version
            # numbers are global across branches, so filter by branch)
            for v in reversed([v for v in versions if v > head]):
                m = Dataset._read_manifest(store, root, v)
                if m.branch == branch:
                    return v
            try:
                if Dataset._read_manifest(store, root, head).branch == branch:
                    return head
            except VersionNotFoundError:
                pass  # stale/corrupt head cache → full scan
        # slow path: newest-down scan over every manifest
        for v in reversed(versions):
            m = Dataset._read_manifest(store, root, v)
            if m.branch == branch:
                return v
        raise BranchNotFoundError(branch)

    # ----------------------------------------------------------- commit

    def _update_branch_head(self, branch: str, version: int) -> None:
        self.store.write_bytes(
            f"{self.root}/{REFS_DIR}/branches/{branch}.json",
            json.dumps({"version": version}).encode(),
        )

    def _check_writable(self) -> None:
        if self.pinned:
            raise InvalidInputError(
                "dataset is checked out at a fixed version; call checkout_latest() "
                "or restore() before writing"
            )

    def commit(self, draft: Manifest) -> None:
        """Commit a child manifest built against self.manifest."""
        ok = self.store.put_if_absent(manifest_path(self.root, draft.version), draft.to_json_bytes())
        if not ok:
            raise CommitConflictError(draft.version)
        self.manifest = draft
        self._update_branch_head(draft.branch, draft.version)
        self._deletion_cache.clear()

    def _commit_with_rebase(
        self, build: Callable[[Manifest], Manifest], retries: int = _COMMIT_RETRIES
    ) -> None:
        """Run `build(current_manifest) -> draft` and commit, rebasing on
        conflict (the reference's conflict-resolved commit loop).

        Version numbers are GLOBAL across branches (one monotonically
        increasing sequence); a collision with another branch's manifest
        just bumps the number, while a collision on our own branch means
        a concurrent writer won and the draft must be rebuilt on top.
        """
        self._check_writable()
        draft = build(self.manifest)
        for _ in range(retries * 4):
            try:
                self.commit(draft)
                return
            except CommitConflictError:
                try:
                    taken = Dataset._read_manifest(self.store, self.root, draft.version)
                except VersionNotFoundError:
                    taken = None
                if taken is not None and taken.branch != self.manifest.branch:
                    # another branch owns this number; keep lineage, bump
                    draft.version += 1
                    continue
                # a concurrent writer on our branch won → rebase
                latest = Dataset._latest_version(self.store, self.root, self.manifest.branch)
                self.manifest = Dataset._read_manifest(self.store, self.root, latest)
                draft = build(self.manifest)
        raise CommitConflictError(draft.version, "retries exhausted")

    # ------------------------------------------------------------ write

    def _align_to_schema(self, data: pa.Table) -> pa.Table:
        """Cast/reorder incoming data to the table schema (reference
        data/sanitize.rs + datafusion/cast.rs semantics)."""
        schema = self.manifest.schema
        cols = []
        for field in schema:
            if field.name in data.schema.names:
                col = data.column(field.name)
                if col.type != field.type:
                    try:
                        col = pc.cast(col, field.type)
                    except pa.ArrowInvalid as e:
                        raise SchemaError(
                            f"cannot cast column {field.name!r} from {col.type} to {field.type}: {e}"
                        ) from None
            elif field.nullable:
                col = pa.nulls(data.num_rows, field.type)
            else:
                raise SchemaError(f"missing non-nullable column {field.name!r}")
            cols.append(col)
        extra = [n for n in data.schema.names if n not in schema.names]
        if extra:
            raise SchemaError(f"unexpected columns {extra}; table schema is {schema.names}")
        return pa.Table.from_arrays([c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c for c in cols], schema=schema)

    def append(self, data: pa.Table, max_rows_per_fragment: int = DEFAULT_FRAGMENT_ROWS) -> None:
        self._check_writable()
        data = self._align_to_schema(data)
        if data.num_rows == 0:
            return
        # Write fragment files once; fragment ids are assigned at commit
        # time per attempt so appends rebase cleanly.
        chunks = [
            data.slice(i, max_rows_per_fragment) for i in range(0, data.num_rows, max_rows_per_fragment)
        ]

        written: list[FragmentMeta] = []

        def build(current: Manifest) -> Manifest:
            nonlocal written
            draft = current.child("append", rows=data.num_rows)
            if not written:
                fid = current.max_fragment_id
                if len(chunks) > 1:
                    # parallel fragment writes (reference writer
                    # parallelism, add_data.rs): files are uuid-named and
                    # ids renumber on rebase, so concurrent puts are safe
                    # and ordering is preserved by executor.map
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(max_workers=min(8, len(chunks))) as ex:
                        written.extend(
                            ex.map(
                                lambda ic: write_fragment(self.store, self.root, ic[1], ic[0]),
                                enumerate(chunks, fid + 1),
                            )
                        )
                else:
                    for chunk in chunks:
                        fid += 1
                        written.append(write_fragment(self.store, self.root, chunk, fid))
            else:
                # rebase: renumber fragment ids without rewriting files
                fid = current.max_fragment_id
                for frag in written:
                    fid += 1
                    frag.id = fid
            draft.fragments.extend(written)
            draft.max_fragment_id = max(draft.max_fragment_id, written[-1].id)
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    def append_stream(
        self,
        batches,
        max_rows_per_fragment: int = DEFAULT_FRAGMENT_ROWS,
        on_batch=None,
    ) -> int:
        """Stream an unbounded batch source into fragments in BOUNDED
        host memory, committing ONCE at the end (reference add_data.rs
        streaming inserts; our written-once fragments make commit
        retries rescan-free — ids renumber on rebase, files stay).

        ``batches`` is any iterable of RecordBatch/Table chunks (e.g. a
        ``pa.RecordBatchReader``). Returns the number of rows written.
        """
        self._check_writable()
        written: list[FragmentMeta] = []
        buffer: list[pa.Table] = []
        buffered = 0
        total = 0
        next_tmp_id = self.manifest.max_fragment_id

        def flush():
            nonlocal buffered, next_tmp_id
            if not buffered:
                return
            chunk = pa.concat_tables(buffer)
            buffer.clear()
            buffered = 0
            next_tmp_id += 1
            written.append(write_fragment(self.store, self.root, chunk, next_tmp_id))
            if on_batch is not None:
                on_batch({"stage": "fragment", "rows": chunk.num_rows})

        for batch in batches:
            tbl = pa.Table.from_batches([batch]) if isinstance(batch, pa.RecordBatch) else batch
            tbl = self._align_to_schema(tbl)
            total += tbl.num_rows
            # slice so one oversized batch still flushes at the bound
            pos = 0
            while pos < tbl.num_rows:
                take = min(tbl.num_rows - pos, max_rows_per_fragment - buffered)
                buffer.append(tbl.slice(pos, take))
                buffered += take
                pos += take
                if buffered >= max_rows_per_fragment:
                    flush()
        flush()
        if not written:
            return 0

        def build(current: Manifest) -> Manifest:
            draft = current.child("append", rows=total)
            fid = current.max_fragment_id
            for frag in written:
                fid += 1
                frag.id = fid
            draft.fragments.extend(written)
            draft.max_fragment_id = max(draft.max_fragment_id, written[-1].id)
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()
        return total

    def overwrite(self, data: pa.Table, schema: pa.Schema | None = None) -> None:
        self._check_writable()
        schema = schema or data.schema

        def build(current: Manifest) -> Manifest:
            draft = current.child("overwrite", rows=data.num_rows)
            draft.schema = schema
            draft.fragments = []
            draft.indices = []
            if data.num_rows:
                fid = current.max_fragment_id + 1
                frag = write_fragment(self.store, self.root, data, fid)
                draft.fragments = [frag]
                draft.max_fragment_id = fid
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    # ------------------------------------------------------------- read

    # The two caches below are read, then assigned, never read again: a
    # refresh on another thread (read consistency) may clear them between a
    # membership test and a lookup, which raised KeyError in the reference's
    # check-then-read form.
    def reader(self, fragment_id: int) -> FragmentReader:
        reader = self._readers.get(fragment_id)
        if reader is None:
            meta = self.manifest.fragment_by_id(fragment_id)
            if meta is None:
                raise InvalidInputError(f"no fragment {fragment_id}")
            reader = self._readers[fragment_id] = FragmentReader(self.store, self.root, meta)
        return reader

    def _keep_mask(self, meta: FragmentMeta) -> np.ndarray | None:
        key = (meta.id, meta.deletion_file)
        keep = self._deletion_cache.get(key, _NOT_CACHED)  # None: no deletions
        if keep is _NOT_CACHED:
            keep = self._deletion_cache[key] = deletion_mask(self.store, self.root, meta)
        return keep

    def count_rows(self, predicate: str | None = None) -> int:
        if predicate is None:
            return self.manifest.num_rows
        ast = parse_sql_expr(predicate)
        needed = sorted(referenced_columns(ast) & set(self.schema.names))
        total = 0
        for meta in self.manifest.fragments:
            tbl = self.reader(meta.id).read_all(columns=needed or None)
            mask = evaluate_predicate_mask(tbl, ast)
            keep = self._keep_mask(meta)
            if keep is not None:
                mask = mask & keep
            total += int(mask.sum())
        return total

    def scan_fragments(
        self,
        columns: list[str] | None = None,
        predicate: str | None = None,
        with_row_id: bool = False,
        fragments: list[int] | None = None,
    ) -> Iterator[tuple[FragmentMeta, pa.Table]]:
        """Yield (fragment, filtered table) pairs. Projection is pushed
        down; deletion vectors and the predicate are applied; a
        `fragments` id list skips non-selected fragments BEFORE any IO."""
        ast = parse_sql_expr(predicate) if predicate else None
        schema_names = set(self.schema.names)
        if columns is not None:
            unknown = [c for c in columns if c not in schema_names and c != ROW_ID_COL]
            if unknown:
                raise InvalidInputError(f"unknown columns {unknown}")
        read_cols: list[str] | None
        if columns is None:
            read_cols = list(self.schema.names)
        else:
            read_cols = [c for c in columns if c != ROW_ID_COL]
        if ast is not None:
            filter_cols = referenced_columns(ast) & schema_names
            read_all = sorted(set(read_cols or []) | filter_cols)
        else:
            read_all = read_cols
        frag_filter = set(fragments) if fragments is not None else None
        for meta in self.manifest.fragments:
            if frag_filter is not None and meta.id not in frag_filter:
                continue
            if read_all or read_all is None:
                tbl = self.reader(meta.id).read_all(columns=read_all)
                n = tbl.num_rows
            else:
                # zero data columns requested (row-id-only scans, e.g.
                # the permutation builder): a 0-column pyarrow Table
                # loses its row count through take/append_column, so
                # take the length from fragment metadata instead
                tbl = None
                n = meta.physical_rows
            mask = np.ones(n, dtype=bool)
            keep = self._keep_mask(meta)
            if keep is not None:
                mask &= keep
            if ast is not None:
                mask &= evaluate_predicate_mask(
                    tbl if tbl is not None
                    else pa.table({"__scan_rows": pa.nulls(n)}),
                    ast,
                )
            sel = np.nonzero(mask)[0]
            if len(sel) == 0:
                continue
            if tbl is None:
                # emit just the row-id column (or nothing to emit at all)
                if with_row_id:
                    rid = (np.uint64(meta.id) << np.uint64(32)) | sel.astype(np.uint64)
                    yield meta, pa.table({ROW_ID_COL: pa.array(rid, type=pa.uint64())})
                continue
            out = tbl.take(pa.array(sel)) if len(sel) < n else tbl
            if read_cols is not None and read_all != read_cols:
                out = out.select(read_cols)
            if with_row_id:
                rid = (np.uint64(meta.id) << np.uint64(32)) | sel.astype(np.uint64)
                out = out.append_column(ROW_ID_COL, pa.array(rid, type=pa.uint64()))
                if columns is not None:
                    # honor requested column order; _rowid rides along
                    want = list(columns)
                    if ROW_ID_COL not in want:
                        want.append(ROW_ID_COL)
                    out = out.select(want)
            yield meta, out

    def to_table(
        self,
        columns: list[str] | None = None,
        predicate: str | None = None,
        limit: int | None = None,
        offset: int = 0,
        with_row_id: bool = False,
        fragments: list[int] | None = None,
    ) -> pa.Table:
        parts: list[pa.Table] = []
        needed = (limit + offset) if limit is not None else None
        got = 0
        for _, tbl in self.scan_fragments(
            columns, predicate, with_row_id, fragments=fragments
        ):
            parts.append(tbl)
            got += tbl.num_rows
            if needed is not None and got >= needed:
                break
        if parts:
            out = pa.concat_tables(parts)
        else:
            out = self._empty_projection(columns, with_row_id)
        if offset:
            out = out.slice(offset)
        if limit is not None:
            out = out.slice(0, limit)
        return out

    def scan_batches(
        self,
        columns: list[str] | None = None,
        predicate: str | None = None,
        limit: int | None = None,
        offset: int = 0,
        with_row_id: bool = False,
        max_batch_length: int = 1024,
    ) -> Iterator[pa.RecordBatch]:
        """Stream the scan as bounded RecordBatches: one fragment is
        resident at a time, so a full-table scan runs in O(fragment +
        max_batch_length) memory (reference QueryExecutionOptions
        max_batch_length, query.rs:626-648)."""
        remaining = limit
        to_skip = offset
        for _, tbl in self.scan_fragments(columns, predicate, with_row_id):
            if to_skip:
                if tbl.num_rows <= to_skip:
                    to_skip -= tbl.num_rows
                    continue
                tbl = tbl.slice(to_skip)
                to_skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                if tbl.num_rows > remaining:
                    tbl = tbl.slice(0, remaining)
                remaining -= tbl.num_rows
            for batch in tbl.to_batches(max_chunksize=max_batch_length):
                if batch.num_rows:
                    yield batch

    def _empty_projection(self, columns: list[str] | None, with_row_id: bool) -> pa.Table:
        fields = []
        for f in self.schema:
            if columns is None or f.name in columns:
                fields.append(f)
        if with_row_id:
            fields.append(pa.field(ROW_ID_COL, pa.uint64()))
        return pa.schema(fields).empty_table()

    def _hydration_fastpath(self, columns: list[str] | None, lookups: int):
        """A rowid-sorted resident copy of the projection, built once 8
        lookups have hit the same (version, columns) key; a take counts
        the ``lookups`` (queries) it serves. Serving hydrates k≈10 rows
        per query; the per-fragment/per-batch take path costs several
        Arrow kernel calls per batch of rows while this is ONE pc.take.
        Bounded by LANCEDB_TPU_HYDRATION_CACHE_BYTES (4e9); larger
        projections are marked "skip" and use the slow path. One thread
        reads the projection; takes on other threads meanwhile (a hybrid
        call's full-text legs) use the slow path instead of reading it too."""
        key = (self.version, self.branch, tuple(columns) if columns else None)
        ent = self._hydration_cache.get(key)
        if ent == "skip":
            return None
        if ent is not None:
            return ent
        hits = self._hydration_hits.get(key, 0) + lookups
        self._hydration_hits[key] = hits
        if hits < 8 or not self._hydration_build.acquire(blocking=False):
            return None
        try:
            ent = self._hydration_cache.get(key)
            if ent is None:
                ent = self._resident_copy(columns)
                # one live version per dataset handle: drop stale entries
                self._hydration_cache = {
                    k: v for k, v in self._hydration_cache.items() if k[0] == self.version
                }
                self._hydration_cache[key] = ent
        finally:
            self._hydration_build.release()
        return None if ent == "skip" else ent

    def _resident_copy(self, columns: list[str] | None):
        """(sorted row ids, the projection in their order), or "skip"
        where the projection passes the cap."""
        tbl = self.to_table(columns=columns, with_row_id=True)
        cap = float(os.environ.get("LANCEDB_TPU_HYDRATION_CACHE_BYTES", 4e9))
        if tbl.nbytes > cap:
            return "skip"
        rid = tbl.column(ROW_ID_COL).to_numpy().astype(np.uint64)
        order = np.argsort(rid)
        return rid[order], tbl.drop_columns([ROW_ID_COL]).take(pa.array(order)).combine_chunks()

    def take_rows(self, row_ids: np.ndarray, columns: list[str] | None = None, *,
                  _lookups: int = 1) -> pa.Table:
        """Take by stable row address, preserving request order. One span
        (``dataset.take_rows``) a call, with its ``path``: the resident
        copy, or the fragments, whose reads it counts
        (``lancedb.hydrate.fragment_reads``). ``_lookups``: the queries
        a search's take serves, counted toward the resident copy."""
        with span("dataset.take_rows") as t:
            return self._take_rows(row_ids, columns, t, _lookups)

    def _take_rows(self, row_ids: np.ndarray, columns: list[str] | None, t,
                   lookups: int) -> pa.Table:
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        if len(row_ids) == 0:
            return self._empty_projection(columns, with_row_id=False)
        fast = self._hydration_fastpath(columns, lookups)
        if fast is not None:
            rid_sorted, tbl = fast
            pos = np.searchsorted(rid_sorted, row_ids)
            pos = np.clip(pos, 0, max(0, len(rid_sorted) - 1))
            if len(rid_sorted) and bool(np.all(rid_sorted[pos] == row_ids)):
                t.set(path="resident")
                return tbl.take(pa.array(pos.astype(np.int64)))
            # unknown row id (caller bug or raced delete): slow path
        frag_ids = (row_ids >> np.uint64(32)).astype(np.int64)
        offsets = (row_ids & np.uint64(0xFFFFFFFF)).astype(np.int64)
        pieces = []
        positions = []
        fids = np.unique(frag_ids)
        for fid in fids:
            sel = np.nonzero(frag_ids == fid)[0]
            reader = self.reader(int(fid))
            pieces.append(reader.take(offsets[sel], columns=columns))
            positions.append(sel)
        recorder().increment_counter("lancedb.hydrate.fragment_reads", float(len(fids)))
        t.set(path="fragments", fragments=len(fids))
        combined = pa.concat_tables(pieces)
        order = np.concatenate(positions)
        restore = np.empty(len(order), dtype=np.int64)
        restore[order] = np.arange(len(order))
        return combined.take(pa.array(restore))

    def take_offsets(self, offsets: np.ndarray, columns: list[str] | None = None) -> pa.Table:
        """Take by logical offset into the (deletion-aware) table order."""
        offsets = np.asarray(offsets, dtype=np.int64)
        row_ids = self.offsets_to_row_ids(offsets)
        return self.take_rows(row_ids, columns=columns)

    def offsets_to_row_ids(self, offsets: np.ndarray) -> np.ndarray:
        """Map logical offsets → stable row addresses."""
        bounds = [0]
        frags = self.manifest.fragments
        for meta in frags:
            bounds.append(bounds[-1] + meta.num_rows)
        bounds_arr = np.asarray(bounds, dtype=np.int64)
        total = bounds_arr[-1]
        offsets = np.asarray(offsets, dtype=np.int64)
        if len(offsets) and (offsets.min() < 0 or offsets.max() >= total):
            raise InvalidInputError(f"offset out of range [0, {total})")
        frag_pos = np.searchsorted(bounds_arr, offsets, side="right") - 1
        out = np.empty(len(offsets), dtype=np.uint64)
        for i_frag in np.unique(frag_pos):
            meta = frags[i_frag]
            sel = np.nonzero(frag_pos == i_frag)[0]
            local = offsets[sel] - bounds_arr[i_frag]
            keep = self._keep_mask(meta)
            if keep is None:
                phys = local
            else:
                phys = np.nonzero(keep)[0][local]
            out[sel] = (np.uint64(meta.id) << np.uint64(32)) | phys.astype(np.uint64)
        return out

    # ----------------------------------------------------------- delete

    def delete(self, predicate: str) -> int:
        """Delete rows matching the predicate. Returns deleted count."""
        self._check_writable()
        ast = parse_sql_expr(predicate)
        needed = sorted(referenced_columns(ast) & set(self.schema.names))

        def build(current: Manifest) -> Manifest:
            draft = current.child("delete", predicate=predicate)
            deleted_total = 0
            new_frags = []
            for meta in draft.fragments:
                reader = FragmentReader(self.store, self.root, meta)
                tbl = reader.read_all(columns=needed or None)
                mask = evaluate_predicate_mask(tbl, ast)  # True = delete
                keep = deletion_mask(self.store, self.root, meta)
                if keep is not None:
                    mask &= keep  # don't re-delete
                hit = np.nonzero(mask)[0]
                if len(hit) == 0:
                    new_frags.append(meta)
                    continue
                prior = (
                    read_deletion_offsets(self.store, self.root, meta.deletion_file)
                    if meta.deletion_file
                    else np.empty(0, dtype=np.uint32)
                )
                all_deleted = np.union1d(prior, hit.astype(np.uint32))
                deleted_total += len(hit)
                if len(all_deleted) == meta.physical_rows:
                    continue  # fragment fully deleted: drop it
                dfile = write_deletion_bitmap(self.store, self.root, all_deleted)
                new_frags.append(
                    FragmentMeta(
                        id=meta.id,
                        data_file=meta.data_file,
                        physical_rows=meta.physical_rows,
                        deletion_file=dfile,
                        num_deleted=len(all_deleted),
                    )
                )
            draft.fragments = new_frags
            draft.transaction["deleted_rows"] = deleted_total
            return draft

        self._commit_with_rebase(build)
        return int(self.manifest.transaction.get("deleted_rows", 0))

    # ----------------------------------------------------------- update

    def update(self, updates: dict[str, str], where: str | None = None) -> dict:
        """SQL-expression update: rewrite matched rows (delete + append).

        ``updates`` maps column name → SQL expression evaluated against
        the matched rows (reference table/update.rs semantics).
        """
        self._check_writable()
        for col in updates:
            if col not in self.schema.names:
                raise InvalidInputError(f"unknown column {col!r} in update")
        where_ast = parse_sql_expr(where) if where else None

        def build(current: Manifest) -> Manifest:
            draft = current.child("update", predicate=where, columns=sorted(updates))
            rewritten: list[pa.Table] = []
            new_frags: list[FragmentMeta] = []
            n_updated = 0
            for meta in draft.fragments:
                reader = FragmentReader(self.store, self.root, meta)
                tbl = reader.read_all()
                mask = (
                    evaluate_predicate_mask(tbl, where_ast)
                    if where_ast is not None
                    else np.ones(tbl.num_rows, dtype=bool)
                )
                keep = deletion_mask(self.store, self.root, meta)
                if keep is not None:
                    mask &= keep
                hit = np.nonzero(mask)[0]
                if len(hit) == 0:
                    new_frags.append(meta)
                    continue
                n_updated += len(hit)
                matched = tbl.take(pa.array(hit))
                arrays = []
                for field in current.schema:
                    if field.name in updates:
                        arr = evaluate_expression(matched, updates[field.name])
                        if arr.type != field.type:
                            arr = pc.cast(arr, field.type)
                    else:
                        arr = matched.column(field.name)
                        if isinstance(arr, pa.ChunkedArray):
                            arr = arr.combine_chunks()
                    arrays.append(arr)
                rewritten.append(pa.Table.from_arrays(arrays, schema=current.schema))
                # mark matched rows deleted in-place
                prior = (
                    read_deletion_offsets(self.store, self.root, meta.deletion_file)
                    if meta.deletion_file
                    else np.empty(0, dtype=np.uint32)
                )
                all_deleted = np.union1d(prior, hit.astype(np.uint32))
                if len(all_deleted) == meta.physical_rows:
                    continue
                dfile = write_deletion_bitmap(self.store, self.root, all_deleted)
                new_frags.append(
                    FragmentMeta(
                        id=meta.id,
                        data_file=meta.data_file,
                        physical_rows=meta.physical_rows,
                        deletion_file=dfile,
                        num_deleted=len(all_deleted),
                    )
                )
            draft.fragments = new_frags
            if rewritten:
                new_data = pa.concat_tables(rewritten)
                fid = draft.max_fragment_id + 1
                frag = write_fragment(self.store, self.root, new_data, fid)
                draft.fragments.append(frag)
                draft.max_fragment_id = fid
            draft.transaction["rows_updated"] = n_updated
            return draft

        self._commit_with_rebase(build)
        return {"rows_updated": int(self.manifest.transaction.get("rows_updated", 0)), "version": self.version}

    # ------------------------------------------------------ merge insert

    def merge_insert(
        self,
        source: pa.Table,
        on: list[str],
        when_matched_update_all: bool = False,
        matched_condition: str | None = None,
        when_not_matched_insert_all: bool = False,
        when_not_matched_by_source_delete: bool = False,
        delete_condition: str | None = None,
    ) -> dict:
        """Upsert in ONE commit (reference MergeInsertBuilder semantics,
        table/merge.rs:66-223): join source to target on key columns,
        update matched rows (optionally gated by a condition over
        ``target.<col>`` / ``source.<col>``), insert unmatched source
        rows, optionally delete target rows missing from the source.
        """
        self._check_writable()
        for c in on:
            if c not in self.schema.names:
                raise InvalidInputError(f"merge key {c!r} not in table schema")
            if c not in source.schema.names:
                raise InvalidInputError(f"merge key {c!r} not in source data")
        source = self._align_to_schema(source)
        matched_ast = parse_sql_expr(matched_condition) if matched_condition else None
        delete_ast = parse_sql_expr(delete_condition) if delete_condition else None

        n_src = source.num_rows
        src_key_cols = [source.column(c).combine_chunks() for c in on]

        def _match_indices(tgt: pa.Table) -> np.ndarray:
            """For each target row: matching source row index, or -1.

            Arrow-native equi-join keys: concat source+target values per
            key column, dictionary-encode once (Arrow's hash kernel —
            value equality, so float keys are exact and -0.0 == 0.0,
            unlike the repr-string keys this replaced), fold multi-column
            codes with np.unique, then match through a dense lookup
            array. No per-row Python. NULL keys never match (SQL).
            """
            n_tgt = tgt.num_rows
            per_col = np.empty((len(on), n_src + n_tgt), dtype=np.int64)
            null_any = np.zeros(n_src + n_tgt, dtype=bool)
            for ci, c in enumerate(on):
                t_arr = tgt.column(c)
                if isinstance(t_arr, pa.ChunkedArray):
                    t_arr = t_arr.combine_chunks()
                both = pa.concat_arrays([src_key_cols[ci], t_arr])
                if pa.types.is_floating(both.type):
                    # dictionary_encode hashes bit patterns; SQL equality
                    # needs -0.0 == 0.0, and x + 0.0 canonicalizes -0.0
                    both = pc.add(both, pa.scalar(0.0, both.type))
                enc = both.dictionary_encode()
                idx = pc.fill_null(enc.indices, -1)
                codes = np.asarray(idx, dtype=np.int64)
                null_any |= codes < 0
                per_col[ci] = codes
            if len(on) == 1:
                final = per_col[0]
            else:
                _, final = np.unique(per_col.T, axis=0, return_inverse=True)
                final = final.astype(np.int64)
            src_codes, tgt_codes = final[:n_src], final[n_src:]
            src_valid = ~null_any[:n_src]
            tgt_valid = ~null_any[n_src:]
            size = int(final.max()) + 1 if len(final) else 0
            lookup = np.full(size, -1, dtype=np.int64)
            lookup[src_codes[src_valid]] = np.nonzero(src_valid)[0]
            match = np.full(n_tgt, -1, dtype=np.int64)
            if size:
                match[tgt_valid] = lookup[tgt_codes[tgt_valid]]
            return match

        def build(current: Manifest) -> Manifest:
            draft = current.child("merge_insert", on=on)
            matched_src_rows = np.zeros(n_src, dtype=bool)
            appends: list[pa.Table] = []
            new_frags: list[FragmentMeta] = []
            n_updated = n_deleted = 0
            for meta in draft.fragments:
                reader = FragmentReader(self.store, self.root, meta)
                tbl = reader.read_all()
                keep = deletion_mask(self.store, self.root, meta)
                alive = keep if keep is not None else np.ones(tbl.num_rows, dtype=bool)
                match = _match_indices(tbl)
                matched = alive & (match >= 0)
                matched_src_rows[match[matched]] = True
                to_delete_mask = np.zeros(tbl.num_rows, dtype=bool)
                if when_matched_update_all and matched.any():
                    upd = matched.copy()
                    if matched_ast is not None:
                        offs = np.nonzero(matched)[0]
                        pair = _pair_table(
                            tbl.take(pa.array(offs)),
                            source.take(pa.array(match[offs])),
                        )
                        ok = evaluate_predicate_mask(pair, matched_ast)
                        upd[:] = False
                        upd[offs[ok]] = True
                    if upd.any():
                        offs = np.nonzero(upd)[0]
                        appends.append(source.take(pa.array(match[offs])))
                        to_delete_mask |= upd
                        n_updated += int(upd.sum())
                if when_not_matched_by_source_delete:
                    missing = alive & (match < 0)
                    if delete_ast is not None and missing.any():
                        offs = np.nonzero(missing)[0]
                        ok = evaluate_predicate_mask(tbl.take(pa.array(offs)), delete_ast)
                        missing[:] = False
                        missing[offs[ok]] = True
                    to_delete_mask |= missing
                    n_deleted += int(missing.sum())
                to_delete = np.nonzero(to_delete_mask)[0].tolist()
                if to_delete:
                    prior = (
                        read_deletion_offsets(self.store, self.root, meta.deletion_file)
                        if meta.deletion_file
                        else np.empty(0, dtype=np.uint32)
                    )
                    all_del = np.union1d(prior, np.asarray(to_delete, dtype=np.uint32))
                    if len(all_del) == meta.physical_rows:
                        continue
                    dfile = write_deletion_bitmap(self.store, self.root, all_del)
                    new_frags.append(
                        FragmentMeta(
                            id=meta.id,
                            data_file=meta.data_file,
                            physical_rows=meta.physical_rows,
                            deletion_file=dfile,
                            num_deleted=len(all_del),
                        )
                    )
                else:
                    new_frags.append(meta)
            n_inserted = 0
            if when_not_matched_insert_all:
                unmatched = np.nonzero(~matched_src_rows)[0]
                if len(unmatched):
                    appends.append(source.take(pa.array(unmatched)))
                    n_inserted = len(unmatched)
            draft.fragments = new_frags
            if appends:
                data = pa.concat_tables(appends)
                fid = draft.max_fragment_id + 1
                frag = write_fragment(self.store, self.root, data, fid)
                draft.fragments.append(frag)
                draft.max_fragment_id = fid
            draft.transaction.update(
                num_updated_rows=n_updated,
                num_inserted_rows=n_inserted,
                num_deleted_rows=n_deleted,
            )
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()
        tx = self.manifest.transaction
        return {
            "num_updated_rows": tx.get("num_updated_rows", 0),
            "num_inserted_rows": tx.get("num_inserted_rows", 0),
            "num_deleted_rows": tx.get("num_deleted_rows", 0),
            "version": self.version,
        }

    # ------------------------------------------------- schema evolution

    def add_columns(self, definitions: dict[str, str], data_types: dict[str, pa.DataType] | None = None) -> None:
        """Add columns backfilled by SQL expressions (reference
        table/schema_evolution.rs `add_columns`). Rewrites each fragment
        in place (same fragment id ⇒ row addresses survive)."""
        self._check_writable()
        data_types = data_types or {}

        def build(current: Manifest) -> Manifest:
            draft = current.child("add_columns", columns=sorted(definitions))
            for name in definitions:
                if name in current.schema.names:
                    raise InvalidInputError(f"column {name!r} already exists")
            new_frags = []
            new_fields = list(current.schema)
            decided_types: dict[str, pa.DataType] = {}
            for meta in draft.fragments:
                reader = FragmentReader(self.store, self.root, meta)
                tbl = reader.read_all()
                for name, expr in definitions.items():
                    arr = evaluate_expression(tbl, expr)
                    if name in data_types and arr.type != data_types[name]:
                        arr = pc.cast(arr, data_types[name])
                    decided_types.setdefault(name, arr.type)
                    if arr.type != decided_types[name]:
                        arr = pc.cast(arr, decided_types[name])
                    tbl = tbl.append_column(name, arr)
                frag = write_fragment(self.store, self.root, tbl, meta.id)
                frag.deletion_file = meta.deletion_file
                frag.num_deleted = meta.num_deleted
                new_frags.append(frag)
            for name in definitions:
                ty = decided_types.get(name, data_types.get(name, pa.float64()))
                new_fields.append(pa.field(name, ty))
            draft.fragments = new_frags
            draft.schema = pa.schema(new_fields)
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    def merge(self, other: pa.Table, left_on: str, right_on: str | None = None) -> None:
        """Left-join another table's columns onto this dataset
        (reference LanceTable.merge, table.py:3324): the dataset is the
        left side; rows without a match fill with null. Fragments are
        rewritten in place (same fragment id ⇒ row addresses survive),
        like add_columns."""
        self._check_writable()
        right_on = right_on or left_on
        if right_on not in other.column_names:
            raise InvalidInputError(f"right_on column {right_on!r} not in other table")
        n_distinct = pc.count_distinct(other.column(right_on)).as_py()
        if n_distinct != other.num_rows:
            # duplicate keys would multiply matched rows, shifting row
            # addresses and invalidating deletion bitmaps/indexes
            raise InvalidInputError(
                f"merge requires unique {right_on!r} values in the other "
                f"table ({other.num_rows - n_distinct} duplicates found)"
            )
        new_cols = [c for c in other.column_names if c != right_on]

        def build(current: Manifest) -> Manifest:
            if left_on not in current.schema.names:
                raise InvalidInputError(f"left_on column {left_on!r} not in table")
            overlap = set(new_cols) & set(current.schema.names)
            if overlap:
                raise InvalidInputError(
                    f"columns {sorted(overlap)} exist in both tables; only the "
                    f"join key may overlap"
                )
            draft = current.child("merge", left_on=left_on, right_on=right_on)
            new_frags = []
            for meta in draft.fragments:
                reader = FragmentReader(self.store, self.root, meta)
                tbl = reader.read_all()
                tbl = tbl.append_column("__merge_ord", pa.array(np.arange(tbl.num_rows)))
                joined = tbl.join(
                    other, keys=[left_on], right_keys=[right_on],
                    join_type="left outer",
                ).sort_by("__merge_ord").drop_columns(["__merge_ord"])
                frag = write_fragment(self.store, self.root, joined, meta.id)
                frag.deletion_file = meta.deletion_file
                frag.num_deleted = meta.num_deleted
                new_frags.append(frag)
            draft.fragments = new_frags
            fields = list(current.schema) + [other.schema.field(c) for c in new_cols]
            draft.schema = pa.schema(fields, metadata=current.schema.metadata)
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    def update_field_metadata(self, field_name: str, new_metadata: dict) -> None:
        """Replace one field's schema metadata (reference
        replace_field_metadata / update_field_metadata, table.py:4042) —
        a metadata-only commit, no data rewrite."""
        self._check_writable()

        def build(current: Manifest) -> Manifest:
            if field_name not in current.schema.names:
                raise InvalidInputError(f"unknown column {field_name!r}")
            draft = current.child("update_field_metadata", field=field_name)
            fields = []
            for f in current.schema:
                if f.name == field_name:
                    f = f.with_metadata({str(k): str(v) for k, v in new_metadata.items()})
                fields.append(f)
            draft.schema = pa.schema(fields, metadata=current.schema.metadata)
            return draft

        self._commit_with_rebase(build)

    def alter_columns(self, *alterations: dict) -> None:
        """Rename / retype / change nullability.

        Each alteration: {"path": name, "rename": new, "data_type": pa type,
        "nullable": bool} (reference table/schema_evolution.rs alter_columns).
        """
        self._check_writable()

        def build(current: Manifest) -> Manifest:
            draft = current.child("alter_columns", alterations=[a.get("path") for a in alterations])
            renames: dict[str, str] = {}
            retypes: dict[str, pa.DataType] = {}
            nullables: dict[str, bool] = {}
            for alt in alterations:
                path = alt["path"]
                if path not in current.schema.names:
                    raise InvalidInputError(f"unknown column {path!r}")
                if alt.get("rename"):
                    renames[path] = alt["rename"]
                if alt.get("data_type") is not None:
                    retypes[path] = alt["data_type"]
                if alt.get("nullable") is not None:
                    nullables[path] = alt["nullable"]
            needs_rewrite = bool(retypes)
            new_fields = []
            for f in current.schema:
                name = renames.get(f.name, f.name)
                ty = retypes.get(f.name, f.type)
                nullable = nullables.get(f.name, f.nullable)
                new_fields.append(pa.field(name, ty, nullable=nullable))
            new_schema = pa.schema(new_fields)
            if needs_rewrite or renames:
                new_frags = []
                for meta in draft.fragments:
                    reader = FragmentReader(self.store, self.root, meta)
                    tbl = reader.read_all()
                    arrays = []
                    for f_old, f_new in zip(current.schema, new_fields):
                        arr = tbl.column(f_old.name)
                        if isinstance(arr, pa.ChunkedArray):
                            arr = arr.combine_chunks()
                        if arr.type != f_new.type:
                            arr = pc.cast(arr, f_new.type)
                        arrays.append(arr)
                    new_tbl = pa.Table.from_arrays(arrays, schema=new_schema)
                    frag = write_fragment(self.store, self.root, new_tbl, meta.id)
                    frag.deletion_file = meta.deletion_file
                    frag.num_deleted = meta.num_deleted
                    new_frags.append(frag)
                draft.fragments = new_frags
            draft.schema = new_schema
            # indexes on altered columns are invalidated
            touched = set(renames) | set(retypes)
            draft.indices = [
                ix for ix in draft.indices if not (set(ix.columns) & touched)
            ]
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    def drop_columns(self, columns: list[str]) -> None:
        """Metadata-only drop: manifest schema shrinks; fragment files
        keep the bytes until the next compaction."""
        self._check_writable()

        def build(current: Manifest) -> Manifest:
            draft = current.child("drop_columns", columns=list(columns))
            for c in columns:
                if c not in current.schema.names:
                    raise InvalidInputError(f"unknown column {c!r}")
            draft.schema = pa.schema([f for f in current.schema if f.name not in columns])
            dropped = set(columns)
            draft.indices = [ix for ix in draft.indices if not (set(ix.columns) & dropped)]
            return draft

        self._commit_with_rebase(build)

    # ------------------------------------------------------ index hooks

    def add_index(self, meta: IndexMeta, replace: bool = True) -> None:
        def build(current: Manifest) -> Manifest:
            draft = current.child("create_index", name=meta.name)
            existing = draft.index_by_name(meta.name)
            if existing is not None:
                if not replace:
                    raise InvalidInputError(f"index {meta.name!r} already exists")
                draft.indices = [ix for ix in draft.indices if ix.name != meta.name]
            draft.indices.append(meta)
            return draft

        self._commit_with_rebase(build)

    def drop_index(self, name: str) -> None:
        def build(current: Manifest) -> Manifest:
            from ..errors import IndexNotFoundError

            if current.index_by_name(name) is None:
                raise IndexNotFoundError(name)
            draft = current.child("drop_index", name=name)
            draft.indices = [ix for ix in draft.indices if ix.name != name]
            return draft

        self._commit_with_rebase(build)

    def index_dir(self, uuid: str) -> str:
        return f"{self.root}/{INDICES_DIR}/{uuid}"

    # ------------------------------------------------------ time travel

    def list_versions(self) -> list[VersionInfo]:
        out = []
        for p in self.store.list(f"{self.root}/{VERSIONS_DIR}"):
            if not p.endswith(".json"):
                continue
            m = Manifest.from_json_bytes(self.store.read_bytes(p))
            out.append(
                VersionInfo(
                    version=m.version,
                    timestamp=m.timestamp,
                    branch=m.branch,
                    parent_version=m.parent_version,
                    transaction=m.transaction,
                )
            )
        return sorted(out, key=lambda v: v.version)

    def checkout(self, version: int) -> None:
        self.manifest = Dataset._read_manifest(self.store, self.root, version)
        self.pinned = True
        self._readers.clear()
        self._deletion_cache.clear()

    def checkout_tag(self, tag: str) -> None:
        self.checkout(Dataset._read_ref(self.store, self.root, "tags", tag))

    def checkout_latest(self) -> None:
        branch = self.manifest.branch
        latest = Dataset._latest_version(self.store, self.root, branch)
        self.manifest = Dataset._read_manifest(self.store, self.root, latest)
        self.pinned = False
        self._readers.clear()
        self._deletion_cache.clear()

    def restore(self) -> None:
        """Commit the currently-checked-out version as the new latest."""
        if not self.pinned:
            return
        pinned_manifest = self.manifest
        latest = Dataset._latest_version(self.store, self.root, pinned_manifest.branch)
        self.manifest = Dataset._read_manifest(self.store, self.root, latest)
        self.pinned = False

        def build(current: Manifest) -> Manifest:
            draft = current.child("restore", source_version=pinned_manifest.version)
            draft.schema = pinned_manifest.schema
            draft.fragments = pinned_manifest.fragments
            draft.indices = pinned_manifest.indices
            draft.max_fragment_id = max(current.max_fragment_id, pinned_manifest.max_fragment_id)
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()

    # -------------------------------------------------------------- tags

    @staticmethod
    def _read_ref(store: ObjectStore, root: str, kind: str, name: str) -> int:
        try:
            raw = store.read_bytes(f"{root}/{REFS_DIR}/{kind}/{name}.json")
        except FileNotFoundError:
            if kind == "tags":
                raise TagNotFoundError(name) from None
            raise BranchNotFoundError(name) from None
        return json.loads(raw)["version"]

    def create_tag(self, name: str, version: int | None = None) -> None:
        version = version if version is not None else self.version
        if not self.store.exists(manifest_path(self.root, version)):
            raise VersionNotFoundError(version)
        ok = self.store.put_if_absent(
            f"{self.root}/{REFS_DIR}/tags/{name}.json", json.dumps({"version": version}).encode()
        )
        if not ok:
            raise InvalidInputError(f"tag {name!r} already exists")

    def update_tag(self, name: str, version: int) -> None:
        path = f"{self.root}/{REFS_DIR}/tags/{name}.json"
        if not self.store.exists(path):
            raise TagNotFoundError(name)
        self.store.write_bytes(path, json.dumps({"version": version}).encode())

    def delete_tag(self, name: str) -> None:
        path = f"{self.root}/{REFS_DIR}/tags/{name}.json"
        if not self.store.exists(path):
            raise TagNotFoundError(name)
        self.store.delete(path)

    def list_tags(self) -> dict[str, dict]:
        out = {}
        for p in self.store.list(f"{self.root}/{REFS_DIR}/tags"):
            if p.endswith(".json"):
                name = p.rsplit("/", 1)[-1][: -len(".json")]
                out[name] = json.loads(self.store.read_bytes(p))
        return out

    def tag_version(self, name: str) -> int:
        return Dataset._read_ref(self.store, self.root, "tags", name)

    # ----------------------------------------------------------- branches

    def create_branch(self, name: str, version: int | None = None) -> None:
        """Fork a new version lineage from `version` (default: current)."""
        src_version = version if version is not None else self.version
        src = Dataset._read_manifest(self.store, self.root, src_version)

        def build(current: Manifest) -> Manifest:
            draft = src.child("create_branch", source_version=src_version)
            # branch commits continue the GLOBAL version sequence but a
            # separate lineage via the branch field + parent pointers
            latest_any = max(v.version for v in self.list_versions())
            draft.version = latest_any + 1
            draft.branch = name
            return draft

        # direct commit (not rebase — branch creation races are genuine conflicts)
        for _ in range(_COMMIT_RETRIES):
            draft = build(self.manifest)
            if self.store.exists(f"{self.root}/{REFS_DIR}/branches/{name}.json"):
                raise InvalidInputError(f"branch {name!r} already exists")
            if self.store.put_if_absent(manifest_path(self.root, draft.version), draft.to_json_bytes()):
                self._update_branch_head(name, draft.version)
                return
        raise CommitConflictError(-1, "create_branch retries exhausted")

    def list_branches(self) -> dict[str, dict]:
        out = {}
        for p in self.store.list(f"{self.root}/{REFS_DIR}/branches"):
            if p.endswith(".json"):
                name = p.rsplit("/", 1)[-1][: -len(".json")]
                out[name] = json.loads(self.store.read_bytes(p))
        return out

    def checkout_branch(self, name: str) -> None:
        latest = Dataset._latest_version(self.store, self.root, name)
        self.manifest = Dataset._read_manifest(self.store, self.root, latest)
        self.pinned = False
        self._readers.clear()
        self._deletion_cache.clear()

    def delete_branch(self, name: str) -> None:
        if name == MAIN_BRANCH:
            raise InvalidInputError("cannot delete the main branch")
        path = f"{self.root}/{REFS_DIR}/branches/{name}.json"
        if not self.store.exists(path):
            raise BranchNotFoundError(name)
        self.store.delete(path)

    def _lineage(self, version: int) -> list[int]:
        """Version chain from `version` back to the root."""
        chain = []
        v = version
        while v is not None:
            chain.append(v)
            try:
                v = Dataset._read_manifest(self.store, self.root, v).parent_version
            except VersionNotFoundError:
                break
        return chain

    def diff_branch(self, name: str) -> dict:
        """What the branch has that the current lineage lacks (reference
        branch_merge.rs diff types): unmerged versions + fragment delta."""
        head = Dataset._latest_version(self.store, self.root, name)
        ours = set(self._lineage(self.version))
        theirs = self._lineage(head)
        unmerged = [v for v in theirs if v not in ours]
        branch_manifest = Dataset._read_manifest(self.store, self.root, head)
        our_frag_ids = {f.id for f in self.manifest.fragments}
        new_frags = [f for f in branch_manifest.fragments if f.id not in our_frag_ids]
        return {
            "branch": name,
            "branch_head": head,
            "unmerged_versions": sorted(unmerged),
            "new_fragments": [f.id for f in new_frags],
            "new_rows": sum(f.num_rows for f in new_frags),
        }

    def merge_branch(self, name: str) -> dict:
        """Merge a branch's appended fragments into the current branch
        (reference branch_merge.rs merge). Append-only merge: fragments
        added on the branch land here; conflicting rewrites are refused."""
        self._check_writable()
        head = Dataset._latest_version(self.store, self.root, name)
        branch_manifest = Dataset._read_manifest(self.store, self.root, head)
        if branch_manifest.schema != self.manifest.schema:
            raise InvalidInputError("branch schema diverged; cannot merge")

        def build(current: Manifest) -> Manifest:
            draft = current.child("merge_branch", branch=name, branch_head=head)
            ours = {f.id for f in draft.fragments}
            added = 0
            for f in branch_manifest.fragments:
                if f.id not in ours:
                    draft.fragments.append(FragmentMeta.from_json(f.to_json()))
                    draft.max_fragment_id = max(draft.max_fragment_id, f.id)
                    added += 1
            draft.transaction["fragments_merged"] = added
            return draft

        self._commit_with_rebase(build)
        return {
            "fragments_merged": int(self.manifest.transaction.get("fragments_merged", 0)),
            "version": self.version,
        }

    # ----------------------------------------------------------- optimize

    def compact_files(self, target_rows: int = DEFAULT_FRAGMENT_ROWS, min_fragments: int = 2) -> dict:
        """Merge small fragments into bigger ones (reference
        table/optimize.rs `Compact`). Row addresses change; indexes over
        compacted fragments are remapped by the caller (table layer)."""
        self._check_writable()
        small = [f for f in self.manifest.fragments if f.num_rows < target_rows]
        if len(small) < min_fragments:
            return {"fragments_removed": 0, "fragments_added": 0}
        small_ids = {f.id for f in small}
        tables = []
        for meta in self.manifest.fragments:
            if meta.id not in small_ids:
                continue
            tbl = self.reader(meta.id).read_all()
            # column drops are metadata-only, so older fragment FILES may
            # still carry dropped-column bytes that newer fragments lack —
            # project every fragment to the live schema before merging
            # (this is also where those stale bytes finally get reclaimed)
            tbl = tbl.select(self.manifest.schema.names).cast(self.manifest.schema)
            keep = self._keep_mask(meta)
            if keep is not None:
                tbl = tbl.take(pa.array(np.nonzero(keep)[0]))
            tables.append(tbl)
        merged = pa.concat_tables(tables)

        def build(current: Manifest) -> Manifest:
            draft = current.child("compact", merged_fragments=sorted(small_ids))
            draft.fragments = [f for f in draft.fragments if f.id not in small_ids]
            fid = draft.max_fragment_id
            added = 0
            for start in range(0, merged.num_rows, target_rows):
                fid += 1
                frag = write_fragment(self.store, self.root, merged.slice(start, target_rows), fid)
                draft.fragments.append(frag)
                added += 1
            draft.max_fragment_id = fid
            # compaction invalidates coverage of indexes over removed frags
            for ix in draft.indices:
                ix.fragment_ids = [f for f in ix.fragment_ids if f not in small_ids]
            draft.transaction["fragments_added"] = added
            return draft

        self._commit_with_rebase(build)
        self._readers.clear()
        return {
            "fragments_removed": len(small_ids),
            "fragments_added": int(self.manifest.transaction.get("fragments_added", 0)),
        }

    def prune_versions(self, keep_latest: int = 1, older_than_seconds: float | None = None) -> dict:
        """Remove old version manifests + unreferenced data files
        (reference table/optimize.rs `Prune`)."""
        infos = self.list_versions()
        tagged = {v["version"] for v in self.list_tags().values()}
        branch_heads = {v["version"] for v in self.list_branches().values()}
        branch_heads.add(self.version)
        keep = set(v.version for v in infos[-keep_latest:]) | tagged | branch_heads
        now = time.time()
        removed = 0
        kept_manifests = []
        for info in infos:
            if info.version in keep:
                kept_manifests.append(info.version)
                continue
            if older_than_seconds is not None and (now - info.timestamp) < older_than_seconds:
                kept_manifests.append(info.version)
                continue
            self.store.delete(manifest_path(self.root, info.version))
            removed += 1
        # garbage-collect unreferenced data files
        referenced: set[str] = set()
        for v in kept_manifests:
            try:
                m = Dataset._read_manifest(self.store, self.root, v)
            except VersionNotFoundError:
                continue
            for f in m.fragments:
                referenced.add(f.data_file)
                if f.deletion_file:
                    referenced.add(f.deletion_file)
        bytes_removed = 0
        for prefix in ("_data", "_deletions"):
            for p in list(self.store.list(f"{self.root}/{prefix}")):
                rel = p[len(self.root) + 1 :]
                if rel not in referenced:
                    try:
                        bytes_removed += self.store.size(p)
                    except FileNotFoundError:
                        pass
                    self.store.delete(p)
        return {"old_versions_removed": removed, "bytes_removed": bytes_removed}

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        total_bytes = 0
        for f in self.manifest.fragments:
            try:
                total_bytes += self.store.size(f"{self.root}/{f.data_file}")
            except FileNotFoundError:
                pass
        return {
            "total_bytes": total_bytes,
            "num_rows": self.manifest.num_rows,
            "num_fragments": len(self.manifest.fragments),
            "num_indices": len(self.manifest.indices),
            "num_deleted_rows": sum(f.num_deleted for f in self.manifest.fragments),
            "version": self.version,
            "branch": self.branch,
        }
