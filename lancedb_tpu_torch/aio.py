"""The async surface: connect_async, AsyncConnection, AsyncTable and the
async query builders.

Port of the reference's aio.py (with its AsyncConnection, db.py:397-440,
and AsyncTable, table.py:1380-1600). The core is synchronous, so:

1. **One bounded executor.** Every blocking call runs on one named
   ThreadPoolExecutor, so a burst of queries cannot start unbounded
   threads. A call that reaches the card runs in one of its threads, on
   the table's explicit device (the kernels' build lock makes a first
   build from several threads safe).
2. **Streaming.** ``to_batches`` drives the sync fragment-streaming
   iterator in a worker thread and hands batches to the event loop
   through a bounded asyncio queue: the producer waits while the
   consumer lags, and the whole result is never held.
3. **The same builders.** The async builders have the sync ones' fluent
   setters; every terminal method is a coroutine.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
from typing import Any, AsyncIterator

import pyarrow as pa

from .db import LanceDBConnection, connect
from .session import Session
from .table import Table

_EXECUTOR: concurrent.futures.ThreadPoolExecutor | None = None
_EXECUTOR_LOCK = threading.Lock()


def _executor() -> concurrent.futures.ThreadPoolExecutor:
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(32, (os.cpu_count() or 8) + 4),
                thread_name_prefix="lancedb-aio",
            )
        return _EXECUTOR


async def _run(fn, *args, **kwargs):
    loop = asyncio.get_running_loop()
    if kwargs:
        return await loop.run_in_executor(_executor(), lambda: fn(*args, **kwargs))
    return await loop.run_in_executor(_executor(), fn, *args)


_DONE = object()


async def _stream(make_iter, queue_size: int = 4) -> AsyncIterator:
    """Drive a sync iterator in the executor; yield items with
    backpressure. Exceptions propagate; the producer stops if the
    consumer goes away."""
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue(maxsize=queue_size)
    cancelled = threading.Event()

    def produce():
        try:
            for item in make_iter():
                if cancelled.is_set():
                    return
                asyncio.run_coroutine_threadsafe(q.put(item), loop).result()
            asyncio.run_coroutine_threadsafe(q.put(_DONE), loop).result()
        except BaseException as exc:  # propagate into the consumer
            asyncio.run_coroutine_threadsafe(q.put(exc), loop).result()

    fut = loop.run_in_executor(_executor(), produce)
    try:
        while True:
            item = await q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()
        # drain so a blocked producer can observe the cancel flag
        while not q.empty():
            q.get_nowait()
        await fut


# --------------------------------------------------------------------------
# query builders
# --------------------------------------------------------------------------


class AsyncQueryBase:
    """Fluent async query (reference python query.py AsyncQuery).

    Wraps a sync builder; fluent setters apply immediately (cheap),
    terminals run on the shared executor."""

    def __init__(self, sync_builder):
        self._b = sync_builder

    # -- fluent (sync, chainable) -------------------------------------------
    def where(self, predicate: str, prefilter: bool = True) -> "AsyncQueryBase":
        self._b.where(predicate, prefilter)
        return self

    filter = where

    def select(self, columns) -> "AsyncQueryBase":
        self._b.select(columns)
        return self

    def limit(self, k: int) -> "AsyncQueryBase":
        self._b.limit(k)
        return self

    def offset(self, n: int) -> "AsyncQueryBase":
        self._b.offset(n)
        return self

    def with_row_id(self, flag: bool = True) -> "AsyncQueryBase":
        self._b.with_row_id(flag)
        return self

    def order_by(self, *columns) -> "AsyncQueryBase":
        self._b.order_by(*columns)
        return self

    # -- terminals (async) ----------------------------------------------------
    async def to_arrow(self) -> pa.Table:
        return await _run(self._b.to_arrow)

    async def to_list(self) -> list[dict]:
        return await _run(self._b.to_list)

    async def to_pandas(self):
        return await _run(self._b.to_pandas)

    def to_batches(
        self, max_batch_length: int = 1024, timeout: float | None = None
    ) -> AsyncIterator[pa.RecordBatch]:
        """Async record-batch stream with backpressure (reference
        AsyncQuery.to_batches over the tokio RecordBatchStream)."""
        return _stream(lambda: self._b.to_batches(max_batch_length, timeout))

    def __aiter__(self) -> AsyncIterator[pa.RecordBatch]:
        return self.to_batches()

    async def explain_plan(self, verbose: bool = False) -> str:
        return await _run(self._b.explain_plan, verbose)

    async def analyze_plan(self) -> str:
        return await _run(self._b.analyze_plan)


class AsyncVectorQuery(AsyncQueryBase):
    """Reference python query.py AsyncVectorQuery."""

    def metric(self, metric: str) -> "AsyncVectorQuery":
        self._b.metric(metric)
        return self

    distance_type = metric

    def nprobes(self, n: int) -> "AsyncVectorQuery":
        self._b.nprobes(n)
        return self

    def minimum_nprobes(self, n: int) -> "AsyncVectorQuery":
        self._b.minimum_nprobes(n)
        return self

    def maximum_nprobes(self, n: int) -> "AsyncVectorQuery":
        self._b.maximum_nprobes(n)
        return self

    def refine_factor(self, rf: int) -> "AsyncVectorQuery":
        self._b.refine_factor(rf)
        return self

    def ef(self, ef: int) -> "AsyncVectorQuery":
        self._b.ef(ef)
        return self

    def distance_range(self, lower: float | None = None, upper: float | None = None):
        self._b.distance_range(lower, upper)
        return self

    def bypass_vector_index(self) -> "AsyncVectorQuery":
        self._b.bypass_vector_index()
        return self

    def fast_search(self) -> "AsyncVectorQuery":
        self._b.fast_search()
        return self

    def postfilter(self) -> "AsyncVectorQuery":
        """Apply the filter AFTER the vector search (reference
        AsyncVectorQuery.postfilter)."""
        self._b._req.prefilter = False
        return self


class AsyncFTSQuery(AsyncQueryBase):
    """Reference python query.py AsyncFTSQuery."""

    def get_query(self):
        """The query text or FTS AST node (reference query.py:3458)."""
        return self._b.get_query()

    def rerank(self, reranker) -> "AsyncFTSQuery":
        self._b.rerank(reranker)
        return self


class AsyncHybridQuery(AsyncQueryBase):
    """Reference python query.py AsyncHybridQuery."""

    def rerank(self, reranker) -> "AsyncHybridQuery":
        self._b.rerank(reranker)
        return self

    def nprobes(self, n: int) -> "AsyncHybridQuery":
        self._b.nprobes(n)
        return self


# --------------------------------------------------------------------------
# tables and connections
# --------------------------------------------------------------------------

_ASYNC_BUILDERS = {
    "LanceVectorQueryBuilder": AsyncVectorQuery,
    "LanceFtsQueryBuilder": AsyncFTSQuery,
    "LanceHybridQueryBuilder": AsyncHybridQuery,
}


class _AsyncTags:
    """The tags of an AsyncTable; each call runs on the executor."""

    def __init__(self, tags):
        self._tags = tags

    async def list(self) -> dict:
        return await _run(self._tags.list)

    async def create(self, tag: str, version: int | None = None) -> None:
        return await _run(self._tags.create, tag, version)

    async def delete(self, tag: str) -> None:
        return await _run(self._tags.delete, tag)

    async def update(self, tag: str, version: int) -> None:
        return await _run(self._tags.update, tag, version)


class AsyncTable:
    """Async facade over a Table (reference AsyncTable, table.py:1380-1600)."""

    def __init__(self, table: Table):
        self._t = table
        self._closed = False

    @property
    def name(self) -> str:
        return self._t.name

    @property
    def namespace(self) -> list[str]:
        return self._t.namespace

    @property
    def id(self) -> str:
        return self._t.id

    async def initial_storage_options(self) -> dict | None:
        return self._t.initial_storage_options()

    async def latest_storage_options(self) -> dict | None:
        return await _run(self._t.latest_storage_options)

    async def migrate_manifest_paths_v2(self) -> None:
        """Nothing to do: the dataset has one manifest path scheme."""

    async def uses_v2_manifest_paths(self) -> bool:
        return True

    def query(self) -> AsyncQueryBase:
        return AsyncQueryBase(self._t.query())

    def search(self, query: Any = None, vector_column_name: str | None = None,
               query_type: str = "auto", fts_columns: list[str] | None = None):
        b = self._t.search(query, vector_column_name, query_type, fts_columns)
        return _ASYNC_BUILDERS.get(type(b).__name__, AsyncQueryBase)(b)

    async def schema(self) -> pa.Schema:
        return await _run(lambda: self._t.schema)

    async def version(self) -> int:
        return await _run(lambda: self._t.version)

    async def count_rows(self, filter: str | None = None) -> int:
        return await _run(self._t.count_rows, filter)

    async def to_arrow(self) -> pa.Table:
        return await _run(self._t.to_arrow)

    async def add(self, data, mode: str = "append") -> None:
        return await _run(self._t.add, data, mode)

    async def delete(self, where: str) -> int:
        return await _run(self._t.delete, where)

    async def update(self, where: str | None = None, values: dict | None = None, **kw) -> dict:
        return await _run(lambda: self._t.update(where, values, **kw))

    async def merge_insert(self, on, data, *, when_matched_update_all: bool = True,
                           when_not_matched_insert_all: bool = True) -> dict:
        def run():
            b = self._t.merge_insert(on)
            if when_matched_update_all:
                b.when_matched_update_all()
            if when_not_matched_insert_all:
                b.when_not_matched_insert_all()
            return b.execute(data)

        return await _run(run)

    async def vector_search(self, vector, **kwargs) -> pa.Table:
        """One vector search; each keyword names a builder setter."""
        def run():
            b = self._t.vector_search(vector)
            for k, v in kwargs.items():
                getattr(b, k)(v)
            return b.to_arrow()

        return await _run(run)

    async def query_arrow(self, builder_fn) -> pa.Table:
        """Run ``builder_fn(sync_table).to_arrow()`` on the executor."""
        return await _run(lambda: builder_fn(self._t).to_arrow())

    async def create_index(self, **kwargs) -> None:
        return await _run(lambda: self._t.create_index(**kwargs))

    async def create_scalar_index(self, column: str, **kw) -> None:
        return await _run(lambda: self._t.create_scalar_index(column, **kw))

    async def create_fts_index(self, field_names, **kw) -> None:
        return await _run(lambda: self._t.create_fts_index(field_names, **kw))

    async def list_indices(self) -> list[dict]:
        return await _run(self._t.list_indices)

    async def index_stats(self, name: str) -> dict | None:
        return await _run(self._t.index_stats, name)

    async def drop_index(self, name: str) -> None:
        return await _run(self._t.drop_index, name)

    async def prewarm_index(self, name: str) -> None:
        return await _run(self._t.prewarm_index, name)

    async def wait_for_index(self, names, timeout: float = 30.0) -> None:
        return await _run(lambda: self._t.wait_for_index(names, timeout=timeout))

    async def optimize(self, **kw) -> dict:
        return await _run(lambda: self._t.optimize(**kw))

    async def stats(self) -> dict:
        return await _run(self._t.stats)

    async def list_versions(self) -> list[dict]:
        return await _run(self._t.list_versions)

    async def checkout(self, version) -> None:
        return await _run(self._t.checkout, version)

    async def checkout_latest(self) -> None:
        return await _run(self._t.checkout_latest)

    async def restore(self, version: int | None = None) -> None:
        return await _run(lambda: self._t.restore(version))

    @property
    def tags(self) -> _AsyncTags:
        return _AsyncTags(self._t.tags)

    async def create_branch(self, name: str, version: int | None = None) -> None:
        return await _run(self._t.create_branch, name, version)

    async def checkout_branch(self, name: str) -> None:
        return await _run(self._t.checkout_branch, name)

    async def branches(self) -> dict:
        return await _run(self._t.list_branches)

    async def add_columns(self, transforms: dict) -> None:
        return await _run(self._t.add_columns, transforms)

    async def alter_columns(self, *alterations) -> None:
        return await _run(lambda: self._t.alter_columns(*alterations))

    async def drop_columns(self, columns) -> None:
        return await _run(self._t.drop_columns, columns)

    async def set_unenforced_primary_key(self, columns) -> None:
        return await _run(self._t.declare_primary_key, columns)

    async def replace_field_metadata(self, field_name: str, new_metadata: dict) -> None:
        return await _run(self._t.update_field_metadata, field_name, new_metadata)

    async def tokenize(self, query: str, *, column=None, index_name=None):
        return await _run(lambda: self._t.tokenize(query, column=column, index_name=index_name))

    async def blob_columns(self) -> list[str]:
        return await _run(lambda: self._t.blob_columns)

    async def fetch_blobs(self, column: str, row_ids) -> list:
        return await _run(self._t.fetch_blobs, column, row_ids)

    async def fetch_blob_files(self, column: str, row_ids) -> list:
        return await _run(self._t.fetch_blob_files, column, row_ids)

    async def fetch_blob_ranges(self, column: str, row_ids, ranges) -> list:
        return await _run(self._t.fetch_blob_ranges, column, row_ids, ranges)

    async def get_lsm_write_spec(self) -> dict | None:
        return await _run(self._t.get_lsm_write_spec)

    async def unset_lsm_write_spec(self, *, force: bool = False) -> None:
        return await _run(lambda: self._t.unset_lsm_write_spec(force=force))

    def close(self) -> None:
        """Drop the table's cached searchers and indexes."""
        self._t._invalidate_caches()
        self._closed = True

    def is_open(self) -> bool:
        return not self._closed


class AsyncConnection:
    """Async facade over a connection (reference AsyncConnection,
    db.py:397-440)."""

    def __init__(self, inner: LanceDBConnection):
        self._c = inner

    @property
    def uri(self) -> str:
        return self._c.uri

    @property
    def device(self):
        return self._c.device

    @property
    def session(self) -> Session:
        return self._c.session

    async def get_read_consistency_interval(self) -> float | None:
        return self._c.read_consistency_interval

    async def table_names(self, **kw) -> list[str]:
        return await _run(self._c.table_names, **kw)

    async def create_table(self, name: str, data=None, schema=None, **kw) -> AsyncTable:
        return AsyncTable(await _run(lambda: self._c.create_table(name, data, schema, **kw)))

    async def open_table(self, name: str, **kw) -> AsyncTable:
        return AsyncTable(await _run(lambda: self._c.open_table(name, **kw)))

    async def drop_table(self, name: str, ignore_missing: bool = False) -> None:
        await _run(self._c.drop_table, name, ignore_missing)

    async def rename_table(self, old: str, new: str) -> None:
        await _run(self._c.rename_table, old, new)

    async def drop_all_tables(self) -> None:
        await _run(self._c.drop_all_tables)

    def close(self) -> None:
        self._c.close()

    def is_open(self) -> bool:
        return self._c.is_open()


async def connect_async(uri: str, device=None, *, read_consistency_interval: float | None = None,
                        storage_options: dict | None = None,
                        session: Session | None = None) -> AsyncConnection:
    """The async ``connect``: the same device rule (None is the card)."""
    return AsyncConnection(connect(uri, device, read_consistency_interval=read_consistency_interval,
                                   storage_options=storage_options, session=session))
