"""PyArrow dataset-protocol adapters.

Reference: integrations/pyarrow.py — expose a lancedb table through
the ``pyarrow.dataset`` Scanner/Dataset protocol so engines that speak
that protocol (duckdb, polars, datafusion-python, pandas readers) can
scan it with column projection and filter pushdown.

Filters arrive either as SQL strings (our engine) or as
``pyarrow.compute.Expression`` (the protocol's native form); expression
filters apply via Arrow compute on the streamed batches.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import pyarrow as pa
import pyarrow.dataset

Filter = Union[str, "pa.compute.Expression"]


def _reader_from_query(table, columns, filter_, limit, batch_size) -> pa.RecordBatchReader:
    query = table.query()
    sql_filter = filter_ if isinstance(filter_, str) else None
    expr_filter = filter_ if not isinstance(filter_, (str, type(None))) else None
    if sql_filter is not None:
        query = query.where(sql_filter)
    # an expression filter may reference columns OUTSIDE the projection
    # (duckdb pushes e.g. filter=name!='d', columns=['x']): scan the
    # full schema, filter, then project — matching pyarrow.dataset
    # semantics where the filter sees the dataset schema
    project_after = columns is not None and expr_filter is not None
    if columns is not None and not project_after:
        query = query.select(list(columns))
    if limit is not None and limit <= 0:
        raise ValueError("limit must be positive")
    # expression filters evaluate on the STREAM, so the limit must bound
    # post-filter rows — only SQL filters (pushed into the scan) may
    # carry the limit down
    push_limit = limit if expr_filter is None else None
    query = query.limit(push_limit)

    def gen():
        produced = 0
        for batch in query.to_batches(max_batch_length=batch_size or 1024):
            if expr_filter is not None:
                tbl = pa.Table.from_batches([batch]).filter(expr_filter)
                if project_after:
                    tbl = tbl.select(list(columns))
                batches = [b for b in tbl.combine_chunks().to_batches() if b.num_rows]
            else:
                batches = [batch] if batch.num_rows else []
            for b in batches:
                if limit is not None and produced + b.num_rows > limit:
                    b = b.slice(0, limit - produced)
                if b.num_rows:
                    yield b
                    produced += b.num_rows
                if limit is not None and produced >= limit:
                    return

    schema = table.schema if columns is None else pa.schema(
        [table.schema.field(c) for c in columns]
    )
    return pa.RecordBatchReader.from_batches(schema, gen())


class PyarrowScannerAdapter(pa.dataset.Scanner):
    """The Scanner protocol over one configured scan (reference
    PyarrowScannerAdapter): projection + filter decided at construction,
    batches stream through the table's bounded-memory scan."""

    def __init__(
        self,
        table,
        columns: Optional[List[str]] = None,
        filter: Optional[Filter] = None,
        batch_size: Optional[int] = None,
        **unsupported: Any,
    ):
        self.table = table
        self.columns = columns
        self.filter = filter
        self.batch_size = batch_size

    # -- scanner protocol ---------------------------------------------------
    def count_rows(self) -> int:
        if self.filter is None or isinstance(self.filter, str):
            return self.table.count_rows(self.filter)
        return self.to_reader().read_all().num_rows

    def head(self, num_rows: int) -> pa.Table:
        return self.to_reader(limit=num_rows).read_all()

    @property
    def projected_schema(self) -> pa.Schema:
        if self.columns is None:
            return self.table.schema
        return pa.schema([self.table.schema.field(c) for c in self.columns])

    def scan_batches(self):
        return self.to_reader()

    def to_batches(self):
        return self.to_reader()

    def to_reader(self, *, limit: Optional[int] = None) -> pa.RecordBatchReader:
        return _reader_from_query(
            self.table, self.columns, self.filter, limit, self.batch_size
        )

    def to_table(self) -> pa.Table:
        return self.to_reader().read_all()

    def take(self, indices):
        return self.table.take_offsets(list(indices))


class PyarrowDatasetAdapter(pa.dataset.Dataset):
    """The Dataset protocol over a table (reference
    PyarrowDatasetAdapter): every scan method builds a fresh scanner."""

    def __init__(self, table):
        self.table = table

    @property
    def schema(self) -> pa.Schema:
        return self.table.schema

    def count_rows(self, filter: Optional[Filter] = None, **kw) -> int:
        return self.scanner(filter=filter).count_rows()

    def head(self, num_rows: int, columns=None, filter=None, **kw) -> pa.Table:
        return self.scanner(columns=columns, filter=filter).head(num_rows)

    def scanner(self, columns=None, filter=None, batch_size=None, **kw):
        return PyarrowScannerAdapter(
            self.table, columns=columns, filter=filter, batch_size=batch_size
        )

    def to_batches(self, columns=None, filter=None, batch_size=None, **kw):
        return self.scanner(columns, filter, batch_size).to_batches()

    def to_table(self, columns=None, filter=None, **kw) -> pa.Table:
        return self.scanner(columns, filter).to_table()

    def take(self, indices, columns=None, **kw) -> pa.Table:
        out = self.table.take_offsets(list(indices))
        return out.select(columns) if columns else out

    def get_fragments(self, filter=None):
        raise NotImplementedError("fragment access is internal to lancedb-tpu-torch")

    def filter(self, expression):
        raise NotImplementedError("construct a scanner with filter= instead")

    def join(self, *a, **kw):
        raise NotImplementedError("use db.sql() JOINs instead")

    def replace_schema(self, *a, **kw):
        raise NotImplementedError

    def sort_by(self, sorting, **kw):
        return self.to_table().sort_by(sorting)


def to_pyarrow_dataset(table) -> PyarrowDatasetAdapter:
    """Expose a table to pyarrow-dataset consumers (duckdb etc.):

    >>> duckdb.sql("SELECT * FROM ds WHERE id < 5",
    ...            params={"ds": to_pyarrow_dataset(tbl)})  # doctest: +SKIP
    """
    return PyarrowDatasetAdapter(table)
