"""Normalized ingestion sources — the Scannable capability model.

Reference: python scannable.py — every accepted data input normalizes
to ``{schema, num_rows?, reader factory, rescannable}``. Rescannable
sources (tables, datasets, dataframes) can produce a fresh reader any
number of times (commit retries, two-pass sizing); one-shot sources
(generators, readers) cannot, and consumers must not assume they can.

The streaming ingest path (storage/dataset.append_stream) writes
fragments once and renumbers ids on commit rebase, so retries never
need a re-scan — rescannability here matters for consumers that want
two passes (e.g. schema/width sampling before the real scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import singledispatch
from typing import Callable, Iterator, Optional

import pyarrow as pa
import pyarrow.dataset as pads

from .arrow import to_arrow_table


@dataclass
class Scannable:
    schema: pa.Schema
    num_rows: Optional[int]
    # factory: a NEW reader per call when rescannable
    reader: Callable[[], pa.RecordBatchReader]
    rescannable: bool = True


@singledispatch
def to_scannable(data) -> Scannable:
    """Normalize any supported input (reference to_scannable)."""
    if hasattr(data, "__iter__"):
        return _from_iterator(iter(data))
    raise NotImplementedError(f"to_scannable not implemented for {type(data)}")


def _table_scannable(tbl: pa.Table) -> Scannable:
    return Scannable(
        schema=tbl.schema,
        num_rows=tbl.num_rows,
        reader=lambda: pa.RecordBatchReader.from_batches(tbl.schema, tbl.to_batches()),
        rescannable=True,
    )


@to_scannable.register
def _from_table(data: pa.Table) -> Scannable:
    return _table_scannable(data)


@to_scannable.register
def _from_batch(data: pa.RecordBatch) -> Scannable:
    return _table_scannable(pa.Table.from_batches([data]))


@to_scannable.register
def _from_reader(data: pa.RecordBatchReader) -> Scannable:
    consumed = [False]

    def reader() -> pa.RecordBatchReader:
        if consumed[0]:
            raise ValueError("a RecordBatchReader can only be scanned once")
        consumed[0] = True
        return data

    return Scannable(schema=data.schema, num_rows=None, reader=reader, rescannable=False)


@to_scannable.register
def _from_dataset(data: pads.Dataset) -> Scannable:
    def reader() -> pa.RecordBatchReader:
        sc = data.scanner()
        batches = sc.to_batches()
        if isinstance(batches, pa.RecordBatchReader):
            return batches
        return pa.RecordBatchReader.from_batches(data.schema, batches)

    try:
        n = data.count_rows()
    except Exception:
        n = None
    return Scannable(schema=data.schema, num_rows=n, reader=reader, rescannable=True)


@to_scannable.register
def _from_scanner(data: pads.Scanner) -> Scannable:
    # a Scanner is one configured scan: treat as one-shot (re-running a
    # scanner is implementation-defined across sources)
    def reader() -> pa.RecordBatchReader:
        out = data.to_batches()
        if isinstance(out, pa.RecordBatchReader):
            return out
        return pa.RecordBatchReader.from_batches(data.projected_schema, out)

    return Scannable(
        schema=data.projected_schema, num_rows=None, reader=reader, rescannable=False
    )


@to_scannable.register
def _from_list(data: list) -> Scannable:
    return _table_scannable(to_arrow_table(data))


@to_scannable.register
def _from_dict(data: dict) -> Scannable:
    return _table_scannable(to_arrow_table(data))


def _from_iterator(it: Iterator) -> Scannable:
    """One-shot iterator of batches/tables/row dicts: peek the first
    element for the schema, then chain it back in front."""
    import itertools

    try:
        first = next(it)
    except StopIteration:
        raise ValueError("cannot infer a schema from an empty iterator") from None
    if isinstance(first, dict):  # iterator of rows
        rows = [first, *it]
        return _table_scannable(to_arrow_table(rows))
    first_tbl = (
        pa.Table.from_batches([first]) if isinstance(first, pa.RecordBatch) else first
    )
    schema = first_tbl.schema
    chained = itertools.chain([first], it)
    consumed = [False]

    def reader() -> pa.RecordBatchReader:
        if consumed[0]:
            raise ValueError("an iterator source can only be scanned once")
        consumed[0] = True

        def gen():
            for item in chained:
                tbl = (
                    pa.Table.from_batches([item])
                    if isinstance(item, pa.RecordBatch)
                    else item
                )
                yield from tbl.to_batches()

        return pa.RecordBatchReader.from_batches(schema, gen())

    return Scannable(schema=schema, num_rows=None, reader=reader, rescannable=False)


def _register_optional_converters() -> None:
    try:
        import pandas as pd

        @to_scannable.register(pd.DataFrame)
        def _from_pandas(data) -> Scannable:
            return _table_scannable(
                to_arrow_table(data)
            )
    except ImportError:  # pragma: no cover
        pass
    try:
        import polars as pl

        @to_scannable.register(pl.DataFrame)
        def _from_polars(data) -> Scannable:
            return _table_scannable(data.to_arrow())

        @to_scannable.register(pl.LazyFrame)
        def _from_polars_lazy(data) -> Scannable:
            return _table_scannable(data.collect().to_arrow())
    except ImportError:  # pragma: no cover
        pass


_register_optional_converters()
