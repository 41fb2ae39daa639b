"""Bounded-memory SQL execution: spilling GROUP BY and Grace hash join.

The reference gets external (disk-spilling) aggregation, sort and join
from DataFusion; its permutation Shuffler runs the same discipline with
a 100 MiB default budget (reference
rust/lancedb/src/dataloader/permutation/shuffle.rs:32-81). This module
applies that radix-spill discipline (data/shuffle.py) to the SQL
engine:

* `spilled_group_by` — input batches radix-partition by a key hash into
  Arrow-IPC spill files; each partition holds ALL rows of its keys, so
  a per-partition pyarrow group_by is complete and exact (including
  count_distinct and mean). Working set = one input batch + one
  partition; partitions that overflow the budget recursively repartition
  with a re-salted hash.
* `spilled_join` — Grace hash join: both sides partition by the same
  key hash, bucket pairs join independently (equal keys collocate, so
  inner AND outer joins are correct per bucket).

The budget is engaged through `set_sql_memory_budget()` or the
`LANCEDB_TPU_SQL_MEMORY_BUDGET` env var; sql.py routes grouped
aggregation and joins here whenever a budget is set.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .data.shuffle import _splitmix64
from .errors import InvalidInputError

#: initial fan-out; overflowing partitions recurse with a new salt
_FANOUT = 32
_MAX_DEPTH = 4

_budget_env = os.environ.get("LANCEDB_TPU_SQL_MEMORY_BUDGET")
_SQL_MEMORY_BUDGET: int | None = int(_budget_env) if _budget_env else None


def set_sql_memory_budget(budget_bytes: int | None) -> None:
    """Set (or clear) the global SQL execution memory budget. When set,
    GROUP BY streams over scan batches with disk spill and joins run as
    Grace hash joins — working set ≈ one batch + one spill partition."""
    global _SQL_MEMORY_BUDGET
    if budget_bytes is not None and budget_bytes <= 0:
        raise InvalidInputError("memory budget must be positive (or None to clear)")
    _SQL_MEMORY_BUDGET = budget_bytes


def sql_memory_budget() -> int | None:
    return _SQL_MEMORY_BUDGET


def hash_key_columns(
    data: pa.Table | pa.RecordBatch, names: list[str], salt: int = 0
) -> np.ndarray:
    """Deterministic (per-process) uint64 hash of the key tuple per row.
    Equal key tuples hash equal regardless of which batch they arrive
    in: each column dictionary-encodes per batch, the (few) distinct
    VALUES hash via python hash, and rows mix through splitmix64."""
    n = data.num_rows
    h = np.full(n, np.uint64(0x51ED2701) ^ np.uint64((salt * 2654435761 + 1) & 0xFFFFFFFFFFFFFFFF),
                dtype=np.uint64)
    for name in names:
        col = data.column(name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        d = pc.dictionary_encode(col)
        idx = np.asarray(pc.fill_null(d.indices, -1)).astype(np.int64)
        vals = d.dictionary.to_pylist()
        vh = np.empty(len(vals) + 1, dtype=np.uint64)
        for i, v in enumerate(vals):
            vh[i] = np.uint64(hash(v) & 0xFFFFFFFFFFFFFFFF)
        vh[-1] = np.uint64(0x9E3779B97F4A7C15)  # NULL sentinel (idx -1)
        h = _splitmix64(h ^ vh[idx])
    return h


class _SpillWriter:
    """One partition's Arrow-IPC spill file (append-only)."""

    def __init__(self, path: str, schema: pa.Schema):
        self.path = path
        self.schema = schema
        self._sink = pa.OSFile(path, "wb")
        self._writer = pa.ipc.new_stream(self._sink, schema)
        self.nbytes = 0
        self.num_rows = 0

    def write(self, batch: pa.RecordBatch) -> None:
        self._writer.write_batch(batch)
        self.nbytes += batch.nbytes
        self.num_rows += batch.num_rows

    def close(self) -> None:
        self._writer.close()
        self._sink.close()

    def read(self) -> pa.Table:
        with pa.OSFile(self.path, "rb") as f:
            return pa.ipc.open_stream(f).read_all()

    def read_batches(self) -> Iterator[pa.RecordBatch]:
        with pa.OSFile(self.path, "rb") as f:
            for b in pa.ipc.open_stream(f):
                yield b

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _norm_batches(batches: Iterable) -> Iterator[pa.RecordBatch]:
    for item in batches:
        if isinstance(item, pa.Table):
            yield from item.to_batches()
        else:
            yield item


def _partition_batches(
    batches: Iterable,
    key_names: list[str],
    tmp_dir: str,
    salt: int,
    tag: str,
    stats: dict | None,
) -> tuple[dict[int, _SpillWriter], pa.Schema | None]:
    """Radix-partition a batch stream by key hash into spill files.
    Returns ({bucket: writer}, schema-or-None-if-empty)."""
    writers: dict[int, _SpillWriter] = {}
    schema: pa.Schema | None = None
    for batch in _norm_batches(batches):
        if schema is None:
            schema = batch.schema
        if batch.num_rows == 0:
            continue
        if stats is not None:
            stats["peak_batch_bytes"] = max(stats.get("peak_batch_bytes", 0), batch.nbytes)
        buckets = (hash_key_columns(batch, key_names, salt) % np.uint64(_FANOUT)).astype(np.int64)
        order = np.argsort(buckets, kind="stable")
        sorted_b = buckets[order]
        tb = pa.Table.from_batches([batch]).take(pa.array(order)).combine_chunks()
        # contiguous runs per bucket → one slice write per bucket
        run_starts = np.flatnonzero(np.diff(sorted_b, prepend=sorted_b[0] - 1))
        bounds = list(run_starts) + [len(sorted_b)]
        for a, bnd in zip(bounds[:-1], bounds[1:]):
            bk = int(sorted_b[a])
            if bk not in writers:
                writers[bk] = _SpillWriter(
                    os.path.join(tmp_dir, f"{tag}-{salt}-{bk}.arrow"), schema
                )
            for rb in tb.slice(a, bnd - a).to_batches():
                writers[bk].write(rb)
    for w in writers.values():
        w.close()
    return writers, schema


def _iter_partitions(
    batches: Iterable,
    key_names: list[str],
    tmp_dir: str,
    budget: int,
    tag: str,
    stats: dict | None,
    salt: int = 0,
    depth: int = 0,
) -> Iterator[pa.Table]:
    """Yield complete key-disjoint partitions, each within the budget
    (oversized partitions recursively repartition with a new salt —
    unless they are a single degenerate key, which cannot split)."""
    writers, _ = _partition_batches(batches, key_names, tmp_dir, salt, tag, stats)
    for w in writers.values():
        if w.nbytes > budget and depth < _MAX_DEPTH:
            yield from _iter_partitions(
                w.read_batches(), key_names, tmp_dir, budget, f"{tag}r",
                stats, salt + 1 + depth * _FANOUT, depth + 1,
            )
        else:
            t = w.read()
            if stats is not None:
                stats["peak_partition_bytes"] = max(
                    stats.get("peak_partition_bytes", 0), t.nbytes
                )
                stats["partitions"] = stats.get("partitions", 0) + 1
            yield t
        w.unlink()


def spilled_group_by(
    batches: Iterable,
    key_names: list[str],
    agg_specs: list[tuple],
    budget_bytes: int,
    tmp_dir: str | None = None,
    stats: dict | None = None,
    schema: pa.Schema | None = None,
) -> pa.Table:
    """Exact grouped aggregation over a batch stream in bounded memory.
    All rows of a key land in one partition, so each per-partition
    pyarrow group_by is final — no merge pass; count_distinct and mean
    stay exact. ``schema`` is the fallback batch schema for an empty
    stream (scans suppress zero-row batches, so an empty table never
    yields one)."""
    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="lancedb-sql-spill-")
    results: list[pa.Table] = []

    def capture(bs):
        nonlocal schema
        for b in _norm_batches(bs):
            if schema is None:
                schema = b.schema
            yield b

    try:
        for part in _iter_partitions(capture(batches), key_names, tmp, budget_bytes, "gb", stats):
            results.append(part.group_by(key_names).aggregate(agg_specs))
        if not results:
            if schema is None:
                raise InvalidInputError("spilled_group_by: empty stream with no schema")
            empty = pa.Table.from_batches([], schema=schema)
            return empty.group_by(key_names).aggregate(agg_specs)
        return pa.concat_tables(results, promote_options="default")
    finally:
        if own_tmp:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


def spilled_join(
    left_batches: Iterable,
    right_batches: Iterable,
    left_keys: list[str],
    right_keys: list[str],
    join_type: str,
    budget_bytes: int,
    right_suffix: str | None = None,
    left_schema: pa.Schema | None = None,
    right_schema: pa.Schema | None = None,
    tmp_dir: str | None = None,
    stats: dict | None = None,
) -> Iterator[pa.Table]:
    """Grace hash join: both sides radix-partition by the join-key hash;
    bucket i of the left joins only bucket i of the right (equal keys
    collocate, so outer joins are correct per bucket). Yields one joined
    table per bucket pair — stream them into aggregation, or concat."""
    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="lancedb-sql-join-")
    try:
        lws, ls = _partition_batches(left_batches, left_keys, tmp, 0, "jl", stats)
        rws, rs = _partition_batches(right_batches, right_keys, tmp, 0, "jr", stats)
        lschema = ls or left_schema
        rschema = rs or right_schema
        keep_left = join_type in ("left outer", "full outer")
        keep_right = join_type in ("right outer", "full outer")

        def empty_side(schema, side):
            if schema is None:
                # only reachable when an outer join must preserve rows of
                # the other side and this side's type info never arrived
                raise InvalidInputError(
                    f"spilled_join: empty {side} stream without a schema"
                )
            return pa.Table.from_batches([], schema=schema)

        for bk in sorted(set(lws) | set(rws)):
            lw, rw = lws.get(bk), rws.get(bk)
            if lw is None and not keep_right:
                continue
            if rw is None and not keep_left:
                continue
            lt = lw.read() if lw is not None else empty_side(lschema, "left")
            rt = rw.read() if rw is not None else empty_side(rschema, "right")
            if stats is not None:
                stats["peak_partition_bytes"] = max(
                    stats.get("peak_partition_bytes", 0), lt.nbytes + rt.nbytes
                )
                stats["partitions"] = stats.get("partitions", 0) + 1
            out = lt.join(
                rt, keys=left_keys, right_keys=right_keys, join_type=join_type,
                right_suffix=right_suffix,
            )
            if out.num_rows:
                yield out
        for w in list(lws.values()) + list(rws.values()):
            w.unlink()
    finally:
        if own_tmp:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
