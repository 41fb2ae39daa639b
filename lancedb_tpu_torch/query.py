"""Query builders + execution: vector, full-text and hybrid search.

Port of the reference's query.py:

  1. resolve the vector column and its index (FLAT, the IVF types, HNSW;
     none when the query bypasses it or asks for another metric); compute
     the prefilter row-id set from the SQL predicate (a scalar-index
     lookup when one serves the predicate, else a host Arrow-compute scan)
  2. device search over the indexed fragments + brute force over
     unindexed "delta" fragments (skipped by fast_search), merged on the
     host; hamming brute-forces packed uint8 columns
  3. optional exact refine (fused on the device when the column fits)
  4. distance range on the host, then hydrate the selected columns of
     every query's rows with one take_rows, append _distance; postfilter
     and offset apply to the rows. Each call counts one
     ``lancedb.queries`` (metrics.py) before it hydrates, whatever its
     number of query vectors

Full-text search runs the BM25 index on the host (index/fts.py). A hybrid
search runs its full-text legs on host threads while the calling thread
runs the vector legs (every CUDA call stays on it), then fuses each pair
with a reranker (RRF by default). A hybrid call is the span
``query.hybrid`` (``queries``: its pairs) over its vector legs'
``query.vector``, one ``hybrid.fts_leg`` a full-text leg (on whichever
thread runs it: the legs start in a copy of the caller's context),
``hybrid.fts_wait`` (the caller's wait for the full-text legs once its
vector legs returned) and ``hybrid.fuse`` (the fusion of each pair).

A multivector column is searched by late interaction
(index/multivector.py). A plain scan (``query()``, ``search(None)``)
streams the dataset's fragments through the filter and projection.
``explain_plan`` prints the physical plan; ``analyze_plan`` runs the
query and times each operator, synchronizing the table's CUDA device
around each one so that the times cover the device's work (only during
an analyze run: ``metrics.analyze``). Each layer of a search is a
``metrics.span``: ``query.vector`` (the call, from ``to_arrow``) over
``query.plan``, ``prefilter.allowed_rowids``, ``searcher.slot_penalty``,
``searcher.search``, ``query.hydrate`` (one ``dataset.take_rows`` a
call, over every query's rows) and ``query.finish`` (the postfilter,
offset and ordering). A text query for the vector leg is embedded on
the host by the table's embedding function (``Table._embed_query``),
then searched as a vector.
``use_lsm()`` on a plain scan merges the LSM WAL's rows over the table,
newest write winning; searches refuse it, as the reference's do.
"""

from __future__ import annotations

import contextvars
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Iterable

import numpy as np
import pyarrow as pa

from .arrow import fsl_to_numpy, is_multivector_type, vector_column_name
from .errors import InvalidInputError
from .filters.eval import evaluate_expression, evaluate_predicate_mask
from .filters.sql import parse_sql_expr
from .index.vector import SearchParams, brute_force_search
from .metrics import analyze, recorder, span
from .ops.distance import normalize_metric
from .rerankers.base import RELEVANCE_COL, SCORE_COL
from .storage.dataset import ROW_ID_COL

DEFAULT_TOP_K = 10  # reference query.rs:36
DEFAULT_NPROBES = 20  # reference query.rs:1103-1105

DIST_COL = "_distance"
QUERY_INDEX_COL = "query_index"

_INVALID_ROWID = np.uint64(np.iinfo(np.uint64).max)


@dataclass
class ColumnOrdering:
    """One ORDER BY key (reference query.py:361 ColumnOrdering)."""

    column_name: str
    ascending: bool = True
    nulls_first: bool = False


@dataclass
class VectorQueryRequest:
    """Accumulated query state (reference VectorQueryRequest, query.rs:1067-1114)."""

    column: str | None = None
    query_vectors: list[np.ndarray] = field(default_factory=list)
    k: int = DEFAULT_TOP_K
    offset: int = 0
    filter: str | None = None
    prefilter: bool = True  # False: the filter applies to the hydrated rows
    minimum_nprobes: int = DEFAULT_NPROBES
    maximum_nprobes: int | None = DEFAULT_NPROBES
    refine_factor: int | None = None
    distance_type: str | None = None  # None: the index's metric (l2 without one)
    lower_bound: float | None = None  # distance range [lower, upper)
    upper_bound: float | None = None
    ef: int | None = None  # HNSW search width
    use_index: bool = True  # False: brute force (bypass_vector_index)
    fast_search: bool = False  # True: skip the unindexed delta fragments
    precision: str = "default"  # FLAT scans and the brute force of delta rows
    select: list[str] | dict[str, str] | None = None  # a dict: alias → SQL expression
    with_row_id: bool = False


def execute_vector_query(table, req: VectorQueryRequest) -> pa.Table:
    """Run one (or a batch of) vector queries → Arrow result table."""
    ds = table._dataset
    column = req.column or vector_column_name(ds.schema)
    if not req.query_vectors:
        raise InvalidInputError("no query vector provided")
    if column in ds.schema.names and is_multivector_type(ds.schema.field(column).type):
        return _execute_multivector_query(table, req, column)
    with span("query.plan"):
        queries, multi, index_meta, searcher, metric = _plan_vector_query(table, req, column)

    # ---- prefilter -------------------------------------------------------
    allowed: np.ndarray | None = None
    if req.filter is not None and req.prefilter:
        with span("prefilter.allowed_rowids", op="PrefilterExec") as t:
            allowed = compute_allowed_rowids(table, req.filter)
            t.set_rows(len(allowed))
        if len(allowed) == 0:
            return _empty_result(table, req, multi)
    k_search = req.k + req.offset

    # ---- search ----------------------------------------------------------
    if searcher is None:
        with span("query.knn_flat", op="KnnFlatExec") as t:
            dists, rowids = _brute_force_fragments(
                table, column, queries, req, k_search, metric, frags=ds.manifest.fragments
            )
            t.set_rows(int((rowids != _INVALID_ROWID).sum()))
    else:
        with span("query.plan"):
            # rows deleted after the build, and fragments dropped since
            deleted, vanished = _deleted_rowids(ds, index_meta, searcher)
            if req.refine_factor is not None:
                # fused device refine when a resident copy of the column
                # fits; search() then returns already-refined results. A
                # float32-precision request uploads an exact f32 table.
                searcher.prepare_device_refine(
                    ds, column, precision="float32" if req.precision == "float32" else None
                )
        with span("searcher.slot_penalty"):
            pen = searcher.slot_penalty(allowed, deleted, vanished_fragments=vanished)

        def run(nprobes: int):
            params = SearchParams(k=k_search, nprobes=nprobes, refine_factor=req.refine_factor,
                                  ef=req.ef, precision=req.precision)
            d, r = searcher.search(queries, params, slot_penalty=pen)
            if req.refine_factor is not None and not searcher.will_fuse_refine(params):
                d, r = searcher.refine(ds, column, queries, d, r, k_search)
            return d, r

        with span("searcher.search", op="ANNSubIndexExec") as t:
            dists, rowids = run(req.minimum_nprobes)
            # adaptive expansion (reference minimum/maximum_nprobes,
            # query.rs:1215-1283): when filters starve the probed partitions,
            # retry once at maximum_nprobes (None = every partition)
            max_np = (req.maximum_nprobes if req.maximum_nprobes is not None
                      else max(req.minimum_nprobes, 1 << 20))
            if max_np > req.minimum_nprobes and (rowids == _INVALID_ROWID).any():
                dists, rowids = run(max_np)
            t.set_rows(int((rowids != _INVALID_ROWID).sum()))
        # delta fragments not covered by the index → brute force + merge
        covered = set(index_meta.fragment_ids)
        delta = [f for f in ds.manifest.fragments if f.id not in covered]
        if delta and not req.fast_search:
            with span("query.knn_flat", op="KnnFlatExec") as t:
                d2, r2 = _brute_force_fragments(table, column, queries, req, k_search, metric,
                                                delta)
                t.set_rows(int((r2 != _INVALID_ROWID).sum()))
            dists, rowids = _merge_host(dists, rowids, d2, r2, k_search)

    with span("query.hydrate", op="TakeExec", queries=len(queries)) as t:
        # ---- distance range: lower bound inclusive, upper bound exclusive
        if req.lower_bound is not None:
            dists = np.where(dists >= req.lower_bound, dists, np.inf)
        if req.upper_bound is not None:
            dists = np.where(dists < req.upper_bound, dists, np.inf)
        rowids = np.where(np.isfinite(dists), rowids, _INVALID_ROWID)
        recorder().increment_counter("lancedb.queries",
                                     labels={"table": table.name, "kind": "vector"})
        out = _hydrate_results(table, req, dists, rowids, multi)
        t.set_rows(out.num_rows)
    with span("query.finish"):
        return _postfilter_and_offset(out, req, len(req.query_vectors) if multi else 0)


def _plan_vector_query(table, req: VectorQueryRequest, column: str):
    """The request's checks, its queries stacked, and the index that
    serves it → (queries, multi, index_meta, searcher, metric); no index
    (None, None) when none serves the column and metric."""
    ds = table._dataset
    # nprobes validation (reference query.rs minimum/maximum_nprobes;
    # maximum_nprobes=0 means "no limit")
    if req.minimum_nprobes <= 0:
        raise InvalidInputError("minimum_nprobes must be greater than 0")
    if req.maximum_nprobes == 0:
        req.maximum_nprobes = None
    if req.maximum_nprobes is not None and req.maximum_nprobes < req.minimum_nprobes:
        raise InvalidInputError(
            "maximum_nprobes must be greater than or equal to minimum_nprobes"
        )
    queries = np.stack([np.asarray(v, dtype=np.float32).reshape(-1) for v in req.query_vectors])
    multi = len(req.query_vectors) > 1

    index_meta = None
    if req.use_index:
        index_meta = next(
            (ix for ix in ds.manifest.indices
             if ix.columns == [column] and ix.index_type.startswith(("IVF", "FLAT"))),
            None,
        )
    searcher = table._get_searcher(index_meta) if index_meta is not None else None
    metric = normalize_metric(req.distance_type or (searcher.metric if searcher else "l2"))
    if searcher is not None and req.distance_type is not None and metric != searcher.metric:
        # a metric the index was not built for: brute force in that metric
        searcher = index_meta = None
    return queries, multi, index_meta, searcher, metric


def _postfilter_and_offset(out: pa.Table, req: VectorQueryRequest, nq_multi: int) -> pa.Table:
    """The filter on the hydrated rows when it is a postfilter, then each
    query's rows ``offset`` to ``offset + k`` (split by query_index for a
    batch of ``nq_multi`` queries)."""
    if req.filter is not None and not req.prefilter and out.num_rows:
        with span("query.postfilter", op="FilterExec") as t:
            out = out.filter(pa.array(evaluate_predicate_mask(out, req.filter)))
            t.set_rows(out.num_rows)
    if req.offset:
        if nq_multi:
            out = pa.concat_tables([
                out.filter(pa.compute.equal(out.column(QUERY_INDEX_COL), qi))
                .slice(req.offset, req.k)
                for qi in range(nq_multi)
            ])
        else:
            out = out.slice(req.offset, req.k)
    return out


def _execute_multivector_query(table, req: VectorQueryRequest, column: str) -> pa.Table:
    """ColBERT-style MaxSim retrieval over a multivector column (the
    reference's query.py:240-276): the query's token bag arrives as a list
    of rows and is stacked back; the prefilter is a scan of the table."""
    from .index.multivector import multivector_search

    ds = table._dataset
    tokens = np.stack([np.asarray(v, dtype=np.float32).reshape(-1) for v in req.query_vectors])
    allowed = None
    if req.filter is not None and req.prefilter:
        t = ds.to_table(columns=[], predicate=req.filter, with_row_id=True)
        allowed = np.sort(t.column(ROW_ID_COL).to_numpy().astype(np.uint64))
        if len(allowed) == 0:
            return _empty_result(table, req, multi=False)
    searcher = None
    if req.use_index:
        for ix in ds.manifest.indices:
            if ix.columns == [column] and ix.params.get("multivector"):
                # served only while it covers every fragment
                if {f.id for f in ds.manifest.fragments} == set(ix.fragment_ids):
                    searcher = table._get_searcher(ix)
                break
    scores, rowids = multivector_search(
        table, column, tokens, req.k + req.offset,
        searcher=searcher, nprobes=req.minimum_nprobes, allowed=allowed,
    )
    # similarity → distance: a higher MaxSim is closer
    out = _hydrate_results(table, req, -scores[None, :], rowids[None, :], multi=False)
    return _postfilter_and_offset(out, req, 0)


def compute_allowed_rowids(table, predicate: str) -> np.ndarray:
    """Predicate → sorted allowed row addresses: scalar-index fast path
    (BTree/Bitmap/LabelList/FM lookups, reference scalar-index prefilter
    pushdown) with a full Arrow-compute scan when no index serves it."""
    from .index.scalar import try_scalar_prefilter

    fast = try_scalar_prefilter(table, parse_sql_expr(predicate))
    if fast is not None:
        return np.sort(np.asarray(fast, dtype=np.uint64))
    t = table._dataset.to_table(columns=[], predicate=predicate, with_row_id=True)
    return np.sort(t.column(ROW_ID_COL).to_numpy().astype(np.uint64))


def _indexed_fragments(searcher) -> set[int]:
    """The fragments whose rows a searcher holds (computed once per
    searcher, which never changes). Padding slots hold the invalid row id,
    which names no fragment: counted as one, it would be "vanished" and
    cost every search a full slot penalty."""
    frags = getattr(searcher, "_indexed_fragments", None)
    if frags is None:
        rids = searcher.row_ids_flat
        frags = set(np.unique(rids[rids != _INVALID_ROWID] >> np.uint64(32)).tolist())
        searcher._indexed_fragments = frags
    return frags


def _deleted_rowids(ds, index_meta, searcher) -> tuple[np.ndarray | None, set[int] | None]:
    """(deleted row addresses, vanished fragment ids) the index may still
    contain: rows deleted after the build, and fragments dropped entirely.
    A compaction takes the fragments it merges out of the index's coverage,
    so the vanished ones are those the searcher holds, not only those the
    catalog lists (the reference takes the catalog's alone, and its search
    between compact_files() and a reindex fails; ROADMAP §C)."""
    out = []
    covered = set(index_meta.fragment_ids)
    present = set()
    for meta in ds.manifest.fragments:
        present.add(meta.id)
        if meta.id not in covered:
            continue
        keep = ds._keep_mask(meta)
        if keep is not None:
            gone = np.nonzero(~keep)[0].astype(np.uint64)
            out.append((np.uint64(meta.id) << np.uint64(32)) | gone)
    vanished = (covered | _indexed_fragments(searcher)) - present
    deleted = np.concatenate(out) if out else None
    return deleted, (vanished or None)


def _brute_force_fragments(table, column, queries, req, k, metric, frags):
    """Exact scan over a set of fragments (a prefilter applied during the
    scan); hamming reads the column as packed uint8 bits."""
    wanted = {f.id for f in frags}
    dtype = np.uint8 if metric == "hamming" else np.float32
    mats, rids = [], []
    for m, tbl in table._dataset.scan_fragments(
        columns=[column], predicate=req.filter if req.prefilter else None, with_row_id=True,
    ):
        if m.id in wanted:
            mats.append(fsl_to_numpy(tbl.column(column), dtype=dtype))
            rids.append(tbl.column(ROW_ID_COL).to_numpy().astype(np.uint64))
    n = sum(len(r) for r in rids)
    if n == 0:
        nq = queries.shape[0]
        return (
            np.full((nq, k), np.inf, np.float32),
            np.full((nq, k), _INVALID_ROWID, np.uint64),
        )
    d, r = brute_force_search(
        np.concatenate(mats), np.concatenate(rids),
        queries.astype(dtype) if metric == "hamming" else queries, min(k, n), metric,
        precision="bfloat16" if req.precision == "bfloat16" else "float32",
        device=table._device,
    )
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
        r = np.pad(r, ((0, 0), (0, pad)), constant_values=_INVALID_ROWID)
    return d, r


def _merge_host(d1, r1, d2, r2, k):
    d = np.concatenate([d1, d2], axis=1)
    r = np.concatenate([r1, r2], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), np.take_along_axis(r, order, axis=1)


def _selected_columns(req) -> list[str] | None:
    """The columns to read: None for all of them, and for a dict of SQL
    expressions, which are evaluated over whole rows."""
    return None if req.select is None or isinstance(req.select, dict) else list(req.select)


def _project(tbl: pa.Table, select: dict[str, str]) -> pa.Table:
    """``select({alias: SQL expression})`` over rows read in full."""
    return pa.table({alias: evaluate_expression(tbl, expr) for alias, expr in select.items()})


def _hydrate_results(table, req, dists, rowids, multi) -> pa.Table:
    """Every query's valid rows in one take: query 0's in distance order,
    then query 1's, and so on, with ``_distance`` (``_rowid``,
    ``query_index``) appended. One ``lancedb.hydrate.takes`` a call."""
    valid = rowids != _INVALID_ROWID
    rid = rowids[valid]
    nq = rowids.shape[0]
    recorder().increment_counter("lancedb.hydrate.takes")
    data = table._dataset.take_rows(rid, columns=_selected_columns(req), _lookups=nq)
    if isinstance(req.select, dict):
        data = _project(data, req.select)
    data = data.append_column(DIST_COL, pa.array(dists[valid].astype(np.float32)))
    if req.with_row_id:
        data = data.append_column(ROW_ID_COL, pa.array(rid, type=pa.uint64()))
    if multi:
        qidx = np.repeat(np.arange(nq, dtype=np.int32), valid.sum(axis=1))
        data = data.append_column(QUERY_INDEX_COL, pa.array(qidx))
    return data


def _empty_result(table, req, multi) -> pa.Table:
    cols = _selected_columns(req)
    fields = [f for f in table._dataset.schema if cols is None or f.name in cols]
    if isinstance(req.select, dict):
        fields = [pa.field(alias, pa.float64()) for alias in req.select]
    fields.append(pa.field(DIST_COL, pa.float32()))
    if req.with_row_id:
        fields.append(pa.field(ROW_ID_COL, pa.uint64()))
    if multi:
        fields.append(pa.field(QUERY_INDEX_COL, pa.int32()))
    return pa.schema(fields).empty_table()


# ===================================================================== plans

def explain_vector_plan(table, req: VectorQueryRequest) -> str:
    """The physical plan as text (reference query.py:411, explain_plan;
    the brute force is a matmul scan on any device)."""
    ds = table._dataset
    column = req.column or vector_column_name(ds.schema)
    index_meta = None
    if req.use_index:
        index_meta = next((ix for ix in ds.manifest.indices if ix.columns == [column]), None)
    lines = [f"ProjectionExec: columns={req.select or 'all'} +[_distance]"]
    if req.filter and not req.prefilter:
        lines.append(f"  FilterExec: postfilter [{req.filter}]")
    lines.append(f"  SortExec: _distance ASC, limit={req.k} offset={req.offset}")
    lines.append("    TakeExec: late materialization via row addresses")
    if index_meta is not None:
        ix = index_meta
        nprobes = (
            f"{req.minimum_nprobes}..{req.maximum_nprobes}"
            if req.maximum_nprobes not in (None, req.minimum_nprobes)
            else f"{req.minimum_nprobes}"
        )
        ef = f" ef={req.ef}" if req.ef is not None else ""
        lines.append(
            f"      ANNSubIndexExec: {ix.index_type} column={column} "
            f"nprobes={nprobes} refine={req.refine_factor or 0}{ef} "
            f"metric={ix.params.get('metric')} partitions={ix.params.get('num_partitions')}"
        )
        covered = set(ix.fragment_ids)
        delta = [f.id for f in ds.manifest.fragments if f.id not in covered]
        if delta and not req.fast_search:
            lines.append(f"      KnnFlatExec: delta fragments {delta} (matmul scan)")
    else:
        lines.append(f"      KnnFlatExec: brute-force column={column} (matmul scan)")
    if req.filter and req.prefilter:
        lines.append(f"        PrefilterExec: [{req.filter}] → slot penalty mask")
    return "\n".join(lines)


def analyze_vector_plan(table, req: VectorQueryRequest) -> str:
    """Run the query, then print the plan with each operator's output rows
    and time, the whole query's time and the store's reads (reference
    query.py:456, analyze_plan)."""
    from .io.object_store import IoStats, IoTrackingStore

    ds = table._dataset
    stats = IoStats()
    orig_store = ds.store
    ds.store = IoTrackingStore(orig_store, stats)
    try:
        with analyze(table._device) as run:
            out = execute_vector_query(table, req)
    finally:
        ds.store = orig_store
    elapsed = run.elapsed_s
    snap = stats.snapshot()
    plan_lines = []
    for line in explain_vector_plan(table, req).splitlines():
        rec = run.ops.get(line.strip().split(":", 1)[0])
        if rec is not None:
            parts = [f"output_rows={rec.get('output_rows', 0)}",
                     f"elapsed_compute={rec['elapsed_s'] * 1e3:.3f}ms"]
            if rec["invocations"] > 1:
                parts.append(f"invocations={rec['invocations']}")
            line = f"{line}, metrics=[{', '.join(parts)}]"
        plan_lines.append(line)
    return (
        "\n".join(plan_lines) + "\n"
        f"-- metrics --\n"
        f"elapsed_ms={elapsed * 1e3:.3f} output_rows={out.num_rows} "
        f"iops={snap['read_iops']} bytes_read={snap['read_bytes']}"
    )


# ================================================================= builders


def _coerce_query_vectors(query) -> list[np.ndarray]:
    """One vector, or a batch (list of lists / 2-D array) → list of f32 vectors."""
    if isinstance(query, (list, tuple)) and query and isinstance(
        query[0], (list, tuple, np.ndarray)
    ):
        return [np.asarray(q, dtype=np.float32) for q in query]
    if isinstance(query, np.ndarray) and query.ndim == 2:
        return [np.asarray(row, dtype=np.float32) for row in query]
    return [np.asarray(query, dtype=np.float32)]


class LanceQueryBuilder:
    """Fluent builder base (reference query.py LanceQueryBuilder): the
    setters and outputs every query kind shares, and the dispatch on query
    type."""

    _limit_set = False
    _explicit_row_id = False
    _with_row_address = False
    _fragment_ids: list[int] | None = None
    _order_by: list[tuple[str, str]] | None = None
    _order_nulls: list[str | None] | None = None
    _use_lsm = False

    def __init__(self, table):
        self._table = table
        self._req = VectorQueryRequest()

    # ------------------------------------------------------------ setters

    def where(self, predicate, prefilter: bool = True) -> "LanceQueryBuilder":
        """SQL filter, or a substrait ExtendedExpression blob (reference
        QueryFilter, query.rs:792-812); multiple calls AND-compose. With
        ``prefilter`` False (or after postfilter()) it applies to the
        search's results instead of before the search; as in the
        reference, each call sets the mode anew."""
        from .filters.substrait import is_substrait_filter, substrait_to_sql

        if is_substrait_filter(predicate):
            predicate = substrait_to_sql(predicate)
        parse_sql_expr(predicate)  # validate eagerly
        if self._req.filter is not None:
            predicate = f"({self._req.filter}) AND ({predicate})"
        self._req.filter = predicate
        self._req.prefilter = prefilter
        return self

    filter = where

    def postfilter(self) -> "LanceQueryBuilder":
        """Apply the filter AFTER the search (reference postfilter())."""
        self._req.prefilter = False
        return self

    def offset(self, n: int) -> "LanceQueryBuilder":
        """Skip each query's first ``n`` results (a hybrid search ignores
        it, as the reference's does)."""
        self._req.offset = int(n)
        return self

    def select(self, columns: list[str] | dict[str, str]) -> "LanceQueryBuilder":
        """Columns to return, or ``{alias: SQL expression}``."""
        self._req.select = dict(columns) if isinstance(columns, dict) else list(columns)
        return self

    def limit(self, k: int | None) -> "LanceQueryBuilder":
        """At most ``k`` rows a query. A vector search needs one; a plain
        scan or a full-text search takes None or 0 as every row."""
        self._limit_set = True
        if k is None or k <= 0:
            if isinstance(self, LanceVectorQueryBuilder):
                raise ValueError("Limit is required for ANN/KNN queries")
            self._req.k = max(self._table.count_rows(), 1)
        else:
            self._req.k = int(k)
        return self

    def with_row_id(self, flag: bool = True) -> "LanceQueryBuilder":
        """Add the ``_rowid`` column (the row address) to the results."""
        self._req.with_row_id = flag
        self._explicit_row_id = flag
        return self

    def with_row_address(self, flag: bool = True) -> "LanceQueryBuilder":
        """Add the ``_rowaddr`` column. Row ids here are physical addresses
        (fragment << 32 | offset), so it equals ``_rowid``."""
        self._with_row_address = flag
        if flag:
            self._req.with_row_id = True
        return self

    def fragment_ids(self, fragment_ids: list[int]) -> "LanceQueryBuilder":
        """Restrict a plain scan to these fragments."""
        self._fragment_ids = [int(f) for f in fragment_ids]
        return self

    def with_fragments(self, fragments) -> "LanceQueryBuilder":
        """Restrict a plain scan to these fragments (metadata or ids)."""
        self._fragment_ids = [int(getattr(f, "id", f)) for f in fragments]
        return self

    def use_lsm(self, flag: bool = True) -> "LanceQueryBuilder":
        """Merge the LSM WAL's rows over the table (reference query.rs:818-887
        use_lsm). A plain scan honours it; a search refuses it when it runs."""
        self._use_lsm = flag
        return self

    def order_by(self, *columns) -> "LanceQueryBuilder":
        """Sort the output rows: each key a column name, a (name,
        'asc'|'desc') pair or a ColumnOrdering. On a search it orders the
        k results."""
        keys, nulls = [], []
        for c in columns:
            if isinstance(c, str):
                keys.append((c, "ascending"))
                nulls.append(None)
            elif isinstance(c, ColumnOrdering):
                keys.append((c.column_name, "ascending" if c.ascending else "descending"))
                nulls.append("first" if c.nulls_first else "last")
            else:
                name, direction = c
                desc = str(direction).lower().startswith("desc")
                keys.append((name, "descending" if desc else "ascending"))
                nulls.append(None)
        self._order_by = keys
        self._order_nulls = nulls
        return self

    def _sort_table(self, out: pa.Table) -> pa.Table:
        nulls = self._order_nulls or [None] * len(self._order_by)
        if "first" not in nulls:
            return out.sort_by(self._order_by)
        # pyarrow sorts nulls last: a nulls-first key sorts on a null flag first
        combined, keys = out, []
        for i, ((name, direction), n) in enumerate(zip(self._order_by, nulls)):
            col = out.column(name)
            if n == "first" and col.null_count:
                combined = combined.append_column(f"__nullord{i}", pa.compute.is_null(col))
                keys.append((f"__nullord{i}", "descending"))
            keys.append((name, direction))
        return out.take(pa.compute.sort_indices(combined, sort_keys=keys))

    def _sorted(self, out: pa.Table) -> pa.Table:
        """The row-address column and the ordering, applied to a result."""
        if self._with_row_address and ROW_ID_COL in out.column_names:
            out = out.append_column("_rowaddr", out.column(ROW_ID_COL))
            if not self._explicit_row_id:
                out = out.drop_columns([ROW_ID_COL])
        return self._sort_table(out) if self._order_by else out

    def _check_scan_only_flags(self) -> None:
        """A search refuses the options that only a plain scan honours."""
        if self._use_lsm:
            raise InvalidInputError(
                "use_lsm applies to plain scans (table.query()); search "
                "results are served from the committed base table"
            )
        if self._fragment_ids is not None:
            raise InvalidInputError(
                "fragment_ids/with_fragments apply to plain scanner-backed "
                "queries only (reference query.py:1327-1335)"
            )

    def to_query_object(self) -> dict:
        """The accumulated query as a plain dict."""
        import dataclasses

        req = dataclasses.asdict(self._req)
        req["query_vectors"] = [np.asarray(v).tolist() for v in req.get("query_vectors", [])]
        req["query_type"] = type(self).__name__.replace("LanceQueryBuilder", "").replace(
            "Lance", "").replace("QueryBuilder", "").lower() or "empty"
        if self._fragment_ids is not None:
            req["fragment_ids"] = self._fragment_ids
        if self._use_lsm:
            req["use_lsm"] = True
        return req

    # ------------------------------------------------------------ outputs

    def to_arrow(self) -> pa.Table:
        raise NotImplementedError

    def to_batches(self, max_batch_length: int = 1024,
                   timeout: float | None = None) -> Iterable[pa.RecordBatch]:
        """The results as RecordBatches of at most ``max_batch_length`` rows.
        A search's results are k-bounded, so it runs, then re-chunks; the
        plain scan streams fragment by fragment."""
        start = time.monotonic()
        for b in self.to_arrow().to_batches(max_chunksize=max_batch_length):
            if timeout is not None and time.monotonic() - start > timeout:
                raise TimeoutError(f"query exceeded timeout={timeout}s")
            yield b

    def to_pandas(self, flatten=None, **kwargs):
        from .arrow import flatten_columns

        return flatten_columns(self.to_arrow(), flatten).to_pandas(**kwargs)

    def to_df(self):
        return self.to_pandas()

    def to_table(self) -> pa.Table:
        return self.to_arrow()

    to_pyarrow = to_table

    def to_list(self) -> list[dict]:
        return self.to_arrow().to_pylist()

    def to_pydantic(self, model_cls) -> list:
        """The rows as instances of a pydantic model, from the columns it
        declares."""
        return [model_cls(**{k: v for k, v in row.items() if k in model_cls.model_fields})
                for row in self.to_list()]

    def to_json(self) -> list[dict]:
        """Rows as JSON-safe dicts."""
        import json

        return json.loads(json.dumps(
            self.to_list(), default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))

    def to_reader(self, max_batch_length: int = 1024) -> pa.RecordBatchReader:
        out = self.to_arrow()
        return pa.RecordBatchReader.from_batches(
            out.schema, out.to_batches(max_chunksize=max_batch_length))

    def output_schema(self) -> pa.Schema:
        """The schema of the result rows (runs the query with limit 1)."""
        import copy

        saved = copy.deepcopy(self._req)
        try:
            self._req.k = 1
            return self.to_arrow().schema
        finally:
            self._req = saved

    def to_polars(self):
        import polars as pl

        return pl.from_arrow(self.to_arrow())

    @staticmethod
    def create(table, query, query_type: str = "auto", vector_column_name: str | None = None,
               fts_columns: list[str] | None = None) -> "LanceQueryBuilder":
        """Dispatch on the query's type (reference query.py:782-825): None →
        a plain scan; a (vector, text) pair or query_type "hybrid" →
        hybrid; a string → its vector from the table's embedding function
        with query_type "vector", and with "auto" when the table has
        embedding functions and no FTS index, else full text; an FTS query
        node → full text; anything else → vector."""
        from .query_fts import FtsQueryNode

        if query is None:
            return LanceEmptyQueryBuilder(table)
        if query_type == "hybrid" or (
            query_type == "auto" and isinstance(query, tuple) and len(query) == 2
        ):
            vec, text = query if isinstance(query, tuple) else (None, query)
            return LanceHybridQueryBuilder(table, text, vec, vector_column_name, fts_columns)
        if isinstance(query, str):
            if query_type == "auto":
                has_fts = any(ix.index_type == "FTS" for ix in table._dataset.manifest.indices)
                query_type = "vector" if table.embedding_functions and not has_fts else "fts"
            if query_type == "fts":
                return LanceFtsQueryBuilder(table, query, fts_columns)
            if query_type == "vector":
                vec = table._embed_query(query, vector_column_name)
                return LanceVectorQueryBuilder(table, vec, vector_column_name)
            raise InvalidInputError(f"unknown query_type {query_type!r}")
        if isinstance(query, FtsQueryNode):
            return LanceFtsQueryBuilder(table, query, fts_columns)
        return LanceVectorQueryBuilder(table, query, vector_column_name)


class LanceVectorQueryBuilder(LanceQueryBuilder):
    """Vector (ANN/KNN) search builder (reference query.py:1559)."""

    def __init__(self, table, query, vector_column_name: str | None = None):
        super().__init__(table)
        self._req.column = vector_column_name
        self._req.query_vectors = _coerce_query_vectors(query)
        self._reranker = None

    def vector(self, vector) -> "LanceVectorQueryBuilder":
        """Replace the query vector(s)."""
        self._req.query_vectors = _coerce_query_vectors(vector)
        return self

    def column(self, name: str) -> "LanceVectorQueryBuilder":
        """Search this vector column."""
        self._req.column = name
        return self

    def nprobes(self, n: int) -> "LanceVectorQueryBuilder":
        self._req.minimum_nprobes = int(n)
        self._req.maximum_nprobes = int(n)
        return self

    def minimum_nprobes(self, n: int) -> "LanceVectorQueryBuilder":
        self._req.minimum_nprobes = int(n)
        return self

    def maximum_nprobes(self, n: int) -> "LanceVectorQueryBuilder":
        self._req.maximum_nprobes = int(n)
        return self

    def refine_factor(self, rf: int) -> "LanceVectorQueryBuilder":
        self._req.refine_factor = int(rf)
        return self

    def metric(self, metric: str) -> "LanceVectorQueryBuilder":
        """The distance metric: l2, cosine, dot or hamming (packed uint8
        columns). One the index was not built with brute-forces."""
        self._req.distance_type = normalize_metric(metric)
        return self

    distance_type = metric

    def distance_range(self, lower_bound: float | None = None,
                       upper_bound: float | None = None) -> "LanceVectorQueryBuilder":
        """Keep results with lower_bound <= distance < upper_bound."""
        self._req.lower_bound = lower_bound
        self._req.upper_bound = upper_bound
        return self

    def ef(self, ef: int) -> "LanceVectorQueryBuilder":
        """HNSW search width (beam size); other index types ignore it."""
        self._req.ef = int(ef)
        return self

    def bypass_vector_index(self) -> "LanceVectorQueryBuilder":
        """Exact brute force, whatever index the column has."""
        self._req.use_index = False
        return self

    def fast_search(self) -> "LanceVectorQueryBuilder":
        """Search the index only, skipping rows added since its build."""
        self._req.fast_search = True
        return self

    def precision(self, p: str) -> "LanceVectorQueryBuilder":
        """FLAT scan precision: 'default' (two-pass), 'float32' or 'bfloat16'."""
        self._req.precision = p
        return self

    def rerank(self, reranker) -> "LanceVectorQueryBuilder":
        """Rerank the results with ``reranker.rerank_vector`` (reference
        query.py:924)."""
        self._reranker = reranker
        return self

    def to_arrow(self) -> pa.Table:
        with span("query.vector"):
            self._check_scan_only_flags()
            if self._reranker is None:
                out = execute_vector_query(self._table, self._req)
            else:
                out = execute_vector_query(self._table, replace(self._req, with_row_id=True))
                out = self._reranker.rerank_vector("", out).slice(0, self._req.k)
                if not self._req.with_row_id and ROW_ID_COL in out.column_names:
                    out = out.drop_columns([ROW_ID_COL])
            with span("query.finish"):
                return self._sorted(out)

    def explain_plan(self, verbose: bool = False) -> str:
        return explain_vector_plan(self._table, self._req)

    def analyze_plan(self) -> str:
        return analyze_vector_plan(self._table, self._req)


class LanceEmptyQueryBuilder(LanceQueryBuilder):
    """A plain scan: filter, projection, ordering, offset and limit
    (reference query.py:929-1076)."""

    def _carry(self, b: LanceQueryBuilder) -> LanceQueryBuilder:
        b._req.filter = self._req.filter
        b._req.prefilter = self._req.prefilter
        b._req.select = self._req.select
        # a search refuses a scan-only option instead of dropping it
        b._fragment_ids = self._fragment_ids
        b._use_lsm = self._use_lsm
        return b

    def nearest_to(self, vector) -> "LanceVectorQueryBuilder":
        """Switch to a vector search."""
        return self._carry(LanceVectorQueryBuilder(self._table, vector, self._req.column))

    def nearest_to_text(self, text: str, columns: list[str] | None = None
                        ) -> "LanceFtsQueryBuilder":
        """Switch to a full-text search."""
        return self._carry(LanceFtsQueryBuilder(self._table, text, columns))

    def _scan_limit(self) -> int | None:
        # a plain scan has no limit unless .limit() was called
        return self._req.k if self._limit_set else None

    def to_arrow(self) -> pa.Table:
        ds = self._table._dataset
        limit = self._scan_limit()
        if self._use_lsm:
            if self._fragment_ids is not None:
                raise InvalidInputError(
                    "fragment_ids cannot combine with use_lsm: WAL rows are "
                    "not committed to fragments yet"
                )
            return self._lsm_scan(limit)
        # a sort decides which rows the limit keeps: push the limit and the
        # offset down only into an unsorted scan
        out = ds.to_table(
            columns=_selected_columns(self._req),
            predicate=self._req.filter,
            limit=None if self._order_by else limit,
            offset=0 if self._order_by else self._req.offset,
            with_row_id=self._req.with_row_id,
            fragments=self._fragment_ids,
        )
        if isinstance(self._req.select, dict):
            out = _project(out, self._req.select)
        if self._order_by:
            out = self._sort_table(out)
            if self._req.offset:
                out = out.slice(self._req.offset)
            if limit is not None:
                out = out.slice(0, limit)
        if self._with_row_address and ROW_ID_COL in out.column_names:
            out = out.append_column("_rowaddr", out.column(ROW_ID_COL))
            if not self._explicit_row_id:
                out = out.drop_columns([ROW_ID_COL])
        return out

    def _lsm_scan(self, limit: int | None) -> pa.Table:
        """The table's rows whose keys the WAL does not hold, then the WAL's
        live rows (each key's newest write), through the filter and
        projection; WAL rows carry the invalid row id."""
        ds = self._table._dataset
        lsm = self._table._lsm
        spec = lsm.get_spec()
        wal = lsm.wal_rows() if spec is not None else None
        keys = spec.key_columns if spec is not None else []
        cols = _selected_columns(self._req)
        read_cols = None if cols is None else sorted(set(cols) | set(keys))
        base = ds.to_table(columns=read_cols, predicate=self._req.filter,
                           with_row_id=self._req.with_row_id)
        if wal is not None and wal.num_rows:
            wal_keys = set(zip(*[wal.column(c).to_pylist() for c in keys]))
            keep = np.asarray([k not in wal_keys
                               for k in zip(*[base.column(c).to_pylist() for c in keys])],
                              dtype=bool)
            if not keep.all():
                base = base.filter(pa.array(keep))
            if self._req.filter is not None:
                wal = wal.filter(pa.array(evaluate_predicate_mask(wal, self._req.filter)))
            if self._req.with_row_id:
                wal = wal.append_column(
                    ROW_ID_COL, pa.array(np.full(wal.num_rows, _INVALID_ROWID, dtype=np.uint64)))
            base = pa.concat_tables([base, wal.select(base.column_names)],
                                    promote_options="default")
        if cols is not None:
            base = base.select(list(cols) + ([ROW_ID_COL] if self._req.with_row_id else []))
        if isinstance(self._req.select, dict):
            base = _project(base, self._req.select)
        if self._req.offset:
            base = base.slice(self._req.offset)
        return base if limit is None else base.slice(0, limit)

    def to_batches(self, max_batch_length: int = 1024,
                   timeout: float | None = None) -> Iterable[pa.RecordBatch]:
        """A streaming scan: one fragment resident at a time, so a scan of
        the whole table runs in bounded host memory. A sorted, LSM,
        fragment-scoped or row-address scan works on the whole result
        instead."""
        if (self._order_by or self._use_lsm or self._fragment_ids is not None
                or self._with_row_address):
            yield from super().to_batches(max_batch_length, timeout)
            return
        start = time.monotonic()
        dyn = self._req.select if isinstance(self._req.select, dict) else None
        for batch in self._table._dataset.scan_batches(
            columns=_selected_columns(self._req),
            predicate=self._req.filter,
            limit=self._scan_limit(),
            offset=self._req.offset,
            with_row_id=self._req.with_row_id,
            max_batch_length=max_batch_length,
        ):
            if timeout is not None and time.monotonic() - start > timeout:
                raise TimeoutError(f"query exceeded timeout={timeout}s")
            if dyn is not None:
                batch = _project(pa.Table.from_batches([batch]), dyn).combine_chunks(
                ).to_batches()[0]
            yield batch

    def explain_plan(self, verbose: bool = False) -> str:
        return (
            f"ProjectionExec: columns={self._req.select or 'all'}\n"
            f"  ScanExec: filter=[{self._req.filter}] limit={self._req.k}"
        )


class LanceFtsQueryBuilder(LanceQueryBuilder):
    """Full-text (BM25) search builder (reference query.py:1079-1143)."""

    def __init__(self, table, query, fts_columns: list[str] | None = None):
        super().__init__(table)
        self._query = query
        self._fts_columns = fts_columns
        self._reranker = None

    def rerank(self, reranker) -> "LanceFtsQueryBuilder":
        self._reranker = reranker
        return self

    def text(self, query) -> "LanceFtsQueryBuilder":
        """Replace the FTS query."""
        self._query = query
        return self

    def get_query(self):
        """The query text or FTS AST node."""
        return self._query

    def to_query_object(self) -> dict:
        obj = super().to_query_object()
        obj["query_type"] = "fts"
        q = self._query
        obj["full_text_query"] = q.to_json() if hasattr(q, "to_json") else {
            "query": str(q), "columns": self._fts_columns,
        }
        return obj

    def phrase_query(self, flag: bool = True) -> "LanceFtsQueryBuilder":
        """Treat the query text as an exact phrase."""
        if flag and isinstance(self._query, str):
            from .query_fts import PhraseQuery

            self._query = PhraseQuery(self._query, column=None)
        return self

    def to_arrow(self) -> pa.Table:
        self._check_scan_only_flags()
        out = self._table._execute_fts(
            self._query,
            columns=self._fts_columns,
            k=self._req.k,
            offset=self._req.offset,
            filter=self._req.filter,
            prefilter=self._req.prefilter,
            select=self._req.select,
            with_row_id=self._req.with_row_id or self._reranker is not None,
        )
        if self._reranker is not None:
            out = self._reranker.rerank_fts(str(self._query), out).slice(0, self._req.k)
            if not self._req.with_row_id and ROW_ID_COL in out.column_names:
                out = out.drop_columns([ROW_ID_COL])
        return self._sorted(out)

    def explain_plan(self, verbose: bool = False) -> str:
        return (
            f"ProjectionExec: +[_score]\n  SortExec: _score DESC limit={self._req.k}\n"
            f"    FtsExec: BM25 query={self._query!r} filter=[{self._req.filter}]"
        )


class LanceHybridQueryBuilder(LanceQueryBuilder):
    """Hybrid = full text ∥ vector, fused by a reranker (reference
    query.py:1144-1366; rust execute_hybrid, query.rs:1372-1445)."""

    def __init__(self, table, text_query, vector_query=None, vector_column_name=None,
                 fts_columns=None):
        super().__init__(table)
        self._text_query = text_query
        self._vector = (
            np.asarray(vector_query, dtype=np.float32) if vector_query is not None else None
        )
        self._vector_column = vector_column_name
        self._fts_columns = fts_columns
        self._reranker = None
        self._vq_opts: dict = {}
        # (vector, text) pairs beyond the first: every vector leg runs in
        # one searcher call (the reference's multi-query-vector union,
        # table/query.rs:334)
        self._extra_queries: list[tuple] = []

    def add_query(self, vector=None, text=None) -> "LanceHybridQueryBuilder":
        """Add another (vector, text) hybrid query to this builder. The
        vector legs of all pairs run as one batched searcher call and the
        FTS legs concurrently on host threads; the results carry a
        ``query_index`` column."""
        if vector is None and text is None:
            raise InvalidInputError("add_query needs a vector and/or text")
        self._extra_queries.append((vector, text if text is not None else self._text_query))
        return self

    def rerank(self, reranker=None, normalize: str = "score") -> "LanceHybridQueryBuilder":
        """Fuse the legs with ``reranker`` (RRF when None). ``normalize`` is
        the reference's signature; the reference ignores it too."""
        self._reranker = reranker
        return self

    def nprobes(self, n: int) -> "LanceHybridQueryBuilder":
        self._vq_opts["nprobes"] = n
        return self

    def minimum_nprobes(self, n: int) -> "LanceHybridQueryBuilder":
        self._vq_opts["minimum_nprobes"] = n
        return self

    def maximum_nprobes(self, n: int) -> "LanceHybridQueryBuilder":
        self._vq_opts["maximum_nprobes"] = n
        return self

    def distance_range(self, lower_bound: float | None = None,
                       upper_bound: float | None = None) -> "LanceHybridQueryBuilder":
        """Bound the vector leg's distances before fusion."""
        self._vq_opts["distance_range"] = (lower_bound, upper_bound)
        return self

    def ef(self, ef: int) -> "LanceHybridQueryBuilder":
        self._vq_opts["ef"] = ef
        return self

    def refine_factor(self, rf: int) -> "LanceHybridQueryBuilder":
        self._vq_opts["refine_factor"] = rf
        return self

    def metric(self, m: str) -> "LanceHybridQueryBuilder":
        self._vq_opts["metric"] = m
        return self

    distance_type = metric

    def text(self, query) -> "LanceHybridQueryBuilder":
        """Replace the FTS leg's query."""
        self._text_query = query
        return self

    def vector(self, vector) -> "LanceHybridQueryBuilder":
        """Replace the vector leg's query vector."""
        self._vector = np.asarray(vector, dtype=np.float32)
        return self

    def to_query_object(self) -> dict:
        obj = super().to_query_object()
        obj["query_type"] = "hybrid"
        obj["query_vectors"] = [np.asarray(self._vector).tolist()] if self._vector is not None else []
        q = self._text_query
        obj["full_text_query"] = q.to_json() if hasattr(q, "to_json") else {
            "query": str(q), "columns": self._fts_columns,
        }
        obj["vector_options"] = dict(self._vq_opts)
        return obj

    def _vector_leg(self, query_vectors) -> LanceVectorQueryBuilder:
        vq = LanceVectorQueryBuilder(self._table, query_vectors, self._vector_column)
        vq._req.filter = self._req.filter
        vq._req.prefilter = self._req.prefilter
        vq._req.k = self._req.k
        vq._req.with_row_id = True
        for opt in ("nprobes", "minimum_nprobes", "maximum_nprobes", "distance_range", "ef",
                    "refine_factor", "metric"):
            if opt in self._vq_opts:  # in the reference's order
                arg = self._vq_opts[opt]
                getattr(vq, opt)(*(arg if opt == "distance_range" else (arg,)))
        return vq

    def _fts_leg(self, text_query) -> pa.Table:
        """Host only: the BM25 scorers, the prefilter and take_rows (no torch)."""
        with span("hybrid.fts_leg"):
            fts = LanceFtsQueryBuilder(self._table, text_query, self._fts_columns)
            fts._req.filter = self._req.filter
            fts._req.prefilter = self._req.prefilter
            fts._req.k = self._req.k
            fts._req.with_row_id = True
            return fts.to_arrow()

    def _start_fts_legs(self, ex: ThreadPoolExecutor, texts: list) -> list:
        """Each text's full-text leg on ``ex``, in a copy of this thread's
        context, so that its spans are children of the call's."""
        return [ex.submit(contextvars.copy_context().run, self._fts_leg, t) for t in texts]

    def _keep_selected(self, out: pa.Table, extra=()) -> pa.Table:
        if not self._req.with_row_id and ROW_ID_COL in out.column_names:
            out = out.drop_columns([ROW_ID_COL])
        if self._req.select is not None and not isinstance(self._req.select, dict):
            keep = set(self._req.select) | {DIST_COL, SCORE_COL, RELEVANCE_COL, ROW_ID_COL,
                                            *extra}
            out = out.select([c for c in out.column_names if c in keep])
        return out

    def _to_arrow_batched(self) -> pa.Table:
        """Every (vector, text) pair at once: the vector legs stack into
        one searcher call on this thread (one B1 launch per 128 queries on
        an IVF_PQ index), the FTS legs fan out on host threads (the native
        scorers release the GIL). Results carry ``query_index``."""
        from .rerankers.rrf import RRFReranker

        pairs = [(self._vector, self._text_query)] + list(self._extra_queries)
        vectors, texts = [], []
        for vec, txt in pairs:
            if vec is None:
                vec = self._table._embed_query(txt, self._vector_column)
            vectors.append(np.asarray(vec, dtype=np.float32).reshape(-1))
            texts.append(txt)
        k = self._req.k
        vq = self._vector_leg(np.stack(vectors))
        with ThreadPoolExecutor(max_workers=min(8, len(texts)),
                                thread_name_prefix="hybrid-fts") as ex:
            fts_futures = self._start_fts_legs(ex, texts)
            vector_all = vq.to_arrow()
            with span("hybrid.fts_wait"):
                fts_results = [f.result() for f in fts_futures]

        with span("hybrid.fuse"):
            reranker = self._reranker or RRFReranker()
            qidx = vector_all.column(QUERY_INDEX_COL).to_numpy(zero_copy_only=False)
            parts = []
            for qi, (txt, fts_res) in enumerate(zip(texts, fts_results)):
                vres = vector_all.filter(pa.array(qidx == qi)).drop_columns([QUERY_INDEX_COL])
                fused = self._sorted(reranker.rerank_hybrid(str(txt), vres, fts_res).slice(0, k))
                fused = fused.append_column(
                    QUERY_INDEX_COL, pa.array(np.full(len(fused), qi, dtype=np.int32))
                )
                parts.append(fused)
            out = pa.concat_tables(parts, promote_options="permissive")
            return self._keep_selected(out, (QUERY_INDEX_COL,))

    def to_arrow(self) -> pa.Table:
        from .rerankers.rrf import RRFReranker

        self._check_scan_only_flags()
        with span("query.hybrid", queries=1 + len(self._extra_queries)):
            if self._extra_queries:
                return self._to_arrow_batched()
            if self._vector is None:
                self._vector = self._table._embed_query(self._text_query, self._vector_column)
            vq = self._vector_leg(self._vector)
            # the FTS leg (host) overlaps the vector leg's device work
            with ThreadPoolExecutor(max_workers=1, thread_name_prefix="hybrid-fts") as ex:
                (fts_future,) = self._start_fts_legs(ex, [self._text_query])
                vector_results = vq.to_arrow()
                with span("hybrid.fts_wait"):
                    fts_results = fts_future.result()
            with span("hybrid.fuse"):
                reranker = self._reranker or RRFReranker()
                fused = reranker.rerank_hybrid(str(self._text_query), vector_results,
                                               fts_results)
                return self._sorted(self._keep_selected(fused.slice(0, self._req.k)))
