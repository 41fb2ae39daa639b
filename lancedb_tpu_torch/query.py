"""Vector query builder + execution.

Port of the vector-search part of the reference's query.py:

  1. resolve the vector column and its index (FLAT, IVF_FLAT, IVF_PQ, HNSW); compute the
     prefilter row-id set from the SQL predicate (host, Arrow compute)
  2. device search over the indexed fragments + brute force over
     unindexed "delta" fragments, merged on the host
  3. optional exact refine (fused on the device when the column fits)
  4. hydrate the selected columns with take_rows, append _distance

Multivector, full-text and hybrid queries, plain scans, postfilters,
offsets, distance ranges, metric overrides, plan explanation, rerankers
and scalar-index prefilter pushdown wait for later slices (ROADMAP A4,
A9, A12).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa

from ._surface import NotPortedSurface
from .arrow import fsl_to_numpy, refuse_multivector, vector_column_name
from .errors import InvalidInputError
from .filters.sql import parse_sql_expr
from .index.vector import SearchParams, brute_force_search
from .storage.dataset import ROW_ID_COL

DEFAULT_TOP_K = 10  # reference query.rs:36
DEFAULT_NPROBES = 20  # reference query.rs:1103-1105

DIST_COL = "_distance"
QUERY_INDEX_COL = "query_index"

_INVALID_ROWID = np.uint64(np.iinfo(np.uint64).max)


@dataclass
class VectorQueryRequest:
    """Accumulated query state (reference VectorQueryRequest, query.rs:1067-1114)."""

    column: str | None = None
    query_vectors: list[np.ndarray] = field(default_factory=list)
    k: int = DEFAULT_TOP_K
    filter: str | None = None
    minimum_nprobes: int = DEFAULT_NPROBES
    maximum_nprobes: int | None = DEFAULT_NPROBES
    refine_factor: int | None = None
    ef: int | None = None  # HNSW search width
    precision: str = "default"  # FLAT scans and the brute force of delta rows
    select: list[str] | None = None


def execute_vector_query(table, req: VectorQueryRequest) -> pa.Table:
    """Run one (or a batch of) vector queries → Arrow result table."""
    ds = table._dataset
    column = req.column or vector_column_name(ds.schema)
    if not req.query_vectors:
        raise InvalidInputError("no query vector provided")
    refuse_multivector(ds.schema, column)
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

    index_meta = next(
        (ix for ix in ds.manifest.indices
         if ix.columns == [column] and ix.index_type.startswith(("IVF", "FLAT"))),
        None,
    )
    searcher = table._get_searcher(index_meta) if index_meta is not None else None

    # ---- prefilter -------------------------------------------------------
    allowed: np.ndarray | None = None
    if req.filter is not None:
        allowed = compute_allowed_rowids(table, req.filter)
        if len(allowed) == 0:
            return _empty_result(table, req, multi)

    # ---- search ----------------------------------------------------------
    if searcher is None:
        dists, rowids = _brute_force_fragments(
            table, column, queries, req, "l2", frags=ds.manifest.fragments
        )
    else:
        # rows deleted after the build, and fragments dropped since
        deleted, vanished = _deleted_rowids(ds, index_meta)
        pen = searcher.slot_penalty(allowed, deleted, vanished_fragments=vanished)
        if req.refine_factor is not None:
            # fused device refine when a resident copy of the column fits;
            # search() then returns already-refined results. A
            # float32-precision request uploads an exact f32 table.
            searcher.prepare_device_refine(
                ds, column, precision="float32" if req.precision == "float32" else None
            )

        def run(nprobes: int):
            params = SearchParams(k=req.k, nprobes=nprobes, refine_factor=req.refine_factor,
                                  ef=req.ef, precision=req.precision)
            d, r = searcher.search(queries, params, slot_penalty=pen)
            if req.refine_factor is not None and not searcher.will_fuse_refine(params):
                d, r = searcher.refine(ds, column, queries, d, r, req.k)
            return d, r

        dists, rowids = run(req.minimum_nprobes)
        # adaptive expansion (reference minimum/maximum_nprobes,
        # query.rs:1215-1283): when filters starve the probed partitions,
        # retry once at maximum_nprobes (None = every partition)
        max_np = (req.maximum_nprobes if req.maximum_nprobes is not None
                  else max(req.minimum_nprobes, 1 << 20))
        if max_np > req.minimum_nprobes and (rowids == _INVALID_ROWID).any():
            dists, rowids = run(max_np)
        # delta fragments not covered by the index → brute force + merge
        covered = set(index_meta.fragment_ids)
        delta = [f for f in ds.manifest.fragments if f.id not in covered]
        if delta:
            d2, r2 = _brute_force_fragments(table, column, queries, req, searcher.metric, delta)
            dists, rowids = _merge_host(dists, rowids, d2, r2, req.k)
    return _hydrate_results(table, req, dists, rowids, multi)


def compute_allowed_rowids(table, predicate: str) -> np.ndarray:
    """Predicate → sorted allowed row addresses by a full Arrow-compute
    scan. The scalar-index fast path waits for a later slice (ROADMAP A12)."""
    t = table._dataset.to_table(columns=[], predicate=predicate, with_row_id=True)
    return np.sort(t.column(ROW_ID_COL).to_numpy().astype(np.uint64))


def _deleted_rowids(ds, index_meta) -> tuple[np.ndarray | None, set[int] | None]:
    """(deleted row addresses, vanished fragment ids) the index may still
    contain: rows deleted after the build, and fragments dropped entirely."""
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
    vanished = covered - present
    deleted = np.concatenate(out) if out else None
    return deleted, (vanished or None)


def _brute_force_fragments(table, column, queries, req, metric, frags):
    """Exact scan over a set of fragments (predicate applied during scan)."""
    wanted = {f.id for f in frags}
    mats, rids = [], []
    for m, tbl in table._dataset.scan_fragments(
        columns=[column], predicate=req.filter, with_row_id=True,
    ):
        if m.id in wanted:
            mats.append(fsl_to_numpy(tbl.column(column), dtype=np.float32))
            rids.append(tbl.column(ROW_ID_COL).to_numpy().astype(np.uint64))
    k = req.k
    n = sum(len(r) for r in rids)
    if n == 0:
        nq = queries.shape[0]
        return (
            np.full((nq, k), np.inf, np.float32),
            np.full((nq, k), _INVALID_ROWID, np.uint64),
        )
    d, r = brute_force_search(
        np.concatenate(mats), np.concatenate(rids), queries, min(k, n), metric,
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


def _hydrate_results(table, req, dists, rowids, multi) -> pa.Table:
    ds = table._dataset
    parts = []
    for qi in range(dists.shape[0]):
        valid = rowids[qi] != _INVALID_ROWID
        rid = rowids[qi][valid]
        data = ds.take_rows(rid, columns=req.select)
        data = data.append_column(DIST_COL, pa.array(dists[qi][valid].astype(np.float32)))
        if multi:
            data = data.append_column(
                QUERY_INDEX_COL, pa.array(np.full(len(rid), qi, dtype=np.int32))
            )
        parts.append(data)
    return pa.concat_tables(parts)


def _empty_result(table, req, multi) -> pa.Table:
    fields = [f for f in table._dataset.schema if req.select is None or f.name in req.select]
    fields.append(pa.field(DIST_COL, pa.float32()))
    if multi:
        fields.append(pa.field(QUERY_INDEX_COL, pa.int32()))
    return pa.schema(fields).empty_table()


def _coerce_query_vectors(query) -> list[np.ndarray]:
    """One vector, or a batch (list of lists / 2-D array) → list of f32 vectors."""
    if isinstance(query, (list, tuple)) and query and isinstance(
        query[0], (list, tuple, np.ndarray)
    ):
        return [np.asarray(q, dtype=np.float32) for q in query]
    if isinstance(query, np.ndarray) and query.ndim == 2:
        return [np.asarray(row, dtype=np.float32) for row in query]
    return [np.asarray(query, dtype=np.float32)]


class LanceVectorQueryBuilder(NotPortedSurface):
    """Vector (ANN/KNN) search builder (reference query.py:1559)."""

    _NOT_PORTED = {
        **dict.fromkeys(
            ("offset", "with_row_id", "with_row_address", "postfilter", "filter", "metric",
             "distance_type", "distance_range", "bypass_vector_index", "fast_search",
             "vector", "column", "order_by", "fragment_ids", "with_fragments",
             "to_batches", "to_pandas", "to_polars", "to_df", "to_table", "to_pyarrow",
             "to_json", "to_reader", "to_pydantic", "output_schema", "to_query_object",
             "explain_plan", "analyze_plan"),
            "A4",
        ),
        "rerank": "A12",
        "use_lsm": "A12",
    }

    def __init__(self, table, query, vector_column_name: str | None = None):
        self._table = table
        self._req = VectorQueryRequest(
            column=vector_column_name, query_vectors=_coerce_query_vectors(query)
        )

    def where(self, predicate: str) -> "LanceVectorQueryBuilder":
        """SQL prefilter; multiple calls AND-compose."""
        parse_sql_expr(predicate)  # validate eagerly
        if self._req.filter is not None:
            predicate = f"({self._req.filter}) AND ({predicate})"
        self._req.filter = predicate
        return self

    def select(self, columns: list[str]) -> "LanceVectorQueryBuilder":
        if isinstance(columns, dict):
            raise NotImplementedError(
                "SQL projections in select() are not ported to lancedb_tpu_torch yet (ROADMAP A4)"
            )
        self._req.select = list(columns)
        return self

    def limit(self, k: int) -> "LanceVectorQueryBuilder":
        if k is None or k <= 0:
            raise ValueError("Limit is required for ANN/KNN queries")
        self._req.k = int(k)
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

    def ef(self, ef: int) -> "LanceVectorQueryBuilder":
        """HNSW search width (beam size); other index types ignore it."""
        self._req.ef = int(ef)
        return self

    def precision(self, p: str) -> "LanceVectorQueryBuilder":
        """FLAT scan precision: 'default' (two-pass), 'float32' or 'bfloat16'."""
        self._req.precision = p
        return self

    def to_arrow(self) -> pa.Table:
        return execute_vector_query(self._table, self._req)

    def to_list(self) -> list[dict]:
        return self.to_arrow().to_pylist()
