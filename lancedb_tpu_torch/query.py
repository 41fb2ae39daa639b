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
  4. distance range on the host, then hydrate the selected columns with
     take_rows, append _distance; postfilter and offset apply to the rows

Full-text search runs the BM25 index on the host (index/fts.py). A hybrid
search runs its full-text legs on host threads while the calling thread
runs the vector legs (every CUDA call stays on it), then fuses each pair
with a reranker (RRF by default).

A multivector column is searched by late interaction
(index/multivector.py). Plain scans, plan explanation and text queries
that need an embedding function wait for later slices (ROADMAP A4, A12).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np
import pyarrow as pa

from ._surface import NotPortedSurface
from .arrow import fsl_to_numpy, is_multivector_type, vector_column_name
from .errors import InvalidInputError
from .filters.eval import evaluate_predicate_mask
from .filters.sql import parse_sql_expr
from .index.vector import SearchParams, brute_force_search
from .ops.distance import normalize_metric
from .rerankers.base import RELEVANCE_COL, SCORE_COL
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
    select: list[str] | None = None
    with_row_id: bool = False


def execute_vector_query(table, req: VectorQueryRequest) -> pa.Table:
    """Run one (or a batch of) vector queries → Arrow result table."""
    ds = table._dataset
    column = req.column or vector_column_name(ds.schema)
    if not req.query_vectors:
        raise InvalidInputError("no query vector provided")
    if column in ds.schema.names and is_multivector_type(ds.schema.field(column).type):
        return _execute_multivector_query(table, req, column)
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

    # ---- prefilter -------------------------------------------------------
    allowed: np.ndarray | None = None
    if req.filter is not None and req.prefilter:
        allowed = compute_allowed_rowids(table, req.filter)
        if len(allowed) == 0:
            return _empty_result(table, req, multi)
    k_search = req.k + req.offset

    # ---- search ----------------------------------------------------------
    if searcher is None:
        dists, rowids = _brute_force_fragments(
            table, column, queries, req, k_search, metric, frags=ds.manifest.fragments
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
            params = SearchParams(k=k_search, nprobes=nprobes, refine_factor=req.refine_factor,
                                  ef=req.ef, precision=req.precision)
            d, r = searcher.search(queries, params, slot_penalty=pen)
            if req.refine_factor is not None and not searcher.will_fuse_refine(params):
                d, r = searcher.refine(ds, column, queries, d, r, k_search)
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
        if delta and not req.fast_search:
            d2, r2 = _brute_force_fragments(table, column, queries, req, k_search, metric, delta)
            dists, rowids = _merge_host(dists, rowids, d2, r2, k_search)

    # ---- distance range: lower bound inclusive, upper bound exclusive ----
    if req.lower_bound is not None:
        dists = np.where(dists >= req.lower_bound, dists, np.inf)
    if req.upper_bound is not None:
        dists = np.where(dists < req.upper_bound, dists, np.inf)
    rowids = np.where(np.isfinite(dists), rowids, _INVALID_ROWID)
    out = _hydrate_results(table, req, dists, rowids, multi)
    return _postfilter_and_offset(out, req, len(req.query_vectors) if multi else 0)


def _postfilter_and_offset(out: pa.Table, req: VectorQueryRequest, nq_multi: int) -> pa.Table:
    """The filter on the hydrated rows when it is a postfilter, then each
    query's rows ``offset`` to ``offset + k`` (split by query_index for a
    batch of ``nq_multi`` queries)."""
    if req.filter is not None and not req.prefilter and out.num_rows:
        out = out.filter(pa.array(evaluate_predicate_mask(out, req.filter)))
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


def _hydrate_results(table, req, dists, rowids, multi) -> pa.Table:
    ds = table._dataset
    parts = []
    for qi in range(dists.shape[0]):
        valid = rowids[qi] != _INVALID_ROWID
        rid = rowids[qi][valid]
        data = ds.take_rows(rid, columns=req.select)
        data = data.append_column(DIST_COL, pa.array(dists[qi][valid].astype(np.float32)))
        if req.with_row_id:
            data = data.append_column(ROW_ID_COL, pa.array(rid, type=pa.uint64()))
        if multi:
            data = data.append_column(
                QUERY_INDEX_COL, pa.array(np.full(len(rid), qi, dtype=np.int32))
            )
        parts.append(data)
    return pa.concat_tables(parts)


def _empty_result(table, req, multi) -> pa.Table:
    fields = [f for f in table._dataset.schema if req.select is None or f.name in req.select]
    fields.append(pa.field(DIST_COL, pa.float32()))
    if req.with_row_id:
        fields.append(pa.field(ROW_ID_COL, pa.uint64()))
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


class LanceQueryBuilder(NotPortedSurface):
    """Fluent builder base (reference query.py LanceQueryBuilder): the
    setters every search kind shares, and the dispatch on query type."""

    _NOT_PORTED = dict.fromkeys(
        ("with_row_address", "filter", "order_by", "fragment_ids",
         "with_fragments", "to_batches", "to_pandas", "to_polars", "to_df", "to_table",
         "to_pyarrow", "to_json", "to_reader", "to_pydantic", "output_schema",
         "to_query_object", "explain_plan", "analyze_plan"),
        "A4",
    )

    def __init__(self, table):
        self._table = table
        self._req = VectorQueryRequest()

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

    def postfilter(self) -> "LanceQueryBuilder":
        """Apply the filter AFTER the search (reference postfilter())."""
        self._req.prefilter = False
        return self

    def offset(self, n: int) -> "LanceQueryBuilder":
        """Skip each query's first ``n`` results (a hybrid search ignores
        it, as the reference's does)."""
        self._req.offset = int(n)
        return self

    def select(self, columns: list[str]) -> "LanceQueryBuilder":
        if isinstance(columns, dict):
            raise NotImplementedError(
                "SQL projections in select() are not ported to lancedb_tpu_torch yet (ROADMAP A4)"
            )
        self._req.select = list(columns)
        return self

    def limit(self, k: int) -> "LanceQueryBuilder":
        if k is None or k <= 0:
            raise ValueError("Limit is required for ANN/KNN queries")
        self._req.k = int(k)
        return self

    def with_row_id(self, flag: bool = True) -> "LanceQueryBuilder":
        """Add the ``_rowid`` column (the row address) to the results."""
        self._req.with_row_id = flag
        return self

    def to_list(self) -> list[dict]:
        return self.to_arrow().to_pylist()

    @staticmethod
    def create(table, query, query_type: str = "auto", vector_column_name: str | None = None,
               fts_columns: list[str] | None = None) -> "LanceQueryBuilder":
        """Dispatch on the query's type (reference query.py:782-825): a
        (vector, text) pair or query_type "hybrid" → hybrid; a string or
        an FTS query node → full text; anything else → vector."""
        from .query_fts import FtsQueryNode

        if query is None:
            raise NotImplementedError(
                "plain scans (search(None)) are not ported to lancedb_tpu_torch yet (ROADMAP A4)"
            )
        if query_type == "hybrid" or (
            query_type == "auto" and isinstance(query, tuple) and len(query) == 2
        ):
            vec, text = query if isinstance(query, tuple) else (None, query)
            return LanceHybridQueryBuilder(table, text, vec, vector_column_name, fts_columns)
        if isinstance(query, str):
            if query_type in ("auto", "fts"):
                # the reference embeds a string through the table's embedding
                # function when the table has one and no FTS index; the port
                # has no embedding functions, so a string is full text
                return LanceFtsQueryBuilder(table, query, fts_columns)
            if query_type == "vector":
                return LanceVectorQueryBuilder(table, table._embed_query(query), vector_column_name)
            raise InvalidInputError(f"unknown query_type {query_type!r}")
        if isinstance(query, FtsQueryNode):
            return LanceFtsQueryBuilder(table, query, fts_columns)
        return LanceVectorQueryBuilder(table, query, vector_column_name)


class LanceVectorQueryBuilder(LanceQueryBuilder):
    """Vector (ANN/KNN) search builder (reference query.py:1559)."""

    _NOT_PORTED = {
        **LanceQueryBuilder._NOT_PORTED,
        **dict.fromkeys(("vector", "column"), "A4"),
        "use_lsm": "A12",
    }

    def __init__(self, table, query, vector_column_name: str | None = None):
        super().__init__(table)
        self._req.column = vector_column_name
        self._req.query_vectors = _coerce_query_vectors(query)
        self._reranker = None

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
        if self._reranker is None:
            return execute_vector_query(self._table, self._req)
        out = execute_vector_query(self._table, replace(self._req, with_row_id=True))
        out = self._reranker.rerank_vector("", out).slice(0, self._req.k)
        if not self._req.with_row_id and ROW_ID_COL in out.column_names:
            out = out.drop_columns([ROW_ID_COL])
        return out


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

    def phrase_query(self, flag: bool = True) -> "LanceFtsQueryBuilder":
        """Treat the query text as an exact phrase."""
        if flag and isinstance(self._query, str):
            from .query_fts import PhraseQuery

            self._query = PhraseQuery(self._query, column=None)
        return self

    def to_arrow(self) -> pa.Table:
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
        return out


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
        fts = LanceFtsQueryBuilder(self._table, text_query, self._fts_columns)
        fts._req.filter = self._req.filter
        fts._req.prefilter = self._req.prefilter
        fts._req.k = self._req.k
        fts._req.with_row_id = True
        return fts.to_arrow()

    def _keep_selected(self, out: pa.Table, extra=()) -> pa.Table:
        if not self._req.with_row_id and ROW_ID_COL in out.column_names:
            out = out.drop_columns([ROW_ID_COL])
        if self._req.select is not None:
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
                vec = self._table._embed_query(txt)
            vectors.append(np.asarray(vec, dtype=np.float32).reshape(-1))
            texts.append(txt)
        k = self._req.k
        vq = self._vector_leg(np.stack(vectors))
        with ThreadPoolExecutor(max_workers=min(8, len(texts)),
                                thread_name_prefix="hybrid-fts") as ex:
            fts_futures = [ex.submit(self._fts_leg, t) for t in texts]
            vector_all = vq.to_arrow()
            fts_results = [f.result() for f in fts_futures]

        reranker = self._reranker or RRFReranker()
        qidx = vector_all.column(QUERY_INDEX_COL).to_numpy(zero_copy_only=False)
        parts = []
        for qi, (txt, fts_res) in enumerate(zip(texts, fts_results)):
            vres = vector_all.filter(pa.array(qidx == qi)).drop_columns([QUERY_INDEX_COL])
            fused = reranker.rerank_hybrid(str(txt), vres, fts_res).slice(0, k)
            fused = fused.append_column(
                QUERY_INDEX_COL, pa.array(np.full(len(fused), qi, dtype=np.int32))
            )
            parts.append(fused)
        out = pa.concat_tables(parts, promote_options="permissive")
        return self._keep_selected(out, (QUERY_INDEX_COL,))

    def to_arrow(self) -> pa.Table:
        from .rerankers.rrf import RRFReranker

        if self._extra_queries:
            return self._to_arrow_batched()
        if self._vector is None:
            self._vector = self._table._embed_query(self._text_query)
        vq = self._vector_leg(self._vector)
        # the FTS leg (host) overlaps the vector leg's device work
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="hybrid-fts") as ex:
            fts_future = ex.submit(self._fts_leg, self._text_query)
            vector_results = vq.to_arrow()
            fts_results = fts_future.result()
        reranker = self._reranker or RRFReranker()
        fused = reranker.rerank_hybrid(str(self._text_query), vector_results, fts_results)
        return self._keep_selected(fused.slice(0, self._req.k))
