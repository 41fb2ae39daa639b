"""Reranker base contract (reference python rerankers/base.py:18-224).

A reranker consumes the vector and/or FTS result tables (each carrying
`_rowid` plus `_distance` / `_score`) and emits a fused table sorted by
`_relevance_score` descending.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

DIST_COL = "_distance"
SCORE_COL = "_score"
RELEVANCE_COL = "_relevance_score"
ROW_ID_COL = "_rowid"


def _dedup_keep_first(tbl: pa.Table, key: str = ROW_ID_COL) -> pa.Table:
    ids = tbl.column(key).to_numpy()
    _, first = np.unique(ids, return_index=True)
    return tbl.take(pa.array(np.sort(first)))


class Reranker:
    """Base class; subclasses implement at least rerank_hybrid."""

    def __init__(self, return_score: str = "relevance"):
        if return_score not in ("relevance", "all"):
            raise ValueError("return_score must be 'relevance' or 'all'")
        self.score = return_score

    # --- hooks -----------------------------------------------------------
    def rerank_hybrid(self, query: str, vector_results: pa.Table, fts_results: pa.Table) -> pa.Table:
        raise NotImplementedError

    def rerank_vector(self, query: str, vector_results: pa.Table) -> pa.Table:
        raise NotImplementedError(f"{type(self).__name__} does not support vector-only reranking")

    def rerank_fts(self, query: str, fts_results: pa.Table) -> pa.Table:
        raise NotImplementedError(f"{type(self).__name__} does not support fts-only reranking")

    def rerank_multivector(self, query, vector_results: list[pa.Table]) -> pa.Table:
        merged = self.merge_results(*vector_results) if len(vector_results) > 1 else vector_results[0]
        return self.rerank_vector(query, merged)

    # --- helpers ---------------------------------------------------------
    def merge_results(self, *tables: pa.Table) -> pa.Table:
        """Concatenate result sets, dropping duplicate rows (keep first)."""
        combined = pa.concat_tables(list(tables), promote_options="default")
        return _dedup_keep_first(combined)

    def _keep_score_columns(self, tbl: pa.Table) -> pa.Table:
        if self.score == "relevance":
            drop = [c for c in (DIST_COL, SCORE_COL) if c in tbl.column_names]
            if drop:
                tbl = tbl.drop_columns(drop)
        return tbl


def normalize_scores(scores: np.ndarray, invert: bool = False) -> np.ndarray:
    """Min-max normalize to [0, 1] (reference util in hybrid fusion)."""
    scores = scores.astype(np.float64)
    finite = np.isfinite(scores)
    if not finite.any():
        return np.zeros_like(scores, dtype=np.float32)
    mn, mx = scores[finite].min(), scores[finite].max()
    rng = mx - mn
    if rng == 0:
        out = np.where(finite, 1.0, 0.0)
    else:
        out = np.where(finite, (scores - mn) / rng, 0.0)
    if invert:
        out = 1.0 - out
    return out.astype(np.float32)
