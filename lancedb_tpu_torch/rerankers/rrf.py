"""Reciprocal Rank Fusion (reference rust rerankers/rrf.rs:223 +
python rerankers/rrf.py:15, default K=60)."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from .base import RELEVANCE_COL, ROW_ID_COL, Reranker


class RRFReranker(Reranker):
    """score(d) = Σ_lists 1 / (K + rank_list(d)); rank is 1-based."""

    def __init__(self, K: int = 60, return_score: str = "relevance"):
        super().__init__(return_score)
        if K <= 0:
            raise ValueError("K must be positive")
        self.K = K

    def _fuse(self, tables: list[pa.Table]) -> pa.Table:
        scores: dict[int, float] = {}
        row_sources: dict[int, tuple[int, int]] = {}  # rowid -> (table idx, row idx)
        for t_i, tbl in enumerate(tables):
            if tbl.num_rows == 0:
                continue
            ids = tbl.column(ROW_ID_COL).to_numpy()
            for rank, rid in enumerate(ids, start=1):
                rid = int(rid)
                scores[rid] = scores.get(rid, 0.0) + 1.0 / (self.K + rank)
                row_sources.setdefault(rid, (t_i, rank - 1))
        if not scores:
            base = tables[0]
            return base.append_column(RELEVANCE_COL, pa.array([], type=pa.float32()))
        order = sorted(scores.items(), key=lambda kv: -kv[1])
        picked_parts = []
        rel = []
        for rid, sc in order:
            t_i, r_i = row_sources[rid]
            picked_parts.append(tables[t_i].slice(r_i, 1))
            rel.append(sc)
        fused = pa.concat_tables(picked_parts, promote_options="default")
        fused = fused.append_column(RELEVANCE_COL, pa.array(np.asarray(rel, dtype=np.float32)))
        return self._keep_score_columns(fused)

    def rerank_hybrid(self, query: str, vector_results: pa.Table, fts_results: pa.Table) -> pa.Table:
        return self._fuse([vector_results, fts_results])

    def rerank_multivector(self, query, vector_results: list[pa.Table]) -> pa.Table:
        return self._fuse(vector_results)
