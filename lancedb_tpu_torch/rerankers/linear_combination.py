"""Linear combination reranker (reference python rerankers/linear_combination.py):
relevance = weight · norm_vector_score + (1 − weight) · norm_fts_score."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from .base import DIST_COL, RELEVANCE_COL, ROW_ID_COL, SCORE_COL, Reranker, normalize_scores


class LinearCombinationReranker(Reranker):
    def __init__(self, weight: float = 0.7, return_score: str = "relevance"):
        super().__init__(return_score)
        if not 0.0 <= weight <= 1.0:
            raise ValueError("weight must be in [0, 1]")
        self.weight = weight

    def rerank_hybrid(self, query: str, vector_results: pa.Table, fts_results: pa.Table) -> pa.Table:
        v_ids = vector_results.column(ROW_ID_COL).to_numpy() if vector_results.num_rows else np.empty(0, np.uint64)
        f_ids = fts_results.column(ROW_ID_COL).to_numpy() if fts_results.num_rows else np.empty(0, np.uint64)
        v_score = (
            normalize_scores(vector_results.column(DIST_COL).to_numpy(), invert=True)
            if vector_results.num_rows
            else np.empty(0, np.float32)
        )
        f_score = (
            normalize_scores(fts_results.column(SCORE_COL).to_numpy())
            if fts_results.num_rows
            else np.empty(0, np.float32)
        )
        rel: dict[int, float] = {}
        src: dict[int, tuple[int, int]] = {}
        for i, rid in enumerate(v_ids):
            rid = int(rid)
            rel[rid] = self.weight * float(v_score[i])
            src[rid] = (0, i)
        for i, rid in enumerate(f_ids):
            rid = int(rid)
            rel[rid] = rel.get(rid, 0.0) + (1.0 - self.weight) * float(f_score[i])
            src.setdefault(rid, (1, i))
        order = sorted(rel.items(), key=lambda kv: -kv[1])
        tables = [vector_results, fts_results]
        parts, scores = [], []
        for rid, sc in order:
            t_i, r_i = src[rid]
            parts.append(tables[t_i].slice(r_i, 1))
            scores.append(sc)
        if not parts:
            return vector_results.append_column(RELEVANCE_COL, pa.array([], type=pa.float32()))
        fused = pa.concat_tables(parts, promote_options="default")
        fused = fused.append_column(RELEVANCE_COL, pa.array(np.asarray(scores, np.float32)))
        return self._keep_score_columns(fused)
