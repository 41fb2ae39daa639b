"""Mean-reciprocal-rank reranker (reference python rerankers MRR):
relevance = mean over result lists of 1/rank (0 when absent)."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from .base import RELEVANCE_COL, ROW_ID_COL, Reranker


class MRRReranker(Reranker):
    def _fuse(self, tables: list[pa.Table]) -> pa.Table:
        lists = []
        for t in tables:
            ids = t.column(ROW_ID_COL).to_numpy() if t.num_rows else np.empty(0, np.uint64)
            lists.append({int(r): i + 1 for i, r in enumerate(ids)})
        all_ids = sorted({rid for l in lists for rid in l})
        scores = {
            rid: float(np.mean([1.0 / l[rid] if rid in l else 0.0 for l in lists]))
            for rid in all_ids
        }
        src = {}
        for t_i, l in enumerate(lists):
            for rid, rank in l.items():
                src.setdefault(rid, (t_i, rank - 1))
        order = sorted(scores.items(), key=lambda kv: -kv[1])
        parts, rel = [], []
        for rid, sc in order:
            t_i, r_i = src[rid]
            parts.append(tables[t_i].slice(r_i, 1))
            rel.append(sc)
        if not parts:
            return tables[0].append_column(RELEVANCE_COL, pa.array([], type=pa.float32()))
        fused = pa.concat_tables(parts, promote_options="default")
        return self._keep_score_columns(
            fused.append_column(RELEVANCE_COL, pa.array(np.asarray(rel, np.float32)))
        )

    def rerank_hybrid(self, query, vector_results, fts_results):
        return self._fuse([vector_results, fts_results])

    def rerank_multivector(self, query, vector_results):
        return self._fuse(vector_results)
