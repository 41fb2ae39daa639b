"""Model-based rerankers.

Upstream ships 13 reranker impls (python rerankers/). The local-model
ones work here when weights exist on disk, on the reranker's device
(None: the card); without their package or weights they raise as the
reference's do.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..ops.util import resolve_device
from .base import RELEVANCE_COL, Reranker


class CrossEncoderReranker(Reranker):
    """sentence-transformers CrossEncoder scoring (reference
    rerankers/cross_encoder.py). Needs local model weights."""

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-TinyBERT-L-6",
        column: str = "text",
        device=None,
        return_score: str = "relevance",
    ):
        super().__init__(return_score)
        self.column = column
        try:
            from sentence_transformers import CrossEncoder
        except Exception as e:  # pragma: no cover - env dependent
            raise RuntimeError(
                f"CrossEncoder model {model_name!r} unavailable "
                f"(no network; provide local weights): {e}"
            ) from None
        dev = resolve_device(device)
        try:
            self._model = CrossEncoder(model_name, device=str(dev))
        except Exception as e:  # pragma: no cover - env dependent
            raise RuntimeError(
                f"CrossEncoder model {model_name!r} unavailable "
                f"(no network; provide local weights): {e}"
            ) from None

    def _score(self, query: str, tbl: pa.Table) -> pa.Table:
        docs = tbl.column(self.column).to_pylist()
        scores = np.asarray(self._model.predict([(query, d or "") for d in docs]))
        tbl = tbl.append_column(RELEVANCE_COL, pa.array(scores.astype(np.float32)))
        order = np.argsort(-scores)
        return self._keep_score_columns(tbl.take(pa.array(order)))

    def rerank_hybrid(self, query, vector_results, fts_results):
        return self._score(query, self.merge_results(vector_results, fts_results))

    def rerank_vector(self, query, vector_results):
        return self._score(query, vector_results)

    def rerank_fts(self, query, fts_results):
        return self._score(query, fts_results)


class AnswerdotaiRerankers(Reranker):  # pragma: no cover - package-gated
    """Wraps the answerdotai `rerankers` package (reference
    rerankers/answerdotai.py). Package-gated: the models only ship
    through that library."""

    def __init__(self, model_type: str = "colbert", model_name: str | None = None,
                 column: str = "text", return_score: str = "relevance", **kwargs):
        super().__init__(return_score)
        try:
            from rerankers import Reranker as _AR  # type: ignore
        except ImportError as exc:
            raise RuntimeError(
                "AnswerdotaiRerankers needs the `rerankers` package "
                "(pip install rerankers)"
            ) from exc
        self.column = column
        self._inner = _AR(model_name or model_type, model_type=model_type, **kwargs)

    def rerank_hybrid(self, query, vector_results, fts_results):
        import numpy as np

        from .base import RELEVANCE_COL

        tbl = self.merge_results(vector_results, fts_results)
        docs = ["" if d is None else str(d) for d in tbl.column(self.column).to_pylist()]
        ranked = self._inner.rank(query=query, docs=docs)
        scores = np.zeros(len(docs), dtype=np.float32)
        for r in ranked.results:
            scores[r.doc_id] = r.score
        tbl = tbl.append_column(RELEVANCE_COL, pa.array(scores))
        order = np.argsort(-scores)
        return self._keep_score_columns(tbl.take(pa.array(order)))
