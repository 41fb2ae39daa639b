"""ColBERT late-interaction reranker (reference rerankers/colbert.py —
upstream via the answerdotai `rerankers` package; here the token
encoding runs through transformers and the MaxSim scoring reuses the
multivector machinery, index/multivector.py), on the reranker's device:
None is the card, and scoring raises without one.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..ops.util import resolve_device
from .base import RELEVANCE_COL, Reranker


class ColbertReranker(Reranker):
    """Token-level MaxSim scoring: score(q, d) = Σ_i max_j q_i·d_j over
    normalized token embeddings. Model weights load lazily through
    transformers (weight-gated offline) onto ``device``; ``_encode`` is
    the override seam for tests/custom encoders. The product runs on
    ``device`` (``maxsim_rescore``)."""

    def __init__(
        self,
        model_name: str = "colbert-ir/colbertv2.0",
        column: str = "text",
        return_score: str = "relevance",
        batch_size: int = 16,
        device=None,
    ):
        super().__init__(return_score)
        self.model_name = model_name
        self.column = column
        self.batch_size = batch_size
        self.device = device
        self._model = None
        self._tok = None

    def _load(self):
        if self._model is None:
            from transformers import AutoModel, AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(self.model_name)
            self._model = AutoModel.from_pretrained(self.model_name).to(
                resolve_device(self.device))

    def _encode(self, texts: list[str]) -> list[np.ndarray]:
        """Per-text (n_tokens, dim) normalized token embeddings."""
        import torch

        self._load()
        out: list[np.ndarray] = []
        for s in range(0, len(texts), self.batch_size):
            chunk = texts[s : s + self.batch_size]
            enc = self._tok(chunk, padding=True, truncation=True, return_tensors="pt")
            enc = {k: v.to(self._model.device) for k, v in enc.items()}
            with torch.no_grad():
                hidden = self._model(**enc).last_hidden_state  # (b, t, d)
            for i in range(len(chunk)):
                mask = enc["attention_mask"][i].bool()
                e = hidden[i][mask].float().cpu().numpy()
                norms = np.linalg.norm(e, axis=1, keepdims=True)
                out.append(e / np.maximum(norms, 1e-30))
        return out

    def _score(self, query: str, tbl: pa.Table) -> pa.Table:
        from ..index.multivector import maxsim_rescore

        docs = ["" if d is None else str(d) for d in tbl.column(self.column).to_pylist()]
        qtok = self._encode([query])[0]
        dtoks = self._encode(docs)
        scores = maxsim_rescore(qtok, dtoks, device=self.device).astype(np.float32)
        tbl = tbl.append_column(RELEVANCE_COL, pa.array(scores))
        order = np.argsort(-scores)
        return self._keep_score_columns(tbl.take(pa.array(order)))

    def rerank_hybrid(self, query, vector_results, fts_results):
        return self._score(query, self.merge_results(vector_results, fts_results))

    def rerank_vector(self, query, vector_results):
        return self._score(query, vector_results)

    def rerank_fts(self, query, fts_results):
        return self._score(query, fts_results)
