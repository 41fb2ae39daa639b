"""Hosted-API rerankers (reference rerankers/: cohere.py, jinaai.py,
voyageai.py, openai.py, watsonx.py).

Each scores (query, document) pairs through a provider's rerank
endpoint and re-orders the merged result set by `_relevance_score`.
Stdlib urllib only; every provider takes ``base_url`` so tests point at
a mock (exactly the embeddings rest_providers.py pattern). API keys
resolve from env at call time, so offline construction is fine.
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import pyarrow as pa

from ..errors import InvalidInputError
from .base import RELEVANCE_COL, Reranker


class _RestReranker(Reranker):
    default_base_url = ""
    api_key_env = ""
    default_model = ""

    def __init__(
        self,
        model_name: str | None = None,
        column: str = "text",
        top_n: int | None = None,
        api_key: str | None = None,
        base_url: str | None = None,
        return_score: str = "relevance",
    ):
        super().__init__(return_score)
        self.model = model_name or self.default_model
        self.column = column
        self.top_n = top_n
        self._api_key = api_key
        self.base_url = (base_url or self.default_base_url).rstrip("/")

    def _key(self) -> str:
        key = self._api_key or os.environ.get(self.api_key_env, "")
        if not key and self.api_key_env:
            raise InvalidInputError(
                f"{type(self).__name__} needs an API key: pass api_key= or set "
                f"${self.api_key_env}"
            )
        return key

    def _post(self, path: str, body: dict, headers: dict | None = None) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(body).encode(),
            method="POST",
            headers={"content-type": "application/json", **(headers or {})},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    # provider hook: (query, docs) -> per-doc relevance scores
    def _rerank_scores(self, query: str, docs: list[str]) -> np.ndarray:
        raise NotImplementedError

    def _score(self, query: str, tbl: pa.Table) -> pa.Table:
        docs = ["" if d is None else str(d) for d in tbl.column(self.column).to_pylist()]
        scores = np.asarray(self._rerank_scores(query, docs), dtype=np.float32)
        tbl = tbl.append_column(RELEVANCE_COL, pa.array(scores))
        order = np.argsort(-scores)
        if self.top_n is not None:
            order = order[: self.top_n]
        return self._keep_score_columns(tbl.take(pa.array(order)))

    def rerank_hybrid(self, query, vector_results, fts_results):
        return self._score(query, self.merge_results(vector_results, fts_results))

    def rerank_vector(self, query, vector_results):
        return self._score(query, vector_results)

    def rerank_fts(self, query, fts_results):
        return self._score(query, fts_results)

    # shared shape: POST /rerank -> {results: [{index, relevance_score}]}
    def _standard_rerank(self, path: str, query: str, docs: list[str],
                         headers: dict) -> np.ndarray:
        r = self._post(
            path,
            {"model": self.model, "query": query, "documents": docs,
             "top_n": len(docs)},
            headers,
        )
        out = np.zeros(len(docs), dtype=np.float32)
        for item in r["results"]:
            out[item["index"]] = item["relevance_score"]
        return out


class CohereReranker(_RestReranker):
    """POST {base}/v2/rerank (reference rerankers/cohere.py)."""

    default_base_url = "https://api.cohere.com"
    api_key_env = "COHERE_API_KEY"
    default_model = "rerank-v3.5"

    def _rerank_scores(self, query, docs):
        return self._standard_rerank(
            "/v2/rerank", query, docs, {"authorization": f"Bearer {self._key()}"}
        )


class JinaReranker(_RestReranker):
    """POST {base}/v1/rerank (reference rerankers/jinaai.py)."""

    default_base_url = "https://api.jina.ai"
    api_key_env = "JINA_API_KEY"
    default_model = "jina-reranker-v2-base-multilingual"

    def _rerank_scores(self, query, docs):
        return self._standard_rerank(
            "/v1/rerank", query, docs, {"authorization": f"Bearer {self._key()}"}
        )


class VoyageaiReranker(_RestReranker):
    """POST {base}/v1/rerank (reference rerankers/voyageai.py)."""

    default_base_url = "https://api.voyageai.com"
    api_key_env = "VOYAGE_API_KEY"
    default_model = "rerank-2"

    def _rerank_scores(self, query, docs):
        return self._standard_rerank(
            "/v1/rerank", query, docs, {"authorization": f"Bearer {self._key()}"}
        )


class WatsonxReranker(_RestReranker):
    """IBM watsonx.ai rerank: IAM apikey→token exchange then
    POST /ml/v1/text/rerank (reference rerankers/watsonx.py)."""

    default_base_url = "https://us-south.ml.cloud.ibm.com"
    api_key_env = "WATSONX_API_KEY"
    default_model = "cross-encoder/ms-marco-minilm-l-12-v2"

    def __init__(self, *args, project_id: str | None = None,
                 iam_url: str = "https://iam.cloud.ibm.com", **kwargs):
        super().__init__(*args, **kwargs)
        self.project_id = project_id or os.environ.get("WATSONX_PROJECT_ID")
        if not self.project_id:
            raise InvalidInputError("watsonx reranker needs project_id=")
        from ..embeddings.rest_providers import IamTokenCache

        self.iam_url = iam_url.rstrip("/")
        self._iam = IamTokenCache(self.iam_url)

    def _bearer(self) -> str:
        return self._iam.bearer(self._key())

    def _rerank_scores(self, query, docs):
        r = self._post(
            "/ml/v1/text/rerank?version=2024-05-02",
            {
                "model_id": self.model,
                "query": query,
                "inputs": [{"text": d} for d in docs],
                "project_id": self.project_id,
            },
            {"authorization": f"Bearer {self._bearer()}"},
        )
        out = np.zeros(len(docs), dtype=np.float32)
        for item in r["results"]:
            out[item["index"]] = item["score"]
        return out


class OpenaiReranker(_RestReranker):
    """LLM listwise reranking through chat completions (reference
    rerankers/openai.py): one request asks the model to order the
    documents by relevance; ranks map to descending scores."""

    default_base_url = "https://api.openai.com"
    api_key_env = "OPENAI_API_KEY"
    default_model = "gpt-4o-mini"

    def _rerank_scores(self, query, docs):
        numbered = "\n".join(f"[{i}] {d[:500]}" for i, d in enumerate(docs))
        prompt = (
            "Rank these documents by relevance to the query. Reply with ONLY "
            "a JSON array of document indices, most relevant first.\n"
            f"Query: {query}\nDocuments:\n{numbered}"
        )
        r = self._post(
            "/v1/chat/completions",
            {
                "model": self.model,
                "messages": [{"role": "user", "content": prompt}],
                "temperature": 0,
            },
            {"authorization": f"Bearer {self._key()}"},
        )
        text = r["choices"][0]["message"]["content"]
        start, end = text.find("["), text.rfind("]")
        order = json.loads(text[start : end + 1])
        scores = np.zeros(len(docs), dtype=np.float32)
        for rank, idx in enumerate(order):
            if 0 <= int(idx) < len(docs):
                scores[int(idx)] = float(len(docs) - rank)
        return scores
