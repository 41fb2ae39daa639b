"""Built-in embedding providers.

The reference ships 19 providers (python embeddings/: openai, cohere,
sentence_transformers, …). In this zero-egress environment remote APIs
and model downloads are unavailable, so:

* providers that need the network register but raise a clear error at
  creation unless their client/key is actually usable;
* `HashEmbedding` is a deterministic, dependency-free local embedder —
  the test/demo workhorse (analogous to the reference's MockTextEmbeddingFunction
  in test_utils/embeddings.rs);
* `SentenceTransformersEmbedding`/`TransformersEmbedding` work when
  local model weights are present on disk.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .base import TextEmbeddingFunction
from .registry import EmbeddingFunctionRegistry

registry = EmbeddingFunctionRegistry.get_instance()


@registry.register("hash")
class HashEmbedding(TextEmbeddingFunction):
    """Deterministic hashing embedder: token n-gram hashing into a fixed
    number of buckets, l2-normalized. No model weights, stable across
    processes — similar texts share buckets so ANN behavior is sane."""

    def __init__(self, dim: int = 256, ngram: int = 3, **kwargs):
        super().__init__(dim=dim, ngram=ngram, **kwargs)
        self._dim = dim
        self._ngram = ngram

    def ndims(self) -> int:
        return self._dim

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self._dim), dtype=np.float32)
        for i, text in enumerate(texts):
            t = (text or "").lower()
            for w in t.split():
                chunks = [w] + [w[j : j + self._ngram] for j in range(max(1, len(w) - self._ngram + 1))]
                for c in chunks:
                    h = int.from_bytes(hashlib.md5(c.encode()).digest()[:8], "little")
                    out[i, h % self._dim] += 1.0 if (h >> 63) else -1.0
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out


@registry.register("sentence-transformers")
class SentenceTransformersEmbedding(TextEmbeddingFunction):
    """Local sentence-transformers model (requires weights on disk)."""

    def __init__(self, name: str = "all-MiniLM-L6-v2", device: str = "cpu", **kwargs):
        super().__init__(name=name, device=device, **kwargs)
        try:
            from sentence_transformers import SentenceTransformer

            self._model = SentenceTransformer(name, device=device)
        except Exception as e:  # pragma: no cover - environment dependent
            raise RuntimeError(
                f"sentence-transformers model {name!r} unavailable "
                f"(no network access; provide local weights): {e}"
            ) from None

    def ndims(self) -> int:
        return self._model.get_sentence_embedding_dimension()

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        return np.asarray(self._model.encode(texts, convert_to_numpy=True))


@registry.register("huggingface")
class TransformersEmbedding(TextEmbeddingFunction):
    """Local HF transformers encoder with mean pooling."""

    def __init__(self, name: str = "bert-base-uncased", device: str = "cpu", **kwargs):
        super().__init__(name=name, device=device, **kwargs)
        try:
            import torch  # noqa: F401
            from transformers import AutoModel, AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
            self._model = AutoModel.from_pretrained(name, local_files_only=True)
        except Exception as e:  # pragma: no cover
            raise RuntimeError(
                f"transformers model {name!r} unavailable locally: {e}"
            ) from None

    def ndims(self) -> int:
        return self._model.config.hidden_size

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        import torch

        with torch.no_grad():
            enc = self._tok(texts, padding=True, truncation=True, return_tensors="pt")
            out = self._model(**enc).last_hidden_state
            mask = enc["attention_mask"].unsqueeze(-1)
            emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
        return emb.numpy()


# hosted REST providers live in rest_providers.py (openai, cohere,
# gemini-text, voyageai, jinaai, ollama, bedrock-text, watsonx);
# multimodal/multi-vector local-model providers in multimodal.py
# (colpali, open-clip, siglip, gte-text, instructor, imagebind)
