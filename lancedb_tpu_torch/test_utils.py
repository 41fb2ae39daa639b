"""Test helpers (the reference's test_utils.py:96): a deterministic
embedding stub. It salts with Python's ``hash()``, so its vectors differ
between processes; compare two packages' outputs within one process."""

from __future__ import annotations

import numpy as np


class MockTextEmbeddingFunction:
    """Deterministic embedding stub (reference test_utils/embeddings.rs)."""

    def __init__(self, dim: int = 16):
        self._dim = dim
        self.source_column = None

    def ndims(self) -> int:
        return self._dim

    def compute_source_embeddings(self, texts):
        out = np.zeros((len(texts), self._dim), dtype=np.float32)
        for i, t in enumerate(texts):
            h = abs(hash(t or "")) % (2**31)
            rng = np.random.default_rng(h)
            out[i] = rng.standard_normal(self._dim)
        return out

    def compute_query_embeddings(self, query):
        return self.compute_source_embeddings([query])
