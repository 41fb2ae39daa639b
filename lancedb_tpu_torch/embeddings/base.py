"""Embedding function contract (reference python embeddings/base.py:16-228
`EmbeddingFunction` / `TextEmbeddingFunction`; rust embeddings.rs:45-57)."""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Any, ClassVar

import numpy as np


class EmbeddingFunction(ABC):
    """Computes source + query embeddings; registered by name."""

    name: ClassVar[str] = ""
    max_retries: int = 7

    def __init__(self, **kwargs):
        self._config = dict(kwargs)
        self.source_column: str | None = kwargs.get("source_column")

    # --- contract --------------------------------------------------------
    @abstractmethod
    def ndims(self) -> int: ...

    @abstractmethod
    def compute_source_embeddings(self, texts: list[Any]) -> np.ndarray: ...

    def compute_query_embeddings(self, query: Any) -> np.ndarray:
        return self.compute_source_embeddings([query])

    # --- retry wrapper (reference base.py *_with_retry) ------------------
    def compute_source_embeddings_with_retry(self, texts, **kw) -> np.ndarray:
        return self._retry(lambda: self.compute_source_embeddings(texts, **kw))

    def compute_query_embeddings_with_retry(self, query, **kw) -> np.ndarray:
        return self._retry(lambda: self.compute_query_embeddings(query, **kw))

    def _retry(self, fn):
        delay = 0.5
        for attempt in range(self.max_retries):
            try:
                return fn()
            except Exception:
                if attempt == self.max_retries - 1:
                    raise
                time.sleep(min(delay, 8.0))
                delay *= 2
        raise RuntimeError("unreachable")

    @classmethod
    def sensitive_keys(cls) -> list[str]:
        """Config keys that must never be persisted as hardcoded values
        (reference embeddings/base.py:89): the registry rejects them at
        create() unless supplied as '$var:' references."""
        return []

    # --- pydantic field markers (reference embeddings/base.py:176-188) ---
    def SourceField(self, **kwargs):
        """pydantic Field marking the column this function embeds FROM —
        pair with VectorField on a LanceModel passed as create_table's
        schema and source rows embed automatically on add()."""
        from pydantic import Field

        return Field(json_schema_extra={"source_column_for": self}, **kwargs)

    def VectorField(self, **kwargs):
        """pydantic Field marking the vector column this function
        embeds INTO (typed `Vector(fn.ndims())` on the model)."""
        from pydantic import Field

        return Field(json_schema_extra={"vector_column_for": self}, **kwargs)

    # --- config ser/de ---------------------------------------------------
    def safe_model_dump(self) -> dict:
        """JSON-safe config for persistence into table metadata.

        Refuses hardcoded sensitive values: the registry's create()
        rejects them up front, but a directly-instantiated function
        (``OpenAI(api_key='sk-...')``) would otherwise leak the key
        into schema metadata through SourceField/VectorField or
        EmbeddingFunctionConfig (reference raises in safe_model_dump
        when the instance was not created via create())."""
        cfg = {k: v for k, v in self._config.items() if _json_safe(v)}
        for k in type(self).sensitive_keys():
            v = cfg.get(k)
            if isinstance(v, str) and not v.startswith("$var:"):
                from ..errors import InvalidInputError

                raise InvalidInputError(
                    f"refusing to persist hardcoded sensitive config {k!r} "
                    f"for {type(self).name or type(self).__name__}: pass it "
                    f"as a '$var:name' reference (get_registry().set_var) or "
                    f"rely on the provider's environment variable"
                )
        return cfg


def _json_safe(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict))


class TextEmbeddingFunction(EmbeddingFunction):
    """Text in → vector out convenience base."""

    def compute_source_embeddings(self, texts: list[str]) -> np.ndarray:
        return self.generate_embeddings([t if t is not None else "" for t in texts])

    @abstractmethod
    def generate_embeddings(self, texts: list[str]) -> np.ndarray: ...
