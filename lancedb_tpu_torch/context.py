"""Contextualizer: sliding text windows for RAG chunking.

Reference: python context.py:114 `Contextualizer` — splits documents
into overlapping windows of N tokens with a stride, grouping by a key
column, producing one row per window.
"""

from __future__ import annotations

from typing import Any

import pyarrow as pa

from .errors import InvalidInputError


class Contextualizer:
    """Fluent builder: `contextualize(df).text_col('text').window(20)
    .stride(10).groupby('doc').to_pandas()`."""

    def __init__(self, raw_df):
        self._raw = raw_df
        self._text_col: str | None = None
        self._groupby: str | None = None
        self._window: int | None = None
        self._stride: int | None = None
        self._min_window_size: int = 1

    def window(self, window: int) -> "Contextualizer":
        if window <= 0:
            raise InvalidInputError("window must be positive")
        self._window = window
        return self

    def stride(self, stride: int) -> "Contextualizer":
        if stride <= 0:
            raise InvalidInputError("stride must be positive")
        self._stride = stride
        return self

    def groupby(self, groupby: str) -> "Contextualizer":
        self._groupby = groupby
        return self

    def text_col(self, text_col: str) -> "Contextualizer":
        self._text_col = text_col
        return self

    def min_window_size(self, n: int) -> "Contextualizer":
        self._min_window_size = n
        return self

    def _rows(self) -> list[dict]:
        raw = self._raw
        if isinstance(raw, pa.Table):
            return raw.to_pylist()
        if hasattr(raw, "to_dict"):  # pandas
            return raw.to_dict("records")
        if isinstance(raw, list):
            return raw
        raise InvalidInputError(f"unsupported input {type(raw)}")

    def to_list(self) -> list[dict]:
        if self._text_col is None:
            raise InvalidInputError("text_col is required")
        if self._window is None:
            raise InvalidInputError("window is required")
        stride = self._stride or self._window
        rows = self._rows()
        groups: dict[Any, list[dict]] = {}
        order: list[Any] = []
        for row in rows:
            key = row.get(self._groupby) if self._groupby else None
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(row)
        out: list[dict] = []
        for key in order:
            tokens: list[str] = []
            template = dict(groups[key][-1])
            for row in groups[key]:
                tokens.extend(str(row[self._text_col]).split())
            for start in range(0, max(len(tokens), 1), stride):
                chunk = tokens[start : start + self._window]
                if len(chunk) < self._min_window_size:
                    continue
                r = dict(template)
                r[self._text_col] = " ".join(chunk)
                out.append(r)
                if start + self._window >= len(tokens):
                    break
        return out

    def to_arrow(self) -> pa.Table:
        return pa.Table.from_pylist(self.to_list())

    def to_pandas(self):
        return self.to_arrow().to_pandas()


def contextualize(raw_df) -> Contextualizer:
    """Entry point (reference context.py `contextualize`)."""
    return Contextualizer(raw_df)
