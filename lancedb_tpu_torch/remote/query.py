"""Remote query builder: same fluent surface, serialized to the wire
(reference remote/table.rs query serialization + python remote/table.py)."""

from __future__ import annotations

import numpy as np
import pyarrow as pa


class RemoteQueryBuilder:
    def __init__(self, table, query, vector_column_name=None, query_type="auto", fts_columns=None):
        self._t = table
        self._body: dict = {"k": 10, "prefilter": True}
        if vector_column_name:
            self._body["vector_column"] = vector_column_name
        from ..query_fts import FtsQueryNode

        if query is None:
            self._body["vector"] = []
        elif isinstance(query, str):
            self._body["full_text_query"] = {"query": query, "columns": fts_columns}
            self._body["vector"] = []
        elif isinstance(query, FtsQueryNode):
            # structured AST: serialize to the shared JSON wire shape
            # (query_fts.to_json ↔ server fts_query_from_json)
            self._body["full_text_query"] = {
                "query": query.to_json(), "columns": fts_columns,
            }
            self._body["vector"] = []
        else:
            arr = np.asarray(query, dtype=np.float32)
            self._body["vector"] = arr.tolist()

    def limit(self, k: int):
        self._body["k"] = int(k)
        return self

    def offset(self, n: int):
        self._body["offset"] = int(n)
        return self

    def where(self, predicate, prefilter: bool = True):
        from ..filters.substrait import is_substrait_filter, substrait_to_sql

        if is_substrait_filter(predicate):
            # lower substrait blobs client-side: the wire filter stays SQL
            predicate = substrait_to_sql(predicate)
        cur = self._body.get("filter")
        self._body["filter"] = f"({cur}) AND ({predicate})" if cur else predicate
        self._body["prefilter"] = prefilter
        return self

    filter = where

    def select(self, columns):
        self._body["columns"] = list(columns)
        return self

    def metric(self, m: str):
        self._body["distance_type"] = m
        return self

    distance_type = metric

    def nprobes(self, n: int):
        self._body["nprobes"] = int(n)
        return self

    def minimum_nprobes(self, n: int):
        """Lower bound for adaptive probing (reference minimum_nprobes)."""
        self._body["minimum_nprobes"] = int(n)
        return self

    def maximum_nprobes(self, n: int):
        """Upper bound for adaptive probing (reference maximum_nprobes)."""
        self._body["maximum_nprobes"] = int(n)
        return self

    def ef(self, n: int):
        """HNSW search beam width (reference VectorQuery.ef)."""
        self._body["ef"] = int(n)
        return self

    def refine_factor(self, rf: int):
        self._body["refine_factor"] = int(rf)
        return self

    def distance_range(self, lower_bound=None, upper_bound=None):
        self._body["lower_bound"] = lower_bound
        self._body["upper_bound"] = upper_bound
        return self

    def bypass_vector_index(self):
        self._body["bypass_vector_index"] = True
        return self

    def fast_search(self):
        self._body["fast_search"] = True
        return self

    def with_row_id(self, flag: bool = True):
        self._body["with_row_id"] = flag
        return self

    def to_arrow(self) -> pa.Table:
        return self._t._query(self._body)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_list(self) -> list[dict]:
        return self.to_arrow().to_pylist()
