"""Full-text query AST (reference python query.py:387-590: MatchQuery,
PhraseQuery, BoostQuery, MultiMatchQuery, BooleanQuery with `&`/`|`
operator overloads)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Union


class Occur(str, Enum):
    SHOULD = "SHOULD"
    MUST = "MUST"
    MUST_NOT = "MUST_NOT"


class Operator(str, Enum):
    AND = "AND"
    OR = "OR"


class FullTextQueryType(str, Enum):
    """Discriminant for structured FTS queries (reference query.py:367)."""

    MATCH = "match"
    MATCH_PHRASE = "match_phrase"
    BOOST = "boost"
    MULTI_MATCH = "multi_match"
    BOOLEAN = "boolean"


class FtsQueryNode:
    def __and__(self, other: "FtsQueryNode") -> "BooleanQuery":
        return BooleanQuery([(Occur.MUST, self), (Occur.MUST, other)])

    def __or__(self, other: "FtsQueryNode") -> "BooleanQuery":
        return BooleanQuery([(Occur.SHOULD, self), (Occur.SHOULD, other)])

    def query_type(self) -> FullTextQueryType:
        """Type tag of this query node (reference query.py:389)."""
        return _QUERY_TYPES[type(self).__name__]

    def to_json(self) -> dict:
        """Wire form of the structured query — the same JSON shape the
        SQL `fts()` source accepts (sql.py _fts_query_from_json) and the
        remote server deserializes, so Python and TypeScript clients
        send identical documents (reference: the serde shape of
        rust/lancedb/src/query.rs FullTextSearchQuery)."""
        raise NotImplementedError


@dataclass
class MatchQuery(FtsQueryNode):
    """Term-bag BM25 match over one column."""

    query: str
    column: str | None = None
    boost: float = 1.0
    fuzziness: int = 0
    max_expansions: int = 50
    operator: Operator = Operator.OR
    prefix_length: int = 0

    def __repr__(self) -> str:
        return f"MatchQuery({self.query!r}, column={self.column})"

    def to_json(self) -> dict:
        return {"match": {
            "query": self.query, "column": self.column, "boost": self.boost,
            "fuzziness": self.fuzziness, "max_expansions": self.max_expansions,
            "operator": self.operator.value
            if isinstance(self.operator, Operator) else self.operator,
            "prefix_length": self.prefix_length,
        }}


@dataclass
class PhraseQuery(FtsQueryNode):
    """Exact phrase with optional slop (requires positions)."""

    query: str
    column: str | None = None
    slop: int = 0

    def __repr__(self) -> str:
        return f'PhraseQuery("{self.query}", column={self.column}, slop={self.slop})'

    def to_json(self) -> dict:
        return {"phrase": {"query": self.query, "column": self.column,
                           "slop": self.slop}}


@dataclass
class BoostQuery(FtsQueryNode):
    """score = positive − negative_boost × negative."""

    positive: FtsQueryNode
    negative: FtsQueryNode
    negative_boost: float = 0.5

    def to_json(self) -> dict:
        return {"boost": {"positive": self.positive.to_json(),
                          "negative": self.negative.to_json(),
                          "negative_boost": self.negative_boost}}


@dataclass
class MultiMatchQuery(FtsQueryNode):
    """Match across several columns, max-combined with per-column boosts."""

    query: str
    columns: list[str]
    boosts: list[float] | None = None
    operator: Operator = Operator.OR

    def __post_init__(self):
        if self.boosts is None:
            self.boosts = [1.0] * len(self.columns)
        if len(self.boosts) != len(self.columns):
            raise ValueError("boosts must match columns")

    def to_json(self) -> dict:
        return {"multi_match": {
            "query": self.query, "columns": list(self.columns),
            "boosts": list(self.boosts),
            "operator": self.operator.value
            if isinstance(self.operator, Operator) else self.operator,
        }}


@dataclass
class BooleanQuery(FtsQueryNode):
    """List of (occur, query) clauses."""

    queries: list[tuple[Occur, FtsQueryNode]] = field(default_factory=list)

    def __and__(self, other: FtsQueryNode) -> "BooleanQuery":
        return BooleanQuery(self.queries + [(Occur.MUST, other)])

    def __or__(self, other: FtsQueryNode) -> "BooleanQuery":
        return BooleanQuery(self.queries + [(Occur.SHOULD, other)])

    def to_json(self) -> dict:
        doc: dict = {"should": [], "must": [], "must_not": []}
        for occur, q in self.queries:
            key = (occur.value if isinstance(occur, Occur) else str(occur))
            doc[key.lower().replace(" ", "_")].append(q.to_json())
        return {"boolean": {k: v for k, v in doc.items() if v}}


_QUERY_TYPES = {
    "MatchQuery": FullTextQueryType.MATCH,
    "PhraseQuery": FullTextQueryType.MATCH_PHRASE,
    "BoostQuery": FullTextQueryType.BOOST,
    "MultiMatchQuery": FullTextQueryType.MULTI_MATCH,
    "BooleanQuery": FullTextQueryType.BOOLEAN,
}

FtsQuery = Union[str, FtsQueryNode]


def fts_query_from_json(doc: dict) -> FtsQueryNode:
    """Inverse of FtsQueryNode.to_json — the shared deserializer for the
    remote /v1 query protocol and the SQL fts() source."""
    if "match" in doc:
        m = doc["match"]
        return MatchQuery(
            m["query"], m.get("column"),
            boost=m.get("boost", 1.0),
            fuzziness=m.get("fuzziness", 0),
            max_expansions=m.get("max_expansions", 50),
            operator=Operator(m.get("operator", "OR")),
            prefix_length=m.get("prefix_length", 0),
        )
    if "phrase" in doc:
        p = doc["phrase"]
        return PhraseQuery(p["query"], p.get("column"), slop=p.get("slop", 0))
    if "boost" in doc:
        b = doc["boost"]
        return BoostQuery(
            fts_query_from_json(b["positive"]), fts_query_from_json(b["negative"]),
            negative_boost=b.get("negative_boost", 0.5),
        )
    if "multi_match" in doc:
        m = doc["multi_match"]
        return MultiMatchQuery(
            m["query"], list(m["columns"]), boosts=m.get("boosts"),
            operator=Operator(m.get("operator", "OR")),
        )
    if "boolean" in doc:
        b = doc["boolean"]
        clauses = []
        for occur_key, occur in (("should", Occur.SHOULD), ("must", Occur.MUST),
                                 ("must_not", Occur.MUST_NOT)):
            for sub in b.get(occur_key, []):
                clauses.append((occur, fts_query_from_json(sub)))
        return BooleanQuery(clauses)
    raise ValueError(f"unsupported fts JSON query: {sorted(doc)}")


def parse_string_query(query: str, columns: list[str] | None) -> FtsQueryNode:
    """A plain string is a MatchQuery; quoted strings become phrases
    (reference python behavior: `"exact phrase"` syntax)."""
    q = query.strip()
    col = columns[0] if columns else None
    if len(q) >= 2 and q[0] == '"' and q[-1] == '"':
        return PhraseQuery(q[1:-1], col)
    if columns and len(columns) > 1:
        return MultiMatchQuery(q, columns)
    return MatchQuery(q, col)
