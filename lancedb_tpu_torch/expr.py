"""Typed expression DSL for filters and projections.

Reference: rust expr.rs:1-40 (`col()`, `lit()`, comparison/boolean/
arithmetic/string ops, `expr_to_sql_string` lowering) and python
expr.py. Builds the same AST the SQL parser produces, so every sink
(scan filters, prefilter masks, update expressions) accepts either.

    from lancedb_tpu_torch.expr import col, lit
    tbl.search(q).where(((col("price") > 10) & col("label").is_in(["a"])).sql())
"""

from __future__ import annotations

from typing import Any

from .filters.sql import Between, BinaryOp, Column, Expr as _AstExpr, FunctionCall, Literal, UnaryOp


class Expr:
    """Wrapper adding python operator overloads over the filter AST."""

    def __init__(self, node: _AstExpr):
        self.node = node

    # ---- comparisons ----
    def _bin(self, op: str, other) -> "Expr":
        return Expr(BinaryOp(op, self.node, _wrap(other).node))

    def __eq__(self, other) -> "Expr":  # type: ignore[override]
        return self._bin("eq", other)

    def __ne__(self, other) -> "Expr":  # type: ignore[override]
        return self._bin("ne", other)

    def __lt__(self, other) -> "Expr":
        return self._bin("lt", other)

    def __le__(self, other) -> "Expr":
        return self._bin("le", other)

    def __gt__(self, other) -> "Expr":
        return self._bin("gt", other)

    def __ge__(self, other) -> "Expr":
        return self._bin("ge", other)

    # ---- boolean ----
    def __and__(self, other) -> "Expr":
        return self._bin("and", other)

    def __or__(self, other) -> "Expr":
        return self._bin("or", other)

    def __invert__(self) -> "Expr":
        return Expr(UnaryOp("not", self.node))

    # ---- arithmetic ----
    def __add__(self, other) -> "Expr":
        return self._bin("add", other)

    def __sub__(self, other) -> "Expr":
        return self._bin("sub", other)

    def __mul__(self, other) -> "Expr":
        return self._bin("mul", other)

    def __truediv__(self, other) -> "Expr":
        return self._bin("div", other)

    def __mod__(self, other) -> "Expr":
        return self._bin("mod", other)

    def __neg__(self) -> "Expr":
        return Expr(UnaryOp("neg", self.node))

    # ---- predicates ----
    def is_null(self) -> "Expr":
        return Expr(UnaryOp("is_null", self.node))

    def is_not_null(self) -> "Expr":
        return Expr(UnaryOp("is_not_null", self.node))

    def is_in(self, values: list) -> "Expr":
        return Expr(BinaryOp("in", self.node, Literal(list(values))))

    def not_in(self, values: list) -> "Expr":
        return Expr(BinaryOp("not_in", self.node, Literal(list(values))))

    def between(self, low, high) -> "Expr":
        return Expr(Between(self.node, _wrap(low).node, _wrap(high).node))

    def like(self, pattern: str) -> "Expr":
        return self._bin("like", pattern)

    def not_like(self, pattern: str) -> "Expr":
        return self._bin("not_like", pattern)

    # ---- string functions ----
    def lower(self) -> "Expr":
        return Expr(FunctionCall("lower", (self.node,)))

    def upper(self) -> "Expr":
        return Expr(FunctionCall("upper", (self.node,)))

    def length(self) -> "Expr":
        return Expr(FunctionCall("length", (self.node,)))

    def contains(self, sub: str) -> "Expr":
        return Expr(FunctionCall("contains", (self.node, Literal(sub))))

    def starts_with(self, prefix: str) -> "Expr":
        return Expr(FunctionCall("starts_with", (self.node, Literal(prefix))))

    def ends_with(self, suffix: str) -> "Expr":
        return Expr(FunctionCall("ends_with", (self.node, Literal(suffix))))

    # ---- math ----
    def abs(self) -> "Expr":
        return Expr(FunctionCall("abs", (self.node,)))

    def round(self, ndigits: int = 0) -> "Expr":
        return Expr(FunctionCall("round", (self.node, Literal(ndigits))))

    # ---- lowering ----
    def sql(self) -> str:
        """Lower to SQL text (reference expr_to_sql_string)."""
        return self.node.sql()

    def __repr__(self) -> str:
        return f"Expr({self.sql()})"

    __hash__ = None  # type: ignore[assignment]


def _wrap(v: Any) -> Expr:
    if isinstance(v, Expr):
        return v
    return Expr(Literal(v))


def col(name: str) -> Expr:
    """Case-preserving column reference (reference expr.rs `col`)."""
    return Expr(Column(name))


def lit(value: Any) -> Expr:
    """Literal value (reference expr.rs `lit`)."""
    return Expr(Literal(value))


def expr_to_sql_string(e: Expr | _AstExpr) -> str:
    return e.sql() if isinstance(e, Expr) else e.sql()
