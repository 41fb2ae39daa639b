"""Substrait filter ingestion.

The reference's ``QueryFilter`` accepts SQL | Substrait | Datafusion
(rust/lancedb/src/query.rs:792-812); this module accepts a
substrait-encoded ExtendedExpression blob (what
``pyarrow.substrait.serialize_expressions`` produces) and lowers it to
the engine's SQL filter dialect, so everything downstream — scalar-index
prefilter pushdown, the prefilter scan — works on substrait filters
unchanged.

Decode path: pyarrow deserializes the blob into a bound compute
Expression; that expression's canonical text form (fully-parenthesized
binary ops over ``FieldPath(i)`` references) is parsed by a small
recursive-descent translator. Anything outside the supported filter
subset raises InvalidInputError rather than mistranslating.
"""

from __future__ import annotations

import re

from ..errors import InvalidInputError

_FIELD = re.compile(r"FieldPath\((\d+)\)")
_NUM = re.compile(r"-?\d+(\.\d+)?([eE][-+]?\d+)?")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_BINOPS = {
    "==": "=", "!=": "!=", ">=": ">=", "<=": "<=", ">": ">", "<": "<",
    "and": "AND", "or": "OR",
}
_CALLS = {
    "is_null": "({0} IS NULL)",
    "is_valid": "({0} IS NOT NULL)",
    "invert": "(NOT {0})",
}


def is_substrait_filter(obj) -> bool:
    """Whether a where() argument is a substrait blob (bytes-like)."""
    return isinstance(obj, (bytes, bytearray, memoryview))


def substrait_to_sql(buf) -> str:
    """ExtendedExpression blob (exactly one expression) → SQL string in
    the engine's filter dialect."""
    try:
        import pyarrow.substrait as ps
    except ImportError as e:  # pragma: no cover
        raise InvalidInputError(
            "substrait filters need pyarrow with substrait support"
        ) from e
    try:
        bound = ps.deserialize_expressions(bytes(buf))
    except Exception as e:
        raise InvalidInputError(f"invalid substrait filter: {e}") from None
    exprs = bound.expressions
    if len(exprs) != 1:
        raise InvalidInputError(
            f"substrait filter must contain exactly one expression (got {len(exprs)})"
        )
    names = bound.schema.names
    text = str(next(iter(exprs.values())))
    return _Translator(text, names).parse()


class _Translator:
    """Recursive-descent over pyarrow's canonical expression text."""

    def __init__(self, text: str, names: list[str]):
        self.text = text
        self.pos = 0
        self.names = names

    def parse(self) -> str:
        out = self.term()
        self.ws()
        if self.pos != len(self.text):
            self.fail("trailing content")
        return out

    # -- helpers --
    def ws(self):
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def fail(self, why: str):
        raise InvalidInputError(
            f"unsupported substrait filter ({why} at {self.pos}): {self.text!r}"
        )

    def term(self) -> str:
        self.ws()
        t = self.text
        if self.pos >= len(t):
            self.fail("unexpected end")
        c = t[self.pos]
        if c == "(":
            self.pos += 1
            left = self.term()
            self.ws()
            for op_txt in sorted(_BINOPS, key=len, reverse=True):
                if t.startswith(op_txt, self.pos):
                    nxt = self.pos + len(op_txt)
                    if op_txt.isalpha() and nxt < len(t) and t[nxt].isalnum():
                        continue
                    self.pos = nxt
                    right = self.term()
                    self.ws()
                    if self.pos >= len(t) or t[self.pos] != ")":
                        self.fail("expected )")
                    self.pos += 1
                    return f"({left} {_BINOPS[op_txt]} {right})"
            self.fail("unknown operator")
        m = _FIELD.match(t, self.pos)
        if m:
            self.pos = m.end()
            idx = int(m.group(1))
            if idx >= len(self.names):
                self.fail(f"field index {idx} out of range")
            return f"`{self.names[idx]}`"
        if c == '"':
            return self.string()
        m = _NUM.match(t, self.pos)
        if m:
            self.pos = m.end()
            return m.group(0)
        m = _IDENT.match(t, self.pos)
        if m:
            word = m.group(0)
            self.pos = m.end()
            if word in ("true", "false"):
                return word.upper()
            if word == "null":
                return "NULL"
            if word in _CALLS:
                self.ws()
                if self.pos >= len(t) or t[self.pos] != "(":
                    self.fail(f"expected ( after {word}")
                self.pos += 1
                arg = self.term()
                self.ws()
                if self.pos >= len(t) or t[self.pos] != ")":
                    self.fail("expected )")
                self.pos += 1
                return _CALLS[word].format(arg)
            self.fail(f"unknown function {word!r}")
        self.fail(f"unexpected character {c!r}")

    def string(self) -> str:
        t = self.text
        assert t[self.pos] == '"'
        self.pos += 1
        out = []
        while self.pos < len(t):
            c = t[self.pos]
            if c == "\\" and self.pos + 1 < len(t):
                out.append(t[self.pos + 1])
                self.pos += 2
                continue
            if c == '"':
                self.pos += 1
                val = "".join(out)
                return "'" + val.replace("'", "''") + "'"
            out.append(c)
            self.pos += 1
        self.fail("unterminated string")
        raise AssertionError  # unreachable
