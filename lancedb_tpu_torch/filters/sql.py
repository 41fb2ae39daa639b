"""SQL expression parser for filters and dynamic projections.

The reference delegates SQL parsing to DataFusion (reference:
rust/lancedb/src/query.rs:792-812 `Filter::Sql`, expr/sql.rs). We
implement the needed dialect subset directly: comparisons, boolean
logic, arithmetic, IN / BETWEEN / LIKE / IS NULL, literals (numbers,
strings, booleans, ISO timestamps via functions), identifiers
(dotted + backtick-quoted), and a function-call registry.

Output is a small AST consumed by :mod:`lancedb_tpu.filters.eval`
(pyarrow compute) — and, for the device path, by the bitmask compiler
that turns predicates into row masks fed to Pallas scan kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..errors import SqlParseError

# ---------------------------------------------------------------- AST


@dataclass(frozen=True)
class Expr:
    def sql(self) -> str:  # round-trip-able textual form
        raise NotImplementedError


@dataclass(frozen=True)
class Literal(Expr):
    value: Any  # None | bool | int | float | str | list

    def sql(self) -> str:
        import datetime as _dt

        v = self.value
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "TRUE" if v else "FALSE"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, (list, tuple)):
            return "(" + ", ".join(Literal(x).sql() for x in v) + ")"
        if isinstance(v, _dt.datetime):
            # resolved subquery results round-trip through SQL text for
            # scan pushdown — render temporals as parseable CASTs
            return f"CAST('{v.isoformat()}' AS timestamp)"
        if isinstance(v, _dt.date):
            return f"CAST('{v.isoformat()}' AS date)"
        if isinstance(v, (int, float)):
            return repr(v)
        raise SqlParseError(
            f"cannot render a {type(v).__name__} literal as SQL"
        )


@dataclass(frozen=True)
class Column(Expr):
    name: str  # dotted path for struct fields

    def sql(self) -> str:
        return "`" + self.name + "`"


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # 'not' | 'neg' | 'is_null' | 'is_not_null'
    operand: Expr

    def sql(self) -> str:
        if self.op == "not":
            return f"NOT ({self.operand.sql()})"
        if self.op == "neg":
            return f"-({self.operand.sql()})"
        if self.op == "is_null":
            return f"({self.operand.sql()}) IS NULL"
        if self.op == "is_not_null":
            return f"({self.operand.sql()}) IS NOT NULL"
        raise AssertionError(self.op)


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # and or eq ne lt le gt ge add sub mul div mod like not_like in not_in
    left: Expr
    right: Expr

    _SYM = {
        "and": "AND", "or": "OR", "eq": "=", "ne": "!=", "lt": "<", "le": "<=",
        "gt": ">", "ge": ">=", "add": "+", "sub": "-", "mul": "*", "div": "/",
        "mod": "%", "like": "LIKE", "not_like": "NOT LIKE", "in": "IN",
        "not_in": "NOT IN", "concat": "||",
    }

    def sql(self) -> str:
        if self.op in ("in", "not_in"):
            # the literal list renders its own parentheses
            return f"({self.left.sql()}) {self._SYM[self.op]} {self.right.sql()}"
        return f"({self.left.sql()}) {self._SYM[self.op]} ({self.right.sql()})"


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def sql(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"({self.operand.sql()}) {neg}BETWEEN ({self.low.sql()}) AND ({self.high.sql()})"


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str
    args: tuple[Expr, ...]

    def sql(self) -> str:
        return f"{self.name}(" + ", ".join(a.sql() for a in self.args) + ")"


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str

    def sql(self) -> str:
        return f"CAST(({self.operand.sql()}) AS {self.type_name})"


@dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN ... THEN ... [ELSE ...] END (searched form; the simple
    form `CASE x WHEN v ...` parses into equality conditions)."""

    whens: tuple  # ((cond Expr, value Expr), ...)
    else_: "Expr | None" = None

    def sql(self) -> str:
        parts = ["CASE"]
        for c, v in self.whens:
            parts.append(f"WHEN {c.sql()} THEN {v.sql()}")
        if self.else_ is not None:
            parts.append(f"ELSE {self.else_.sql()}")
        parts.append("END")
        return " ".join(parts)


# ------------------------------------------------------------- Lexer

_KEYWORDS = {
    "AND", "OR", "NOT", "IN", "IS", "NULL", "TRUE", "FALSE", "LIKE",
    "BETWEEN", "CAST", "AS", "REGEXP", "CASE", "WHEN", "THEN", "ELSE",
    "END",
}

_TWO_CHAR = {"<=", ">=", "!=", "<>", "==", "||"}


@dataclass
class _Token:
    kind: str  # 'ident' 'number' 'string' 'kw' 'op' 'lparen' 'rparen' 'comma' 'eof'
    text: str
    pos: int


def _tokenize(src: str) -> list[_Token]:
    toks: list[_Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c in ("X", "x") and i + 1 < n and src[i + 1] == "'":
            # blob hex literal X'0AFF' (DataFusion/standard SQL)
            j = src.find("'", i + 2)
            if j < 0:
                raise SqlParseError(f"unterminated hex literal at {i}")
            hexstr = src[i + 2 : j]
            try:
                value = bytes.fromhex(hexstr)
            except ValueError:
                raise SqlParseError(f"invalid hex literal X'{hexstr}' at {i}") from None
            toks.append(_Token("bytes", value, i))
            i = j + 1
            continue
        if c == "'":  # string literal w/ '' escape
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlParseError(f"unterminated string literal at {i}")
                if src[j] == "'":
                    if j + 1 < n and src[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(src[j])
                j += 1
            toks.append(_Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":  # quoted identifier
            quote = c
            j = src.find(quote, i + 1)
            if j < 0:
                raise SqlParseError(f"unterminated quoted identifier at {i}")
            toks.append(_Token("ident", src[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = src[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    seen_exp = True
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                else:
                    break
            toks.append(_Token("number", src[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_"):
                j += 1
            word = src[i:j]
            # dotted path: keep consuming `.ident`
            while j < n and src[j] == "." and j + 1 < n and (src[j + 1].isalpha() or src[j + 1] == "_"):
                j += 1
                k = j
                while k < n and (src[k].isalnum() or src[k] == "_"):
                    k += 1
                word += "." + src[j:k]
                j = k
            if word.upper() in _KEYWORDS and "." not in word:
                toks.append(_Token("kw", word.upper(), i))
            else:
                toks.append(_Token("ident", word, i))
            i = j
            continue
        if src[i : i + 2] in _TWO_CHAR:
            toks.append(_Token("op", src[i : i + 2], i))
            i += 2
            continue
        if c in "=<>+-*/%|":
            toks.append(_Token("op", c, i))
            i += 1
            continue
        if c == "(":
            toks.append(_Token("lparen", c, i))
            i += 1
            continue
        if c == ")":
            toks.append(_Token("rparen", c, i))
            i += 1
            continue
        if c == ",":
            toks.append(_Token("comma", c, i))
            i += 1
            continue
        if c == "[":
            toks.append(_Token("lbracket", c, i))
            i += 1
            continue
        if c == "]":
            toks.append(_Token("rbracket", c, i))
            i += 1
            continue
        raise SqlParseError(f"unexpected character {c!r} at position {i} in {src!r}")
    toks.append(_Token("eof", "", n))
    return toks


# ------------------------------------------------------------ Parser

_CMP_OPS = {"=": "eq", "==": "eq", "!=": "ne", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = _tokenize(src)
        self.i = 0

    def peek(self) -> _Token:
        return self.toks[self.i]

    def next(self) -> _Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: str | None = None) -> _Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise SqlParseError(
                f"expected {text or kind}, got {t.text!r} at position {t.pos} in {self.src!r}"
            )
        return t

    def accept_kw(self, kw: str) -> bool:
        t = self.peek()
        if t.kind == "kw" and t.text == kw:
            self.i += 1
            return True
        return False

    # expr := or_expr
    def parse(self) -> Expr:
        e = self.parse_or()
        t = self.peek()
        if t.kind != "eof":
            raise SqlParseError(f"unexpected trailing input {t.text!r} at {t.pos} in {self.src!r}")
        return e

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept_kw("OR"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept_kw("AND"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept_kw("NOT"):
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.text in _CMP_OPS:
            self.next()
            return BinaryOp(_CMP_OPS[t.text], left, self.parse_additive())
        if t.kind == "kw":
            negated = False
            save = self.i
            if t.text == "NOT":
                self.next()
                t2 = self.peek()
                if t2.kind == "kw" and t2.text in ("IN", "LIKE", "BETWEEN"):
                    negated = True
                    t = t2
                else:
                    self.i = save
                    return left
            if t.text == "IS":
                self.next()
                neg = self.accept_kw("NOT")
                if self.accept_kw("NULL"):
                    return UnaryOp("is_not_null" if neg else "is_null", left)
                if self.accept_kw("TRUE"):
                    e = BinaryOp("eq", left, Literal(True))
                elif self.accept_kw("FALSE"):
                    e = BinaryOp("eq", left, Literal(False))
                else:
                    raise SqlParseError(f"expected NULL/TRUE/FALSE after IS at {t.pos}")
                return UnaryOp("not", e) if neg else e
            if t.text == "IN":
                self.next()
                items = self.parse_paren_list()
                return BinaryOp("not_in" if negated else "in", left, items)
            if t.text == "LIKE":
                self.next()
                return BinaryOp("not_like" if negated else "like", left, self.parse_additive())
            if t.text == "REGEXP":
                self.next()
                return FunctionCall("regexp_match", (left, self.parse_additive()))
            if t.text == "BETWEEN":
                self.next()
                low = self.parse_additive()
                if not self.accept_kw("AND"):
                    raise SqlParseError("expected AND in BETWEEN")
                high = self.parse_additive()
                return Between(left, low, high, negated=negated)
        return left

    def parse_paren_list(self) -> Expr:
        self.expect("lparen")
        vals: list[Expr] = []
        if self.peek().kind != "rparen":
            vals.append(self.parse_or())
            while self.peek().kind == "comma":
                self.next()
                vals.append(self.parse_or())
        self.expect("rparen")
        # list of literals → single Literal list; else keep as function.
        # Unary minus parses as UnaryOp('neg', Literal), so fold signed
        # numbers back into literals (IN (-1, 2) is valid SQL).
        folded: list[Expr] = []
        for v in vals:
            if (isinstance(v, UnaryOp) and v.op == "neg"
                    and isinstance(v.operand, Literal)
                    and isinstance(v.operand.value, (int, float))):
                v = Literal(-v.operand.value)
            folded.append(v)
        if all(isinstance(v, Literal) for v in folded):
            return Literal([v.value for v in folded])  # type: ignore[union-attr]
        raise SqlParseError("IN list must contain literals")

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self.next()
                op = "add" if t.text == "+" else "sub"
                left = BinaryOp(op, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "%", "||"):
                # || binds at this level, matching DataFusion/sqlparser-rs
                self.next()
                op = {"*": "mul", "/": "div", "%": "mod", "||": "concat"}[t.text]
                left = BinaryOp(op, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.text == "-":
            self.next()
            return UnaryOp("neg", self.parse_unary())
        if t.kind == "op" and t.text == "+":
            self.next()
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "number":
            text = t.text
            if "." in text or "e" in text or "E" in text:
                return Literal(float(text))
            return Literal(int(text))
        if t.kind == "string":
            return Literal(t.text)
        if t.kind == "bytes":
            return Literal(t.text)  # already bytes (X'..' hex literal)
        if t.kind == "kw":
            if t.text == "NULL":
                return Literal(None)
            if t.text == "TRUE":
                return Literal(True)
            if t.text == "FALSE":
                return Literal(False)
            if t.text == "CAST":
                self.expect("lparen")
                e = self.parse_or()
                if not self.accept_kw("AS"):
                    raise SqlParseError("expected AS in CAST")
                ty = self.expect("ident").text
                self.expect("rparen")
                return Cast(e, ty.lower())
            if t.text == "NOT":
                return UnaryOp("not", self.parse_not())
            if t.text == "CASE":
                # simple form: CASE <operand> WHEN v THEN r ...
                operand = None
                if not (self.peek().kind == "kw" and self.peek().text == "WHEN"):
                    operand = self.parse_or()
                whens = []
                while self.accept_kw("WHEN"):
                    cond = self.parse_or()
                    if operand is not None:
                        cond = BinaryOp("eq", operand, cond)
                    if not self.accept_kw("THEN"):
                        raise SqlParseError("expected THEN in CASE")
                    whens.append((cond, self.parse_or()))
                if not whens:
                    raise SqlParseError("CASE needs at least one WHEN")
                else_ = self.parse_or() if self.accept_kw("ELSE") else None
                if not self.accept_kw("END"):
                    raise SqlParseError("expected END to close CASE")
                return Case(tuple(whens), else_)
            raise SqlParseError(f"unexpected keyword {t.text} at {t.pos}")
        if t.kind == "ident":
            if self.peek().kind == "lparen":  # function call
                self.next()
                args: list[Expr] = []
                if self.peek().kind != "rparen":
                    args.append(self.parse_or())
                    while self.peek().kind == "comma":
                        self.next()
                        args.append(self.parse_or())
                self.expect("rparen")
                return FunctionCall(t.text.lower(), tuple(args))
            return Column(t.name if hasattr(t, "name") else t.text)
        if t.kind == "lparen":
            e = self.parse_or()
            self.expect("rparen")
            return e
        raise SqlParseError(f"unexpected token {t.text!r} at position {t.pos} in {self.src!r}")


def parse_sql_expr(src: str) -> Expr:
    """Parse a SQL scalar/boolean expression into an AST."""
    if not isinstance(src, str) or not src.strip():
        raise SqlParseError("empty SQL expression")
    return _Parser(src).parse()


def and_join(filters: list[Expr]) -> Expr | None:
    """AND-compose filters, matching reference query.rs:792-812 semantics."""
    out: Expr | None = None
    for f in filters:
        out = f if out is None else BinaryOp("and", out, f)
    return out
