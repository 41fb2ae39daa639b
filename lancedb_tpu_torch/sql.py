"""SQL SELECT engine over lancedb_tpu_torch tables.

The reference executes full SQL through DataFusion: `BaseTable` is a
DataFusion `TableProvider` with filter pushdown (reference
rust/lancedb/src/table/datafusion.rs:37-44) and full-text search is
reachable from SQL through the `fts(table, query)` table function
(reference rust/lancedb/src/table/datafusion/udtf/fts.rs:16-51). This
module implements that surface natively:

  SELECT [DISTINCT] items FROM source [WHERE p] [GROUP BY e,..]
  [HAVING p] [ORDER BY e [ASC|DESC],..] [LIMIT n] [OFFSET m]

* `source` is a table name, `fts(table, 'query' [, k])`, or a
  parenthesised sub-select.
* Aggregates: COUNT(*) / COUNT(x) / COUNT(DISTINCT x) / SUM / AVG /
  MIN / MAX, freely nested in scalar expressions.
* WHERE over a base table is pushed down into the storage scan (and
  from there into scalar indexes via the existing prefilter path);
  projection pushdown reads only referenced columns.

Row-wise expression evaluation reuses filters/eval.py (pyarrow
compute); grouping/aggregation runs on pyarrow group_by kernels. This
is a host-side engine by design — the reference's DataFusion layer is
also CPU-side; the device is for vector/FTS scans, which enter SQL
through fts() and (via query builders) the search APIs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import pyarrow as pa
import pyarrow.compute as pc

from .errors import InvalidInputError, SqlParseError
from .filters.eval import evaluate_expression, evaluate_predicate_mask
from .filters.sql import (
    Between,
    BinaryOp,
    Case,
    Cast,
    Column,
    Expr,
    FunctionCall,
    Literal,
    UnaryOp,
    _Parser,
)

AGG_NAMES = {
    "count", "sum", "avg", "min", "max",
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "median", "array_agg", "bool_and", "bool_or", "string_agg",
    "corr", "covar_samp", "covar_pop",
}

#: aggregates taking a second argument
_TWO_ARG_AGGS = {"string_agg", "corr", "covar_samp", "covar_pop"}
# clause-boundary words (not reserved in the expression grammar, so the
# statement parser stops expression parsing when it sees one)
_CLAUSE_WORDS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
    "BY", "ASC", "DESC", "DISTINCT", "SELECT", "UNION", "INTERSECT", "EXCEPT",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "ON",
}


@dataclass(frozen=True)
class Star(Expr):
    def sql(self) -> str:
        return "*"


@dataclass(frozen=True)
class Aggregate(Expr):
    func: str          # count | count_distinct | count_all | sum | ... (AGG_NAMES)
    arg: Expr | None   # None for count(*)
    arg2: Expr | None = None  # second argument (string_agg separator)

    def sql(self) -> str:
        if self.func == "count_all":
            return "COUNT(*)"
        if self.func == "count_distinct":
            return f"COUNT(DISTINCT {self.arg.sql()})"
        if self.arg2 is not None:
            return f"{self.func.upper()}({self.arg.sql()}, {self.arg2.sql()})"
        return f"{self.func.upper()}({self.arg.sql()})"


#: window-only functions (everything else under OVER must be an aggregate)
_RANKING_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist",
    "lag", "lead", "first_value", "last_value", "nth_value",
}


_INTERVAL_UNITS = ("second", "minute", "hour", "day", "week")
_INTERVAL_SCALE = {
    "second": 1.0, "minute": 60.0, "hour": 3600.0,
    "day": 86400.0, "week": 604800.0,
}


def _interval_seconds(text: str, unit: str | None) -> float:
    """Parse an SQL interval body to seconds: INTERVAL '1 day',
    INTERVAL '2 hours 30 minutes', or INTERVAL '2' HOUR."""
    def num(v: str) -> float:
        try:
            return float(v)
        except ValueError:
            raise SqlParseError(f"malformed interval value {v!r} in {text!r}")

    parts = text.strip().lower().split()
    if unit is not None:
        if len(parts) != 1:
            raise SqlParseError(f"malformed interval {text!r} with unit {unit}")
        return num(parts[0]) * _INTERVAL_SCALE[unit]
    if len(parts) % 2 or not parts:
        raise SqlParseError(f"malformed interval literal {text!r}")
    total = 0.0
    for val, u in zip(parts[::2], parts[1::2]):
        u = u.rstrip("s")
        if u not in _INTERVAL_SCALE:
            raise SqlParseError(f"unsupported interval unit {u!r} in {text!r}")
        total += num(val) * _INTERVAL_SCALE[u]
    return total


@dataclass(frozen=True)
class WindowFunc(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [ROWS BETWEEN ...]).

    Reference surface: the DataFusion window operators the reference
    exposes through SQL (table/datafusion.rs registers BaseTable as a
    TableProvider; the dialect is DataFusion 54's). `frame` is
    (start, end) offsets relative to the current row with None for
    UNBOUNDED — rows for ROWS mode, peer groups for GROUPS, ORDER-BY-key
    values for RANGE; frame=None means the SQL default frame
    (RANGE UNBOUNDED PRECEDING..CURRENT ROW when ORDER BY is present,
    the whole partition otherwise)."""

    func: str
    args: tuple = ()
    partition_by: tuple = ()
    order_by: tuple = ()          # ((expr, desc), ...)
    frame: tuple | None = None    # (start|None, end|None); offsets per frame_mode
    frame_mode: str = "ROWS"      # ROWS | RANGE | GROUPS
    frame_temporal: bool = False  # RANGE offsets are INTERVAL seconds

    def sql(self) -> str:
        if self.func == "count_all":
            head = "COUNT(*)"
        else:
            head = f"{self.func.upper()}({', '.join(a.sql() for a in self.args)})"
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ", ".join(e.sql() for e in self.partition_by))
        if self.order_by:
            parts.append(
                "ORDER BY "
                + ", ".join(e.sql() + (" DESC" if d else "") for e, d in self.order_by)
            )
        if self.frame is not None:
            def b(v, side):
                if v is None:
                    return f"UNBOUNDED {side}"
                if v == 0:
                    return "CURRENT ROW"
                mag = (
                    f"INTERVAL '{abs(v)} seconds'"
                    if self.frame_temporal
                    else f"{abs(v)}"
                )
                return f"{mag} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
            parts.append(
                f"{self.frame_mode} BETWEEN {b(self.frame[0], 'PRECEDING')} "
                f"AND {b(self.frame[1], 'FOLLOWING')}"
            )
        return f"{head} OVER ({' '.join(parts)})"


@dataclass
class SelectItem:
    expr: Expr
    alias: str | None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if isinstance(self.expr, Column):
            return self.expr.name
        return self.expr.sql().lower()


@dataclass
class TableSource:
    kind: str                       # 'table' | 'fts' | 'subquery'
    name: str | None = None         # table name
    fts_query: Expr | None = None   # fts() args
    fts_k: Expr | None = None
    subquery: "SelectStatement | None" = None
    alias: str | None = None


@dataclass
class Join:
    """One JOIN clause (reference: DataFusion joins over registered
    TableProviders — table/datafusion.rs). Equality keys only."""

    source: TableSource
    how: str                        # 'inner' | 'left outer' | 'right outer' | 'full outer'
    on: list[tuple[Expr, Expr]]     # AND-ed equality pairs


@dataclass
class SelectStatement:
    items: list[SelectItem]
    source: TableSource
    joins: list["Join"] = field(default_factory=list)
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[tuple[Expr, bool]] = field(default_factory=list)  # (expr, desc)
    # per-key NULLS FIRST/LAST: "first" | "last" | None (None = the
    # DataFusion/Postgres default: last for ASC, first for DESC)
    order_nulls: list = field(default_factory=list)
    limit: int | None = None
    offset: int = 0
    distinct: bool = False
    # WITH name [(cols)] AS (...) bindings visible to this statement and
    # every subquery under it: [(name, statement, column_aliases)]
    ctes: list[tuple] = field(default_factory=list)
    # WITH RECURSIVE: self-referencing CTEs execute iteratively
    ctes_recursive: bool = False


@dataclass(frozen=True)
class Exists(Expr):
    """EXISTS (SELECT ...) — uncorrelated; resolves to a boolean
    literal before execution (correlated subqueries are not supported,
    matching the pushdown-friendly subset)."""

    stmt: "SelectStatement" = None  # type: ignore[assignment]

    def sql(self) -> str:
        return "EXISTS (<subquery>)"


@dataclass(frozen=True)
class Subquery(Expr):
    """A parenthesized SELECT used as an expression — IN (SELECT ...)
    or a scalar comparison (reference: DataFusion subquery expressions).
    Resolved to literal values before execution/pushdown."""

    stmt: "SelectStatement" = None  # type: ignore[assignment]

    def sql(self) -> str:
        return "(<subquery>)"


@dataclass
class UnionStatement:
    """Set-operation chain: UNION / INTERSECT / EXCEPT, each [ALL]
    (reference: DataFusion set operations; INTERSECT binds tighter, so
    the parser nests it as a member). The trailing ORDER BY/LIMIT/
    OFFSET of the final member bind to the whole expression, per
    standard SQL."""

    selects: list  # SelectStatement | nested UnionStatement
    all: bool = False
    order_by: list[tuple[Expr, bool]] = field(default_factory=list)
    order_nulls: list = field(default_factory=list)
    limit: int | None = None
    offset: int = 0
    ctes: list[tuple] = field(default_factory=list)
    ctes_recursive: bool = False
    # pairwise operators, len == len(selects) - 1; None ⇒ all the same
    # UNION [ALL] (backward form). Values: 'union'|'union all'|
    # 'intersect'|'intersect all'|'except'|'except all'
    ops: list[str] | None = None


class _SelectParser(_Parser):
    """Statement-level parser; expressions delegate to the filter grammar."""

    def _at_word(self, *words: str) -> bool:
        t = self.peek()
        return t.kind in ("ident", "kw") and t.text.upper() in words

    def _eat_word(self, word: str) -> bool:
        if self._at_word(word):
            self.next()
            return True
        return False

    def _at_subquery(self) -> bool:
        if self.peek().kind != "lparen":
            return False
        t2 = self.toks[self.i + 1]
        return t2.kind in ("ident", "kw") and t2.text.upper() == "SELECT"

    def _parse_subquery(self) -> "Subquery":
        self.expect("lparen")
        stmt = self.parse_select()
        self.expect("rparen")
        return Subquery(stmt)

    def parse_paren_list(self) -> Expr:
        # IN (SELECT ...) — subquery instead of a literal list
        if self._at_subquery():
            return self._parse_subquery()
        return super().parse_paren_list()

    def parse_primary(self) -> Expr:
        e = self._parse_primary_inner()
        if self._at_word("OVER"):
            e = self._parse_over(e)
        return e

    def _parse_primary_inner(self) -> Expr:
        if self._at_subquery():
            return self._parse_subquery()
        if self._at_word("EXISTS"):
            self.next()
            if not self._at_subquery():
                raise SqlParseError("expected (SELECT ...) after EXISTS")
            return Exists(self._parse_subquery().stmt)
        # aggregates (incl. COUNT(*) / COUNT(DISTINCT x)) before the
        # generic function-call rule
        t = self.peek()
        if t.kind == "ident" and t.text.lower() in AGG_NAMES:
            if self.toks[self.i + 1].kind == "lparen":
                fname = t.text.lower()
                self.next()
                self.next()  # lparen
                if fname == "count" and self.peek().kind == "op" and self.peek().text == "*":
                    self.next()
                    self.expect("rparen")
                    return Aggregate("count_all", None)
                distinct = False
                if fname == "count" and self._at_word("DISTINCT"):
                    self.next()
                    distinct = True
                arg = self.parse_or()
                arg2 = None
                if self.peek().kind == "comma":
                    if fname not in _TWO_ARG_AGGS:
                        raise SqlParseError(f"{fname}() takes one argument")
                    self.next()
                    arg2 = self.parse_or()
                elif fname in _TWO_ARG_AGGS:
                    raise SqlParseError(f"{fname}() requires two arguments")
                self.expect("rparen")
                return Aggregate("count_distinct" if distinct else fname, arg, arg2)
        return super().parse_primary()

    def _parse_over(self, operand: Expr) -> WindowFunc:
        """operand OVER (PARTITION BY ... ORDER BY ... [ROWS frame])."""
        self.next()  # OVER
        if isinstance(operand, Aggregate):
            if operand.func == "count_distinct":
                raise SqlParseError("COUNT(DISTINCT ...) OVER is not supported")
            func = operand.func
            args = () if operand.arg is None else (operand.arg,)
        elif isinstance(operand, FunctionCall) and operand.name.lower() in _RANKING_FUNCS:
            func = operand.name.lower()
            args = tuple(operand.args)
        else:
            raise SqlParseError(
                f"{operand.sql()!r} is not a window function or aggregate"
            )
        self.expect("lparen")
        partition_by: list[Expr] = []
        order_by: list[tuple[Expr, bool]] = []
        frame = None
        if self._eat_word("PARTITION"):
            if not self._eat_word("BY"):
                raise SqlParseError("expected BY after PARTITION")
            partition_by = self.parse_expr_list()
        if self._eat_word("ORDER"):
            if not self._eat_word("BY"):
                raise SqlParseError("expected BY after ORDER")
            while True:
                e = self.parse_or()
                desc = bool(self._eat_word("DESC"))
                if not desc:
                    self._eat_word("ASC")
                if self._at_word("NULLS"):
                    raise SqlParseError(
                        "NULLS FIRST/LAST in window ORDER BY is not supported"
                    )
                order_by.append((e, desc))
                if self.peek().kind == "comma":
                    self.next()
                    continue
                break
        frame_mode = "ROWS"
        frame_temporal = False
        if self._at_word("ROWS", "RANGE", "GROUPS"):
            frame_mode = self.next().text.upper()

            def bound(first: bool) -> int | float | None:
                nonlocal frame_temporal
                if self._eat_word("UNBOUNDED"):
                    if not self._eat_word("PRECEDING" if first else "FOLLOWING"):
                        # UNBOUNDED FOLLOWING as a start / PRECEDING as an
                        # end are nonsensical; surface the keyword error
                        w = self.next()
                        raise SqlParseError(f"unexpected {w.text!r} after UNBOUNDED")
                    return None
                if self._eat_word("CURRENT"):
                    if not self._eat_word("ROW"):
                        raise SqlParseError("expected ROW after CURRENT")
                    return 0
                if frame_mode == "RANGE" and self._eat_word("INTERVAL"):
                    # INTERVAL '1 day' / INTERVAL '2' HOUR — offset in
                    # seconds against a temporal ORDER BY key
                    s = self.expect("string").text
                    unit = None
                    for u in _INTERVAL_UNITS:
                        if self._eat_word(u.upper()) or self._eat_word(u.upper() + "S"):
                            unit = u
                            break
                    n = _interval_seconds(s, unit)
                    frame_temporal = True
                else:
                    txt = self.expect("number").text
                    # RANGE offsets are values in ORDER-BY-key units and
                    # may be fractional; ROWS/GROUPS offsets count
                    # rows/groups
                    try:
                        n = (
                            float(txt)
                            if frame_mode == "RANGE" and "." in txt
                            else int(txt)
                        )
                    except ValueError:
                        raise SqlParseError(
                            f"{frame_mode} frame offsets must be integers (got {txt!r})"
                        )
                if self._eat_word("PRECEDING"):
                    return -n
                if self._eat_word("FOLLOWING"):
                    return n
                raise SqlParseError("expected PRECEDING or FOLLOWING")

            if self._eat_word("BETWEEN"):
                start = bound(True)
                if not self._eat_word("AND"):
                    raise SqlParseError("expected AND in window frame")
                end = bound(False)
            else:
                start = bound(True)
                end = 0
            if start is not None and end is not None and start > end:
                raise SqlParseError("window frame start is after frame end")
            frame = (start, end)
            has_offset = any(v not in (None, 0) for v in frame)
            if frame_mode == "GROUPS" and not order_by:
                raise SqlParseError("GROUPS window frames require ORDER BY")
            if frame_mode == "RANGE" and has_offset and len(order_by) != 1:
                raise SqlParseError(
                    "RANGE frames with numeric offsets require exactly one "
                    "ORDER BY expression"
                )
        self.expect("rparen")
        return WindowFunc(
            func, args, tuple(partition_by), tuple(order_by), frame, frame_mode,
            frame_temporal,
        )

    def parse_expr_list(self) -> list[Expr]:
        out = [self.parse_or()]
        while self.peek().kind == "comma":
            self.next()
            out.append(self.parse_or())
        return out

    def parse_select(self) -> SelectStatement:
        if not self._eat_word("SELECT"):
            raise SqlParseError("expected SELECT")
        distinct = bool(self._eat_word("DISTINCT"))
        items: list[SelectItem] = []
        while True:
            if self.peek().kind == "op" and self.peek().text == "*":
                self.next()
                items.append(SelectItem(Star(), None))
            else:
                e = self.parse_or()
                alias = None
                if self.accept_kw("AS"):
                    alias = self.expect("ident").text
                elif self.peek().kind == "ident" and not self._at_word(*_CLAUSE_WORDS):
                    alias = self.next().text
                items.append(SelectItem(e, alias))
            if self.peek().kind == "comma":
                self.next()
                continue
            break
        if not self._eat_word("FROM"):
            # FROM-less SELECT (SELECT 1, SELECT 2+2): one synthetic row
            # (DataFusion/Postgres allow this; recursive CTE base terms
            # rely on it)
            source = TableSource(kind="dual")
        else:
            source = self._parse_source()
        joins: list[Join] = []
        while True:
            how = None
            if self._eat_word("INNER"):
                how = "inner"
            elif self._eat_word("LEFT"):
                self._eat_word("OUTER")
                how = "left outer"
            elif self._eat_word("RIGHT"):
                self._eat_word("OUTER")
                how = "right outer"
            elif self._eat_word("FULL"):
                self._eat_word("OUTER")
                how = "full outer"
            if how is not None:
                if not self._eat_word("JOIN"):
                    raise SqlParseError("expected JOIN")
            elif self._eat_word("JOIN"):
                how = "inner"
            else:
                break
            right = self._parse_source()
            if not self._eat_word("ON"):
                raise SqlParseError("expected ON after JOIN")
            joins.append(Join(source=right, how=how, on=_eq_pairs(self.parse_or())))
        where = self.parse_or() if self._eat_word("WHERE") else None
        group_by: list[Expr] = []
        if self._eat_word("GROUP"):
            if not self._eat_word("BY"):
                raise SqlParseError("expected BY after GROUP")
            group_by = self.parse_expr_list()
        having = self.parse_or() if self._eat_word("HAVING") else None
        order_by: list[tuple[Expr, bool]] = []
        order_nulls: list = []
        if self._eat_word("ORDER"):
            if not self._eat_word("BY"):
                raise SqlParseError("expected BY after ORDER")
            while True:
                e = self.parse_or()
                desc = False
                if self._eat_word("DESC"):
                    desc = True
                else:
                    self._eat_word("ASC")
                nulls = None
                if self._eat_word("NULLS"):
                    if self._eat_word("FIRST"):
                        nulls = "first"
                    elif self._eat_word("LAST"):
                        nulls = "last"
                    else:
                        raise SqlParseError("expected FIRST or LAST after NULLS")
                order_by.append((e, desc))
                order_nulls.append(nulls)
                if self.peek().kind == "comma":
                    self.next()
                    continue
                break
        limit = None
        offset = 0
        if self._eat_word("LIMIT"):
            limit = int(self.expect("number").text)
        if self._eat_word("OFFSET"):
            offset = int(self.expect("number").text)
        return SelectStatement(
            items=items, source=source, joins=joins, where=where, group_by=group_by,
            having=having, order_by=order_by, order_nulls=order_nulls,
            limit=limit, offset=offset,
            distinct=distinct,
        )

    def _parse_source(self) -> TableSource:
        t = self.peek()
        if t.kind == "lparen":
            self.next()
            sub = self.parse_select()
            self.expect("rparen")
            alias = None
            if self.accept_kw("AS"):
                alias = self.expect("ident").text
            elif self.peek().kind == "ident" and not self._at_word(*_CLAUSE_WORDS):
                alias = self.next().text
            return TableSource(kind="subquery", subquery=sub, alias=alias)
        name = self.expect("ident").text
        if name.lower() == "fts" and self.peek().kind == "lparen":
            self.next()
            tbl = self.next()
            if tbl.kind not in ("ident", "string"):
                raise SqlParseError("fts() first argument must be a table name")
            self.expect("comma")
            q = self.parse_or()
            k = None
            if self.peek().kind == "comma":
                self.next()
                k = self.parse_or()
            self.expect("rparen")
            src = TableSource(kind="fts", name=tbl.text, fts_query=q, fts_k=k)
        else:
            src = TableSource(kind="table", name=name)
        if self.accept_kw("AS"):
            src.alias = self.expect("ident").text
        elif self.peek().kind == "ident" and not self._at_word(*_CLAUSE_WORDS):
            src.alias = self.next().text
        return src


def _eq_pairs(cond: Expr) -> list[tuple[Expr, Expr]]:
    """Flatten an ON condition into equality pairs (AND-ed `a.x = b.y`)."""
    if isinstance(cond, BinaryOp) and cond.op == "and":
        return _eq_pairs(cond.left) + _eq_pairs(cond.right)
    if isinstance(cond, BinaryOp) and cond.op == "eq" and isinstance(cond.left, Column) and isinstance(cond.right, Column):
        return [(cond.left, cond.right)]
    raise SqlParseError(
        "JOIN ... ON supports AND-ed column equalities (a.x = b.y); got "
        f"{cond.sql()!r}"
    )


def parse_select(sql: str) -> "SelectStatement | UnionStatement":
    p = _SelectParser(sql)
    # WITH name [(col, ...)] AS (select), ... — CTEs bind for the whole
    # statement, later CTEs may reference earlier ones (DataFusion /
    # standard SQL; RECURSIVE is not supported)
    ctes: list[tuple] = []
    recursive = False
    if p._eat_word("WITH"):
        recursive = p._eat_word("RECURSIVE")
        while True:
            name = p.expect("ident").text
            cols: list[str] | None = None
            if p.peek().kind == "lparen":
                p.next()
                cols = [p.expect("ident").text]
                while p.peek().kind == "comma":
                    p.next()
                    cols.append(p.expect("ident").text)
                p.expect("rparen")
            if not p.accept_kw("AS") and not p._eat_word("AS"):
                raise SqlParseError(f"expected AS after WITH {name}")
            p.expect("lparen")
            sub = _parse_set_expr(p)
            p.expect("rparen")
            ctes.append((name, sub, cols))
            if p.peek().kind == "comma":
                p.next()
                continue
            break
    stmt = _parse_set_expr(p)
    if p.peek().kind != "eof":
        t = p.peek()
        raise SqlParseError(f"unexpected trailing token {t.text!r} at {t.pos}")
    stmt.ctes = ctes
    stmt.ctes_recursive = recursive
    return stmt


def _parse_set_expr(p: _SelectParser) -> "SelectStatement | UnionStatement":
    """One set expression: UNION / EXCEPT chains over INTERSECT chains
    (INTERSECT binds tighter — standard SQL / DataFusion precedence),
    each operator optionally ALL."""
    first = _parse_intersect_chain(p)
    selects = [first]
    ops: list[str] = []
    while True:
        if p._eat_word("UNION"):
            op = "union all" if p._eat_word("ALL") else "union"
            if op == "union":
                p._eat_word("DISTINCT")
        elif p._eat_word("EXCEPT"):
            op = "except all" if p._eat_word("ALL") else "except"
            if op == "except":
                p._eat_word("DISTINCT")
        else:
            break
        selects.append(_parse_intersect_chain(p))
        ops.append(op)
    if len(selects) == 1:
        if isinstance(first, UnionStatement):  # pure INTERSECT chain
            first.order_by, first.order_nulls, first.limit, first.offset = _lift_tail(first)
        return first
    union = UnionStatement(selects, all=all(o == "union all" for o in ops), ops=ops)
    # standard SQL: the trailing ORDER BY/LIMIT of the text bind to the
    # whole set expression, not the last member (which consumed them)
    union.order_by, union.order_nulls, union.limit, union.offset = _lift_tail(union)
    return union


def _parse_intersect_chain(p: _SelectParser) -> "SelectStatement | UnionStatement":
    stmt = p.parse_select()
    members = [stmt]
    ops: list[str] = []
    while p._eat_word("INTERSECT"):
        op = "intersect all" if p._eat_word("ALL") else "intersect"
        if op == "intersect":
            p._eat_word("DISTINCT")
        members.append(p.parse_select())
        ops.append(op)
    if len(members) == 1:
        return stmt
    return UnionStatement(members, all=False, ops=ops)


def _lift_tail(node: "UnionStatement"):
    """Steal ORDER BY/LIMIT/OFFSET from the deepest-last member (the
    leaf SELECT that textually consumed them)."""
    leaf = node
    while isinstance(leaf, UnionStatement):
        leaf = leaf.selects[-1]
    out = leaf.order_by, leaf.order_nulls, leaf.limit, leaf.offset
    leaf.order_by, leaf.order_nulls, leaf.limit, leaf.offset = [], [], None, 0
    return out


# --------------------------------------------------------------- analysis

def _walk(e: Expr):
    yield e
    if isinstance(e, BinaryOp):
        yield from _walk(e.left)
        yield from _walk(e.right)
    elif isinstance(e, UnaryOp):
        yield from _walk(e.operand)
    elif isinstance(e, Between):
        yield from _walk(e.operand)
        yield from _walk(e.low)
        yield from _walk(e.high)
    elif isinstance(e, FunctionCall):
        for a in e.args:
            yield from _walk(a)
    elif isinstance(e, Cast):
        yield from _walk(e.operand)
    elif isinstance(e, Case):
        for c, v in e.whens:
            yield from _walk(c)
            yield from _walk(v)
        if e.else_ is not None:
            yield from _walk(e.else_)
    elif isinstance(e, Aggregate):
        if e.arg is not None:
            yield from _walk(e.arg)
        if e.arg2 is not None:
            yield from _walk(e.arg2)
    elif isinstance(e, WindowFunc):
        for a in e.args:
            yield from _walk(a)
        for pexpr in e.partition_by:
            yield from _walk(pexpr)
        for oexpr, _ in e.order_by:
            yield from _walk(oexpr)


def _columns_of(exprs) -> set[str]:
    out: set[str] = set()
    for e in exprs:
        if e is None:
            continue
        for n in _walk(e):
            if isinstance(n, Column):
                out.add(n.name.split(".")[0])
    return out


def _find_aggs(exprs) -> list[Aggregate]:
    found: dict[str, Aggregate] = {}
    for e in exprs:
        if e is None:
            continue
        for n in _walk(e):
            if isinstance(n, Aggregate):
                found.setdefault(n.sql(), n)
    return list(found.values())


def _replace(e: Expr, table: dict[str, Expr], into_subqueries: bool = False) -> Expr:
    """Rewrite: any sub-expression whose .sql() is in `table` becomes the
    mapped expression (used to bind aggregates / group keys to columns).

    `into_subqueries` also substitutes inside Subquery/Exists statements
    — used ONLY for per-row correlation-variable literal substitution,
    where the keys are qualified outer references a nested scope cannot
    capture. Join-env rewriting must NOT descend: replacing `e.dept`
    with an unqualified `dept` inside a subquery would rebind it to the
    inner table (name capture); correlated references stay qualified and
    resolve against the outer row set instead."""
    r = lambda x: _replace(x, table, into_subqueries)
    key = e.sql()
    if key in table:
        return table[key]
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, r(e.left), r(e.right))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, r(e.operand))
    if isinstance(e, Between):
        return Between(r(e.operand), r(e.low), r(e.high), e.negated)
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, tuple(r(a) for a in e.args))
    if isinstance(e, Cast):
        return Cast(r(e.operand), e.type_name)
    if isinstance(e, Case):
        return Case(
            tuple((r(c), r(v)) for c, v in e.whens),
            r(e.else_) if e.else_ is not None else None,
        )
    if isinstance(e, Aggregate) and e.arg is not None:
        return Aggregate(
            e.func, r(e.arg), r(e.arg2) if e.arg2 is not None else None
        )
    if isinstance(e, (Subquery, Exists)) and into_subqueries:
        return type(e)(_substitute_stmt(e.stmt, table))
    if isinstance(e, WindowFunc):
        new = WindowFunc(
            e.func,
            tuple(r(a) for a in e.args),
            tuple(r(p) for p in e.partition_by),
            tuple((r(o), d) for o, d in e.order_by),
            e.frame,
            e.frame_mode,
            e.frame_temporal,
        )
        # re-check after child substitution: grouped queries bind window
        # placeholders by their aggregate-bound sql form
        return table.get(new.sql(), new)
    return e


def _substitute_stmt(stmt, table: dict[str, Expr]):
    """Deep-copy a statement with _replace applied to every expression
    position (items, where, group/having/order, join conditions, nested
    sources and CTE bodies), descending into nested subqueries — the
    per-row correlation substitution."""
    import copy as _copy

    r = lambda e: _replace(e, table, into_subqueries=True)
    if isinstance(stmt, UnionStatement):
        new = _copy.copy(stmt)
        new.selects = [_substitute_stmt(s, table) for s in stmt.selects]
        new.order_by = [(r(e), d) for e, d in stmt.order_by]
        new.ctes = [(n, _substitute_stmt(s, table), c) for n, s, c in stmt.ctes]
        return new
    new = _copy.copy(stmt)
    new.items = [
        it if isinstance(it.expr, Star) else SelectItem(r(it.expr), it.alias)
        for it in stmt.items
    ]
    new.where = r(stmt.where) if stmt.where is not None else None
    new.having = r(stmt.having) if stmt.having is not None else None
    new.group_by = [r(e) for e in stmt.group_by]
    new.order_by = [(r(e), d) for e, d in stmt.order_by]

    def sub_source(src: TableSource) -> TableSource:
        if src.kind == "subquery":
            out = _copy.copy(src)
            out.subquery = _substitute_stmt(src.subquery, table)
            return out
        return src

    new.source = sub_source(stmt.source)
    new.joins = [
        Join(sub_source(j.source), j.how, [(r(a), r(b)) for a, b in j.on])
        for j in stmt.joins
    ]
    new.ctes = [(n, _substitute_stmt(s, table), c) for n, s, c in getattr(stmt, "ctes", [])]
    return new


#: implicit columns every scan can produce
_IMPLICIT_COLS = {"_rowid", "_score", "_distance", "_relevance_score"}


def _output_columns(stmt, open_table) -> set[str]:
    """Best-effort output column names of a statement (for correlation
    analysis)."""
    if isinstance(stmt, UnionStatement):
        return _output_columns(stmt.selects[0], open_table)
    out: set[str] = set()
    for it in stmt.items:
        if isinstance(it.expr, Star):
            out |= _source_columns(stmt.source, open_table)
            for j in stmt.joins:
                out |= _source_columns(j.source, open_table)
        else:
            out.add(it.name)
    return out


def _source_columns(src: TableSource, open_table) -> set[str]:
    if src.kind in ("table", "fts"):
        try:
            obj = open_table(src.name)
        except Exception:
            return set()
        names = obj.column_names if isinstance(obj, pa.Table) else list(obj.schema.names)
        return set(names) | _IMPLICIT_COLS
    if src.kind == "subquery":
        return _output_columns(src.subquery, open_table)
    return set()


def _free_columns(stmt, open_table) -> list[Column]:
    """Columns a statement references that none of its own sources (or
    nested scopes) can resolve — the correlation variables. A qualified
    `q.c` is free when `q` is not a local alias; an unqualified `c` is
    free when no local source has a column `c`."""
    if isinstance(stmt, UnionStatement):
        out: list[Column] = []
        seen: set[str] = set()
        for s in stmt.selects:
            for c in _free_columns(s, open_table):
                if c.sql() not in seen:
                    seen.add(c.sql())
                    out.append(c)
        return out
    local_aliases: set[str] = set()
    local_cols: set[str] = set(_IMPLICIT_COLS)
    cte_names = {n for n, _, _ in getattr(stmt, "ctes", [])}

    def add_source(src: TableSource):
        alias = src.alias or src.name
        if alias:
            local_aliases.add(alias)
        local_cols.update(_source_columns(src, open_table))

    add_source(stmt.source)
    for j in stmt.joins:
        add_source(j.source)
    local_cols.update(it.alias for it in stmt.items if it.alias)

    free: list[Column] = []
    seen: set[str] = set()

    def note(col: Column):
        if col.sql() in seen:
            return
        name = col.name
        if "." in name:
            q = name.split(".", 1)[0]
            if q in local_aliases or q in cte_names:
                return
        elif name in local_cols:
            return
        seen.add(col.sql())
        free.append(col)

    def scan_expr(e: Expr):
        if e is None:
            return
        for n in _walk(e):
            if isinstance(n, Column):
                note(n)
            elif isinstance(n, (Subquery, Exists)):
                # a nested scope's free vars are free here unless local
                for c in _free_columns(n.stmt, open_table):
                    note(c)

    for it in stmt.items:
        if not isinstance(it.expr, Star):
            scan_expr(it.expr)
    scan_expr(stmt.where)
    scan_expr(stmt.having)
    for e in stmt.group_by:
        scan_expr(e)
    for e, _ in stmt.order_by:
        scan_expr(e)
    for j in stmt.joins:
        for a, b in j.on:
            scan_expr(a)
            scan_expr(b)
    if stmt.source.kind == "subquery":
        for c in _free_columns(stmt.source.subquery, open_table):
            note(c)
    if stmt.source.kind == "fts" and stmt.source.fts_query is not None:
        scan_expr(stmt.source.fts_query)
    return free


def _strip_qualifier(e: Expr | None, quals: set[str]) -> Expr | None:
    """Rewrite `q.c` → `c` for a single-table statement's own alias.
    Does NOT descend into Subquery/Exists: nested scopes dequalify
    themselves at their own execution, and their references to THIS
    scope are correlation variables that must stay qualified."""
    if e is None:
        return None
    if isinstance(e, Column):
        if "." in e.name:
            q, c = e.name.split(".", 1)
            if q in quals:
                return Column(c)
        return e
    if isinstance(e, (Subquery, Exists, Literal, Star)):
        return e
    s = lambda x: _strip_qualifier(x, quals)
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, s(e.left), s(e.right))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, s(e.operand))
    if isinstance(e, Between):
        return Between(s(e.operand), s(e.low), s(e.high), e.negated)
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, tuple(s(a) for a in e.args))
    if isinstance(e, Cast):
        return Cast(s(e.operand), e.type_name)
    if isinstance(e, Case):
        return Case(
            tuple((s(c), s(v)) for c, v in e.whens),
            s(e.else_) if e.else_ is not None else None,
        )
    if isinstance(e, Aggregate):
        return Aggregate(
            e.func,
            s(e.arg) if e.arg is not None else None,
            s(e.arg2) if e.arg2 is not None else None,
        )
    if isinstance(e, WindowFunc):
        return WindowFunc(
            e.func, tuple(s(a) for a in e.args),
            tuple(s(p) for p in e.partition_by),
            tuple((s(o), d) for o, d in e.order_by), e.frame,
            e.frame_mode, e.frame_temporal,
        )
    return e


def _dequalify_stmt(stmt: SelectStatement) -> SelectStatement:
    """`SELECT e.id FROM emp e WHERE e.x > 1` — strip the source's own
    qualifier from every expression of a no-join statement (DataFusion
    resolves these through its schema qualifiers; this engine's scan
    layer uses bare column names)."""
    import copy as _copy

    quals = {q for q in (stmt.source.alias, stmt.source.name) if q}
    if not quals:
        return stmt
    s = lambda e: _strip_qualifier(e, quals)
    new = _copy.copy(stmt)
    new.items = [
        it if isinstance(it.expr, Star) else SelectItem(s(it.expr), it.alias)
        for it in stmt.items
    ]
    new.where = s(stmt.where)
    new.having = s(stmt.having)
    new.group_by = [s(e) for e in stmt.group_by]
    new.order_by = [(s(e), d) for e, d in stmt.order_by]
    return new


def _find_windows(exprs) -> list[WindowFunc]:
    found: dict[str, WindowFunc] = {}
    for e in exprs:
        if e is None:
            continue
        for n in _walk(e):
            if isinstance(n, WindowFunc):
                found.setdefault(n.sql(), n)
    return list(found.values())


# ------------------------------------------------------- window execution


def _window_sort(data: pa.Table, wf: WindowFunc):
    """Sorted permutation + partition/peer structure for one window.

    Returns (perm, ps, part_end, peer_first, peer_end) as int64 arrays in
    SORTED order: ps/part_end bound the row's partition, peer_first/
    peer_end its ORDER-BY peer group (== the row itself when the window
    has no ORDER BY ... no, == the partition: no order ⇒ all rows are
    peers, the SQL default-frame rule)."""
    import numpy as np

    n = data.num_rows
    tmp_cols: dict[str, pa.Array] = {}
    sort_keys = []
    for i, e in enumerate(wf.partition_by):
        tmp_cols[f"__p{i}"] = _as_array(evaluate_expression(data, e), n)
        sort_keys.append((f"__p{i}", "ascending"))
    for i, (e, desc) in enumerate(wf.order_by):
        tmp_cols[f"__o{i}"] = _as_array(evaluate_expression(data, e), n)
        sort_keys.append((f"__o{i}", "descending" if desc else "ascending"))
    if sort_keys:
        tmp = pa.table(tmp_cols)
        # nulls sort last (pyarrow default; DataFusion's ASC default too)
        perm = np.asarray(pc.sort_indices(tmp, sort_keys=sort_keys)).astype(np.int64)
    else:
        perm = np.arange(n, dtype=np.int64)

    def codes_of(names):
        out = []
        for name in names:
            arr = tmp_cols[name]
            codes = pc.dictionary_encode(arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr).indices
            out.append(np.asarray(pc.fill_null(codes, -1)).astype(np.int64)[perm])
        return out

    newpart = np.zeros(n, dtype=bool)
    if n:
        newpart[0] = True
    for c in codes_of([f"__p{i}" for i in range(len(wf.partition_by))]):
        newpart[1:] |= c[1:] != c[:-1]
    newpeer = newpart.copy()
    for c in codes_of([f"__o{i}" for i in range(len(wf.order_by))]):
        newpeer[1:] |= c[1:] != c[:-1]

    idx = np.arange(n, dtype=np.int64)
    ps = np.maximum.accumulate(np.where(newpart, idx, 0))
    part_starts = np.flatnonzero(newpart)
    part_end = np.empty(n, dtype=np.int64)
    if n:
        nxt = np.searchsorted(part_starts, idx, side="right")
        part_end = np.where(
            nxt < len(part_starts), part_starts[np.minimum(nxt, len(part_starts) - 1)] - 1, n - 1
        )
    if wf.order_by:
        peer_first = np.maximum.accumulate(np.where(newpeer, idx, 0))
        peer_starts = np.flatnonzero(newpeer)
        nxtp = np.searchsorted(peer_starts, idx, side="right")
        peer_end = np.where(
            nxtp < len(peer_starts), peer_starts[np.minimum(nxtp, len(peer_starts) - 1)] - 1, n - 1
        )
    else:
        # no ORDER BY: every partition row is a peer (frame = whole partition)
        peer_first, peer_end = ps, part_end
    return perm, ps, part_end, peer_first, peer_end, newpeer


def _eval_window(data: pa.Table, wf: WindowFunc) -> pa.Array:
    """Evaluate one window function over the (post-WHERE) row set."""
    import numpy as np

    n = data.num_rows
    if n == 0:
        return pa.array([], type=pa.int64())
    perm, ps, part_end, peer_first, peer_end, newpeer = _window_sort(data, wf)
    idx = np.arange(n, dtype=np.int64)

    def order_key():
        """Sorted ORDER-BY key as f64 (DESC negated) for RANGE offsets."""
        if len(wf.order_by) != 1:
            raise InvalidInputError(
                "RANGE frames with numeric offsets require exactly one "
                "ORDER BY expression"
            )
        e, desc = wf.order_by[0]
        sk = _as_array(evaluate_expression(data, e), n).take(pa.array(perm))
        t = sk.type
        temporal = (
            pa.types.is_timestamp(t) or pa.types.is_date(t) or pa.types.is_time(t)
        )
        if wf.frame_temporal and not temporal:
            raise InvalidInputError(
                f"INTERVAL frame offsets require a temporal ORDER BY key (got {t})"
            )
        kn = np.asarray(pc.is_null(sk)).astype(bool)
        if temporal:
            # epoch units → seconds so INTERVAL offsets line up
            scale = {
                "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9,
            }.get(getattr(t, "unit", None), 86400.0 if pa.types.is_date32(t) else 1e-3)
            kv = (
                pc.fill_null(pc.cast(sk, pa.int64()), 0)
                .to_numpy(zero_copy_only=False)
                .astype(np.float64)
                * scale
            )
        elif pa.types.is_integer(t) or pa.types.is_floating(t) or pa.types.is_decimal(t):
            kv = pc.cast(sk, pa.float64()).to_numpy(zero_copy_only=False)
        else:
            raise InvalidInputError(
                f"RANGE frame offsets require a numeric or temporal ORDER BY key (got {t})"
            )
        if desc:
            kv = -kv
        return np.where(kn, 0.0, kv), kn

    def lit_arg(i, default, name):
        if len(wf.args) <= i:
            return default
        a = wf.args[i]
        if isinstance(a, UnaryOp) and a.op == "neg" and isinstance(a.operand, Literal):
            return -a.operand.value
        if not isinstance(a, Literal):
            raise InvalidInputError(f"{name} argument of {wf.func} must be a literal")
        return a.value

    def scatter(res_sorted: np.ndarray, as_type=None) -> pa.Array:
        out = np.empty_like(res_sorted)
        out[perm] = res_sorted
        return pa.array(out, type=as_type)

    def scatter_list(res_sorted: list) -> pa.Array:
        out: list = [None] * n
        for pos, v in zip(perm, res_sorted):
            out[pos] = v
        return pa.array(out)

    f = wf.func
    if f == "row_number":
        return scatter(idx - ps + 1)
    if f == "rank":
        return scatter(peer_first - ps + 1)
    if f == "dense_rank":
        cum = np.cumsum(newpeer)
        return scatter(cum - cum[ps] + 1)
    if f == "percent_rank":
        cnt = part_end - ps + 1
        r = (peer_first - ps).astype(np.float64)
        return scatter(np.where(cnt > 1, r / np.maximum(cnt - 1, 1), 0.0))
    if f == "cume_dist":
        cnt = (part_end - ps + 1).astype(np.float64)
        return scatter((peer_end - ps + 1) / cnt)
    if f == "ntile":
        k = int(lit_arg(0, None, "bucket count") or 0)
        if k <= 0:
            raise InvalidInputError("ntile() requires a positive integer bucket count")
        cnt = part_end - ps + 1
        pos = idx - ps
        q, r = cnt // k, cnt % k
        big = r * (q + 1)
        bucket = np.where(
            pos < big,
            pos // np.maximum(q + 1, 1) + 1,
            np.where(q > 0, (pos - big) // np.maximum(q, 1) + r + 1, pos + 1),
        )
        return scatter(np.minimum(bucket, np.maximum(cnt, 1)))

    # value-bearing functions: evaluate the argument once, in sorted order
    if not wf.args and f not in ("count_all",):
        raise InvalidInputError(f"{wf.func}() requires an argument")
    if wf.args:
        arg_arr = _as_array(evaluate_expression(data, wf.args[0]), n)
        sorted_vals = arg_arr.take(pa.array(perm))
    else:
        arg_arr = sorted_vals = None

    if f in ("lag", "lead"):
        off = int(lit_arg(1, 1, "offset"))
        default = lit_arg(2, None, "default")
        shift = -off if f == "lag" else off
        j = idx + shift
        valid = (j >= ps) & (j <= part_end)
        taken = sorted_vals.take(pa.array(np.where(valid, j, 0)))
        vmask = pa.array(valid)
        if default is None:
            res = pc.if_else(vmask, taken, pa.scalar(None, type=taken.type))
        else:
            res = pc.if_else(vmask, taken, pa.scalar(default).cast(taken.type))
        out_idx = np.empty(n, dtype=np.int64)
        out_idx[perm] = idx
        return res.take(pa.array(out_idx))
    if f in ("first_value", "last_value", "nth_value"):
        fs, fe = _frame_bounds(wf, idx, ps, part_end, peer_first, peer_end, newpeer, order_key)
        if f == "first_value":
            pick, valid = fs, fs <= fe
        elif f == "last_value":
            pick, valid = fe, fs <= fe
        else:
            nth = int(lit_arg(1, None, "n") or 0)
            if nth <= 0:
                raise InvalidInputError("nth_value() requires a positive n")
            pick = fs + nth - 1
            valid = pick <= fe
        taken = sorted_vals.take(pa.array(np.where(valid, pick, 0)))
        res = pc.if_else(pa.array(valid), taken, pa.scalar(None, type=taken.type))
        out_idx = np.empty(n, dtype=np.int64)
        out_idx[perm] = idx
        return res.take(pa.array(out_idx))

    if f not in ("sum", "avg", "min", "max", "count", "count_all"):
        raise InvalidInputError(f"unsupported window function {wf.func!r}")

    fs, fe = _frame_bounds(wf, idx, ps, part_end, peer_first, peer_end, newpeer, order_key)
    # FOLLOWING-only / PRECEDING-only frames can be empty near partition
    # edges (fs > fe) and their raw offsets can leave [0, n): clamp the
    # indices and mask empty frames to NULL/0 rather than letting the
    # prefix-sum lookups wrap or overflow
    empty = fs > fe
    fs = np.clip(fs, 0, n - 1)
    fe = np.clip(fe, 0, n - 1)
    if f == "count_all":
        return scatter(np.where(empty, 0, fe - fs + 1))

    typ = sorted_vals.type
    numeric = pa.types.is_integer(typ) or pa.types.is_floating(typ) or pa.types.is_decimal(typ)
    if not numeric and f in ("sum", "avg"):
        raise InvalidInputError(f"{f}() window requires a numeric argument")
    if numeric:
        vals = pc.cast(sorted_vals, pa.float64()).to_numpy(zero_copy_only=False)
        isnull = np.asarray(pc.is_null(sorted_vals)).astype(bool)
        v0 = np.where(isnull, 0.0, vals)
        # prefix sums make every [fs, fe] range O(1)
        csum = np.concatenate([[0.0], np.cumsum(v0)])
        ccnt = np.concatenate([[0], np.cumsum(~isnull)])
        cnt = np.where(empty, 0, ccnt[fe + 1] - ccnt[fs])
        if f == "count":
            return scatter(cnt.astype(np.int64))
        if f in ("sum", "avg"):
            s = np.where(empty, 0.0, csum[fe + 1] - csum[fs])
            res = np.where(cnt > 0, s if f == "sum" else s / np.maximum(cnt, 1), np.nan)
            mask = cnt == 0
            if f == "sum" and pa.types.is_integer(typ):
                out = np.empty(n, dtype=np.float64)
                out[perm] = res
                m2 = np.empty(n, dtype=bool)
                m2[perm] = mask
                return pa.array(
                    np.where(m2, 0, out).astype(np.int64), type=pa.int64(), mask=m2
                )
            out = np.empty(n, dtype=np.float64)
            out[perm] = res
            m2 = np.empty(n, dtype=bool)
            m2[perm] = mask
            return pa.array(out, mask=m2)
        # min/max over [fs, fe]: default frames are prefix windows per
        # partition/peer structure → running accumulate; general ROWS
        # frames fall through to the bounded python loop
        if wf.frame is None:
            filled = np.where(isnull, np.inf if f == "min" else -np.inf, vals)
            acc = np.minimum.accumulate if f == "min" else np.maximum.accumulate
            run = _per_partition_accumulate(filled, ps, acc)
            res = run[fe]
            cnt_ok = cnt > 0
            out = np.empty(n, dtype=np.float64)
            out[perm] = res
            m2 = np.empty(n, dtype=bool)
            m2[perm] = ~cnt_ok
            if pa.types.is_integer(typ):
                return pa.array(
                    np.where(m2, 0, out).astype(np.int64), type=pa.int64(), mask=m2
                )
            return pa.array(out, mask=m2)
    # generic bounded loop: non-numeric min/max and explicit-frame min/max
    pyvals = sorted_vals.to_pylist()
    res_list: list = []
    for i in range(n):
        seg = [] if empty[i] else [v for v in pyvals[fs[i] : fe[i] + 1] if v is not None]
        if f == "count":
            res_list.append(len(seg))
        elif not seg:
            res_list.append(None)
        else:
            res_list.append(min(seg) if f == "min" else max(seg))
    return scatter_list(res_list)


def _frame_bounds(wf: WindowFunc, idx, ps, part_end, peer_first, peer_end,
                  newpeer, order_key):
    """Per-row [start, end] frame indices in sorted order (inclusive).

    ROWS offsets count rows; GROUPS offsets count ORDER-BY peer groups;
    RANGE offsets are values in ORDER-BY-key units (standard SQL /
    DataFusion semantics: CURRENT ROW in RANGE/GROUPS means the peer
    group boundary, and NULL-key rows frame with their null peers).
    ``order_key`` lazily yields (key_f64, isnull) in sorted order with
    DESC keys negated so every partition run is ascending."""
    import numpy as np

    if wf.frame is None:
        # SQL default: RANGE UNBOUNDED PRECEDING..CURRENT ROW when the
        # window is ordered (current row's peers included), else the
        # whole partition (peer_end == part_end in that case)
        return ps, peer_end
    start, end = wf.frame
    n = len(idx)
    if wf.frame_mode == "ROWS" or n == 0:
        fs = ps if start is None else np.maximum(idx + start, ps)
        fe = part_end if end is None else np.minimum(idx + end, part_end)
        return fs, fe

    if wf.frame_mode == "GROUPS":
        peer_starts = np.flatnonzero(newpeer)
        ng = len(peer_starts)
        gi = np.searchsorted(peer_starts, idx, side="right") - 1
        g_first, g_last = gi[ps], gi[part_end]
        if start is None:
            fs = ps.copy()
        elif start == 0:
            fs = peer_first.copy()
        else:
            tg = gi + start
            fs = np.where(
                tg > g_last,
                part_end + 1,  # frame starts past the partition: empty
                peer_starts[np.clip(np.maximum(tg, g_first), 0, ng - 1)],
            )
        if end is None:
            fe = part_end.copy()
        elif end == 0:
            fe = peer_end.copy()
        else:
            te = gi + end
            fe = np.where(
                te >= g_last,
                part_end,
                np.where(
                    te < g_first,
                    ps - 1,  # frame ends before the partition: empty
                    peer_starts[np.clip(te + 1, 0, ng - 1)] - 1,
                ),
            )
        return fs, fe

    # RANGE with only UNBOUNDED/CURRENT ROW bounds is the default-frame
    # family: pure peer/partition arithmetic, valid over ANY ORDER BY
    # (string keys, multiple keys) — don't touch the key values
    if start in (None, 0) and end in (None, 0):
        fs = ps if start is None else peer_first
        fe = part_end if end is None else peer_end
        return fs, fe

    # RANGE with value offsets: per-partition binary search over the
    # (ascending) non-null key prefix; null-key rows frame with their
    # null peer group, and non-null frames never include nulls
    key, knull = order_key()
    fs = np.empty(n, dtype=np.int64)
    fe = np.empty(n, dtype=np.int64)
    starts = np.flatnonzero(ps == idx)
    bounds = list(starts) + [n]
    for a, b in zip(bounds[:-1], bounds[1:]):
        nn = b - a - int(knull[a:b].sum())  # nulls sort last
        kv = key[a : a + nn]
        if start is None:
            fs[a:b] = a
        elif start == 0:
            fs[a:b] = peer_first[a:b]
        else:
            fs[a : a + nn] = a + np.searchsorted(kv, kv + start, side="left")
            fs[a + nn : b] = peer_first[a + nn : b]
        if end is None:
            fe[a:b] = b - 1
        elif end == 0:
            fe[a:b] = peer_end[a:b]
        else:
            fe[a : a + nn] = a + np.searchsorted(kv, kv + end, side="right") - 1
            fe[a + nn : b] = peer_end[a + nn : b]
    return fs, fe


def _per_partition_accumulate(vals, ps, acc):
    """Running accumulate that restarts at each partition boundary."""
    import numpy as np

    out = np.empty_like(vals)
    starts = np.flatnonzero(ps == np.arange(len(ps)))
    bounds = list(starts) + [len(vals)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        out[a:b] = acc(vals[a:b])
    return out


# --------------------------------------------------------------- execution

class _VarOpts(pc.VarianceOptions):
    """VarianceOptions that remembers its ddof (the C options object is
    write-only) for the streaming/ungrouped fallback paths."""

    def __init__(self, ddof: int):
        super().__init__(ddof=ddof)
        self.ddof = ddof


# func -> (pyarrow hash-aggregate name, FunctionOptions | None).
# stddev/variance default to SAMPLE (ddof=1) like DataFusion/Postgres;
# median is pyarrow's t-digest approximate_median (exact on small groups).
_PA_AGG = {
    "count": ("count", None),
    "count_distinct": ("count_distinct", None),
    "count_all": ("count_all", None),
    "sum": ("sum", None),
    "avg": ("mean", None),
    "min": ("min", None),
    "max": ("max", None),
    "stddev": ("stddev", _VarOpts(1)),
    "stddev_samp": ("stddev", _VarOpts(1)),
    "stddev_pop": ("stddev", _VarOpts(0)),
    "variance": ("variance", _VarOpts(1)),
    "var_samp": ("variance", _VarOpts(1)),
    "var_pop": ("variance", _VarOpts(0)),
    "median": ("approximate_median", None),
    "array_agg": ("list", None),
    "string_agg": ("list", None),  # joined post-aggregation (_apply_agg_transforms)
    "bool_and": ("all", None),
    "bool_or": ("any", None),
}


def execute_select(
    sql_or_stmt: str | SelectStatement,
    open_table: Callable[[str], Any],
) -> pa.Table:
    """Run a SELECT. `open_table(name)` resolves table names."""
    from .metrics import span

    stmt = parse_select(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    if getattr(stmt, "ctes", None):
        return _execute_with_ctes(stmt, open_table)
    if isinstance(stmt, UnionStatement):
        return _execute_union(stmt, open_table)
    if stmt.where is not None and _find_windows([stmt.where]):
        raise InvalidInputError("window functions are not allowed in WHERE")
    if _find_windows([stmt.having] + stmt.group_by):
        raise InvalidInputError("window functions are not allowed in HAVING or GROUP BY")
    if not stmt.joins:
        stmt = _dequalify_stmt(stmt)

    # resolve subquery expressions in every clause, on a COPY — the
    # caller's statement object must stay re-executable (resolution
    # bakes in one execution's subquery results)
    if _has_subqueries(stmt):
        rs = lambda e: _resolve_subqueries(e, open_table)
        import copy as _copy

        stmt = _copy.copy(stmt)
        stmt.items = [
            it if isinstance(it.expr, Star) else SelectItem(rs(it.expr), it.alias)
            for it in stmt.items
        ]
        stmt.where = rs(stmt.where) if stmt.where is not None else None
        stmt.having = rs(stmt.having) if stmt.having is not None else None
        stmt.group_by = [rs(e) for e in stmt.group_by]
        stmt.order_by = [(rs(e), d) for e, d in stmt.order_by]
    elif stmt.group_by:
        # the alias-resolution below mutates group_by — copy first
        import copy as _copy

        stmt = _copy.copy(stmt)
        stmt.group_by = list(stmt.group_by)

    # correlated subqueries (per-outer-row): split them out of the
    # pushdown WHERE; they evaluate against the scanned rows below
    corr_where = None
    if not stmt.joins and stmt.where is not None and _has_corr_nodes(stmt.where):
        stmt.where, corr_where = _split_correlated_where(stmt.where)
        # the scan must keep the correlation columns the residue needs
        stmt._corr_where = corr_where

    from .sql_spill import sql_memory_budget

    budget = sql_memory_budget()
    if budget is not None and not stmt.joins and corr_where is None:
        out = _try_streaming_grouped(stmt, open_table, budget)
        if out is not None:
            if stmt.offset or stmt.limit is not None:
                with span("sql.limit", op="GlobalLimitExec") as tm:
                    if stmt.offset:
                        out = out.slice(stmt.offset)
                    if stmt.limit is not None:
                        out = out.slice(0, stmt.limit)
                    tm.set_rows(out.num_rows)
            return out

    if stmt.joins:
        data, stmt = _load_joined(stmt, open_table)
        corr_where = stmt.where  # correlated residue, join-env rewritten
        stmt.where = None
    else:
        data = _load_source(stmt, open_table)

    corr_counter = [0]
    if corr_where is not None:
        with span("sql.correlated_filter", op="CorrelatedFilterExec") as tm:
            bound, data = _bind_correlated_expr(data, corr_where, open_table, corr_counter)
            mask = evaluate_predicate_mask(data, bound)
            data = data.filter(pa.array(mask))
            drop = [c for c in data.column_names if c.startswith("__corr")]
            if drop:
                data = data.drop_columns(drop)
            tm.set_rows(data.num_rows)
    corr_items = any(
        _has_corr_nodes(it.expr) for it in stmt.items if not isinstance(it.expr, Star)
    ) or any(_has_corr_nodes(e) for e, _ in stmt.order_by)
    if corr_items:
        if stmt.group_by or _find_aggs([it.expr for it in stmt.items]):
            raise InvalidInputError(
                "correlated subqueries in the SELECT list of grouped queries are not supported"
            )
        with span("sql.correlated_project", op="CorrelatedProjectExec") as tm:
            new_items = []
            for it in stmt.items:
                if isinstance(it.expr, Star) or not _has_corr_nodes(it.expr):
                    new_items.append(it)
                else:
                    bound, data = _bind_correlated_expr(data, it.expr, open_table, corr_counter)
                    new_items.append(SelectItem(bound, it.alias or it.name))
            new_order = []
            for e, d in stmt.order_by:
                if _has_corr_nodes(e):
                    e, data = _bind_correlated_expr(data, e, open_table, corr_counter)
                new_order.append((e, d))
            stmt.items, stmt.order_by = new_items, new_order
            tm.set_rows(data.num_rows)

    # GROUP BY <alias>: resolve select-item aliases to their expressions
    # (standard SQL / DataFusion behavior)
    if stmt.group_by:
        alias_map = {
            it.alias: it.expr for it in stmt.items
            if it.alias and not isinstance(it.expr, Star)
        }
        stmt.group_by = [
            alias_map.get(e.name, e) if isinstance(e, Column) and e.name not in data.column_names
            else e
            for e in stmt.group_by
        ]

    all_exprs = (
        [it.expr for it in stmt.items]
        + stmt.group_by
        + [stmt.having]
        + [e for e, _ in stmt.order_by]
    )
    aggs = _find_aggs(all_exprs)
    grouped = bool(stmt.group_by) or bool(aggs)

    if grouped:
        with span("sql.aggregate", op="AggregateExec") as tm:
            out = _execute_grouped(stmt, data, aggs, open_table)
            tm.set_rows(out.num_rows)
    else:
        with span("sql.projection", op="ProjectionExec") as tm:
            out = _execute_plain(stmt, data)
            tm.set_rows(out.num_rows)

    if stmt.offset or stmt.limit is not None:
        with span("sql.limit", op="GlobalLimitExec") as tm:
            if stmt.offset:
                out = out.slice(stmt.offset)
            if stmt.limit is not None:
                out = out.slice(0, stmt.limit)
            tm.set_rows(out.num_rows)
    return out


def _try_streaming_grouped(stmt: SelectStatement, open_table, budget: int) -> pa.Table | None:
    """Bounded-memory grouped aggregation straight off the scan stream,
    when the statement shape allows it (plain-table source, grouped, no
    correlated nodes). Returns None to fall through to the materializing
    path."""
    if stmt.source.kind != "table":
        return None
    exprs = (
        [it.expr for it in stmt.items if not isinstance(it.expr, Star)]
        + stmt.group_by
        + [stmt.having]
        + [e for e, _ in stmt.order_by]
    )
    if any(_has_corr_nodes(e) for e in exprs if e is not None):
        return None
    try:
        obj = open_table(stmt.source.name)
    except Exception:
        return None
    if isinstance(obj, pa.Table):
        return None  # materialized CTE: already in memory
    schema_names = list(obj.schema.names)

    import copy as _copy

    stmt = _copy.copy(stmt)
    stmt.group_by = list(stmt.group_by)
    # GROUP BY <alias> resolves against the scan schema
    alias_map = {
        it.alias: it.expr for it in stmt.items
        if it.alias and not isinstance(it.expr, Star)
    }
    stmt.group_by = [
        alias_map.get(e.name, e)
        if isinstance(e, Column) and e.name not in schema_names else e
        for e in stmt.group_by
    ]
    aggs = _find_aggs(
        [it.expr for it in stmt.items] + stmt.group_by + [stmt.having]
        + [e for e, _ in stmt.order_by]
    )
    if not (stmt.group_by or aggs):
        return None
    if any(isinstance(it.expr, Star) for it in stmt.items):
        return None  # the grouped executor rejects * anyway

    from .metrics import span

    qb = obj.search(None)
    if stmt.where is not None:
        qb = qb.where(stmt.where.sql())
    aliases = {it.alias for it in stmt.items if it.alias}
    cols = sorted(
        (_columns_of(
            [it.expr for it in stmt.items] + stmt.group_by
            + [stmt.having, stmt.where] + [e for e, _ in stmt.order_by]
        ) - aliases)
    )
    scan_cols = [c for c in cols if c in schema_names]
    if scan_cols:
        qb = qb.select(scan_cols)
    with span("sql.aggregate", op="AggregateExec") as tm:
        out = _execute_grouped_streaming(
            stmt, qb.to_batches(), aggs, budget, source_schema=obj.schema,
            open_table=open_table,
        )
        tm.set_rows(out.num_rows)
    return out


def _execute_with_ctes(stmt, open_table) -> pa.Table:
    """Materialize WITH bindings in order (later CTEs and every
    subquery see earlier ones), then run the main statement against a
    resolver that serves the materialized tables."""
    import copy as _copy

    from .metrics import span

    mat: dict[str, pa.Table] = {}

    def resolve(name: str):
        if name in mat:
            return mat[name]
        return open_table(name)

    for name, sub, cols in stmt.ctes:
        if getattr(stmt, "ctes_recursive", False) and _stmt_references_table(sub, name):
            with span("sql.recursive_cte", op=f"RecursiveCteExec:{name}") as tm:
                t = _execute_recursive_cte(name, sub, cols, resolve)
                tm.set_rows(t.num_rows)
            mat[name] = t
            continue
        with span("sql.cte", op=f"CteExec:{name}") as tm:
            t = execute_select(sub, resolve)
            tm.set_rows(t.num_rows)
        if cols:
            if len(cols) != t.num_columns:
                raise InvalidInputError(
                    f"CTE {name} declares {len(cols)} columns, query returns {t.num_columns}"
                )
            t = t.rename_columns(cols)
        mat[name] = t
    inner = _copy.copy(stmt)
    inner.ctes = []
    return execute_select(inner, resolve)


def _stmt_references_table(stmt, name: str) -> bool:
    """Whether a statement (or any nested subquery/CTE/join) reads from
    table ``name`` — decides if a WITH RECURSIVE CTE is self-referencing."""
    if stmt is None:
        return False
    if isinstance(stmt, UnionStatement):
        return any(_stmt_references_table(s, name) for s in stmt.selects)

    def src_refs(src) -> bool:
        if src is None:
            return False
        if src.kind == "subquery":
            return _stmt_references_table(src.subquery, name)
        return src.name == name

    if src_refs(stmt.source) or any(src_refs(j.source) for j in stmt.joins):
        return True
    exprs = (
        [it.expr for it in stmt.items if not isinstance(it.expr, Star)]
        + [stmt.where, stmt.having]
        + stmt.group_by
        + [e for e, _ in stmt.order_by]
    )
    for e in exprs:
        if e is None:
            continue
        for n in _walk(e):
            if isinstance(n, (Subquery, Exists)) and _stmt_references_table(n.stmt, name):
                return True
    return any(
        _stmt_references_table(s, name) for _, s, _ in getattr(stmt, "ctes", [])
    )


def _execute_recursive_cte(name: str, sub, cols, resolve) -> pa.Table:
    """WITH RECURSIVE name AS (base UNION [ALL] step): iterate the step
    term with ``name`` bound to the PREVIOUS iteration's rows (the SQL
    standard's working table), accumulating until the step yields no
    new rows. UNION (distinct) de-duplicates against everything seen —
    the usual graph-traversal termination. Iterations are bounded
    (LANCEDB_TPU_SQL_RECURSION_LIMIT, default 1000) so a divergent
    query fails loudly instead of spinning (reference gets recursive
    CTEs from DataFusion, table/datafusion.rs:37-44)."""
    import os as _os

    if not isinstance(sub, UnionStatement) or len(sub.selects) != 2:
        raise InvalidInputError(
            f"recursive CTE {name} must be 'base UNION [ALL] step'"
        )
    ops = sub.ops or ["union all" if sub.all else "union"]
    if ops[0] not in ("union", "union all"):
        raise InvalidInputError(
            f"recursive CTE {name} requires UNION or UNION ALL between base and step"
        )
    distinct = ops[0] == "union"
    base_stmt, step_stmt = sub.selects
    if _stmt_references_table(base_stmt, name):
        raise InvalidInputError(
            f"recursive CTE {name}: the base term cannot reference {name!r}"
        )

    limit_iters = int(_os.environ.get("LANCEDB_TPU_SQL_RECURSION_LIMIT", "1000"))

    def finish(t: pa.Table) -> pa.Table:
        if cols:
            if len(cols) != t.num_columns:
                raise InvalidInputError(
                    f"CTE {name} declares {len(cols)} columns, query returns {t.num_columns}"
                )
            t = t.rename_columns(cols)
        return t

    work = finish(execute_select(base_stmt, resolve))
    seen: set = set()

    def dedupe(t: pa.Table) -> pa.Table:
        keep = []
        for i, row in enumerate(t.to_pylist()):
            key = tuple(
                tuple(v) if isinstance(v, list) else v for v in row.values()
            )
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return t.take(pa.array(keep, type=pa.int64())) if len(keep) < t.num_rows else t

    if distinct:
        work = dedupe(work)
    acc = [work]

    def step_resolve(n: str):
        if n == name:
            return work
        return resolve(n)

    iters = 0
    while work.num_rows:
        iters += 1
        if iters > limit_iters:
            raise InvalidInputError(
                f"recursive CTE {name} exceeded {limit_iters} iterations "
                "(set LANCEDB_TPU_SQL_RECURSION_LIMIT to raise the bound)"
            )
        new = finish(execute_select(step_stmt, step_resolve))
        if new.num_rows and acc[0].schema.names != new.schema.names:
            new = new.rename_columns(acc[0].schema.names)
        if distinct:
            new = dedupe(new)
        if new.num_rows == 0:
            break
        acc.append(new)
        work = new
    return pa.concat_tables(acc, promote_options="permissive")


def _has_subqueries(stmt: "SelectStatement") -> bool:
    exprs = (
        [it.expr for it in stmt.items if not isinstance(it.expr, Star)]
        + stmt.group_by
        + [stmt.having, stmt.where]
        + [e for e, _ in stmt.order_by]
    )
    return any(
        isinstance(n, (Subquery, Exists))
        for e in exprs if e is not None
        for n in _walk(e)
    )


def _resolve_subqueries(e: Expr, open_table) -> Expr:
    """Replace Subquery nodes with literal values: the RHS of IN/NOT IN
    becomes a value list; any other position is a scalar subquery
    (one column, at most one row; zero rows -> NULL)."""

    def run(sub: Subquery, want_list: bool):
        out = execute_select(sub.stmt, open_table)
        if out.num_columns != 1:
            raise InvalidInputError(
                f"subquery must return exactly one column (got {out.num_columns})"
            )
        vals = out.column(0).to_pylist()
        if want_list:
            return Literal(vals)
        if len(vals) > 1:
            raise InvalidInputError(
                f"scalar subquery returned {len(vals)} rows"
            )
        return Literal(vals[0] if vals else None)

    def rw(node: Expr) -> Expr:
        if isinstance(node, (Exists, Subquery)) and _free_columns(node.stmt, open_table):
            # correlated: left for per-outer-row binding after the scan
            return node
        if isinstance(node, Exists):
            inner = node.stmt
            probe = execute_select(
                SelectStatement(
                    items=inner.items, source=inner.source,
                    joins=inner.joins, where=inner.where,
                    group_by=inner.group_by, having=inner.having,
                    order_by=[],
                    # existence needs at most one surviving row, but the
                    # inner LIMIT/OFFSET are part of the row set
                    limit=1 if inner.limit is None else min(inner.limit, 1),
                    offset=inner.offset,
                ),
                open_table,
            )
            return Literal(probe.num_rows > 0)
        if isinstance(node, Subquery):
            return run(node, want_list=False)
        if isinstance(node, BinaryOp):
            if node.op in ("in", "not_in") and isinstance(node.right, Subquery):
                if _free_columns(node.right.stmt, open_table):
                    return BinaryOp(node.op, rw(node.left), node.right)
                lst = run(node.right, want_list=True)
                if any(v is None for v in lst.value):
                    # SQL three-valued logic: x NOT IN (..., NULL) is
                    # never TRUE; x IN drops NULLs (match only on values)
                    if node.op == "not_in":
                        return Literal(False)
                    lst = Literal([v for v in lst.value if v is not None])
                return BinaryOp(node.op, rw(node.left), lst)
            return BinaryOp(node.op, rw(node.left), rw(node.right))
        if isinstance(node, UnaryOp):
            return UnaryOp(node.op, rw(node.operand))
        if isinstance(node, Between):
            return Between(rw(node.operand), rw(node.low), rw(node.high), node.negated)
        if isinstance(node, FunctionCall):
            return FunctionCall(node.name, tuple(rw(a) for a in node.args))
        if isinstance(node, Cast):
            return Cast(rw(node.operand), node.type_name)
        if isinstance(node, Case):
            return Case(
                tuple((rw(c), rw(v)) for c, v in node.whens),
                rw(node.else_) if node.else_ is not None else None,
            )
        return node

    return rw(e)


# ----------------------------------------------- correlated subqueries


def _has_corr_nodes(e: Expr | None) -> bool:
    """After eager resolution, any surviving Subquery/Exists is correlated."""
    if e is None:
        return False
    return any(isinstance(n, (Subquery, Exists)) for n in _walk(e))


def _split_and(e: Expr) -> list[Expr]:
    if isinstance(e, BinaryOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _and_join(conjs: list[Expr]) -> Expr | None:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = BinaryOp("and", out, c)
    return out


def _split_correlated_where(where: Expr) -> tuple[Expr | None, Expr | None]:
    """(pushdown-able part, correlated residue) at top-level AND granularity."""
    conjs = _split_and(where)
    corr = [c for c in conjs if _has_corr_nodes(c)]
    if not corr:
        return where, None
    push = [c for c in conjs if not _has_corr_nodes(c)]
    return _and_join(push), _and_join(corr)


def _resolve_outer_col(data: pa.Table, col: Column) -> pa.ChunkedArray:
    """Resolve a correlation variable against the outer row set: exact
    name, the unqualified tail, then the join-suffixed form."""
    name = col.name
    if name in data.column_names:
        return data.column(name)
    if "." in name:
        q, c = name.split(".", 1)
        if c in data.column_names:
            return data.column(c)
        if f"{c}_{q}" in data.column_names:
            return data.column(f"{c}_{q}")
    raise InvalidInputError(f"cannot resolve correlated reference {name!r}")


def _corr_inner_results(data: pa.Table, inner_stmt, open_table, probe_exists: bool):
    """Per-outer-row inner results, cached on the distinct correlation-
    key tuples (the subquery runs once per distinct key, not per row)."""
    free = _free_columns(inner_stmt, open_table)
    cols = [(_resolve_outer_col(data, c).to_pylist(), c.sql()) for c in free]
    n = data.num_rows
    cache: dict = {}
    out = []
    for i in range(n):
        try:
            key = tuple(vals[i] for vals, _ in cols)
            hash(key)
        except TypeError:
            key = repr([vals[i] for vals, _ in cols])
        if key not in cache:
            table = {sql: Literal(vals[i]) for vals, sql in cols}
            inner2 = _substitute_stmt(inner_stmt, table)
            if probe_exists:
                inner2.limit = 1 if inner2.limit is None else min(inner2.limit, 1)
                inner2.order_by = []
            cache[key] = execute_select(inner2, open_table)
        out.append(cache[key])
    return out


def _bind_correlated_expr(
    data: pa.Table, e: Expr, open_table, counter: list
) -> tuple[Expr, pa.Table]:
    """Rewrite every correlated node in `e` into a per-row computed
    column appended to `data` (reference analog: DataFusion's subquery
    decorrelation; here the general fallback re-evaluates per distinct
    outer key)."""

    def append(values, name_hint: str) -> Column:
        nonlocal data
        name = f"__corr{counter[0]}"
        counter[0] += 1
        data = data.append_column(name, pa.array(values))
        return Column(name)

    def rw(node: Expr) -> Expr:
        nonlocal data
        if isinstance(node, BinaryOp) and node.op in ("in", "not_in") and isinstance(node.right, Subquery):
            lhs = rw(node.left)
            lhs_vals = _as_array(evaluate_expression(data, lhs), data.num_rows).to_pylist()
            inners = _corr_inner_results(data, node.right.stmt, open_table, probe_exists=False)
            res = []
            for lv, tbl in zip(lhs_vals, inners):
                if tbl.num_columns != 1:
                    raise InvalidInputError(
                        f"IN subquery must return exactly one column (got {tbl.num_columns})"
                    )
                vals = tbl.column(0).to_pylist()
                if lv is None:
                    res.append(None)
                    continue
                nn = [v for v in vals if v is not None]
                if lv in nn:
                    res.append(node.op == "in")
                elif len(nn) != len(vals):
                    res.append(None)  # 3VL: unknown against NULL members
                else:
                    res.append(node.op == "not_in")
            return append(res, "in")
        if isinstance(node, Exists):
            inners = _corr_inner_results(data, node.stmt, open_table, probe_exists=True)
            return append([t.num_rows > 0 for t in inners], "exists")
        if isinstance(node, Subquery):
            inners = _corr_inner_results(data, node.stmt, open_table, probe_exists=False)
            res = []
            for tbl in inners:
                if tbl.num_columns != 1:
                    raise InvalidInputError(
                        f"scalar subquery must return exactly one column (got {tbl.num_columns})"
                    )
                if tbl.num_rows > 1:
                    raise InvalidInputError(
                        f"scalar subquery returned {tbl.num_rows} rows"
                    )
                res.append(tbl.column(0)[0].as_py() if tbl.num_rows else None)
            return append(res, "scalar")
        if isinstance(node, BinaryOp):
            return BinaryOp(node.op, rw(node.left), rw(node.right))
        if isinstance(node, UnaryOp):
            return UnaryOp(node.op, rw(node.operand))
        if isinstance(node, Between):
            return Between(rw(node.operand), rw(node.low), rw(node.high), node.negated)
        if isinstance(node, FunctionCall):
            return FunctionCall(node.name, tuple(rw(a) for a in node.args))
        if isinstance(node, Cast):
            return Cast(rw(node.operand), node.type_name)
        if isinstance(node, Case):
            return Case(
                tuple((rw(c), rw(v)) for c, v in node.whens),
                rw(node.else_) if node.else_ is not None else None,
            )
        if isinstance(node, Aggregate) and node.arg is not None:
            return Aggregate(
                node.func, rw(node.arg),
                rw(node.arg2) if node.arg2 is not None else None,
            )
        if isinstance(node, WindowFunc):
            return WindowFunc(
                node.func, tuple(rw(a) for a in node.args),
                tuple(rw(p) for p in node.partition_by),
                tuple((rw(o), d) for o, d in node.order_by), node.frame,
                node.frame_mode, node.frame_temporal,
            )
        return node

    return rw(e), data


def _execute_union(stmt: UnionStatement, open_table) -> pa.Table:
    from .metrics import span

    parts = [execute_select(sel, open_table) for sel in stmt.selects]
    first = parts[0]
    aligned = [first]
    for t in parts[1:]:
        if t.num_columns != first.num_columns:
            raise InvalidInputError(
                f"set-operation members have {first.num_columns} vs {t.num_columns} columns"
            )
        aligned.append(t.rename_columns(first.column_names))
    ops = stmt.ops or [("union all" if stmt.all else "union")] * (len(parts) - 1)
    with span("sql.union", op="UnionExec") as tm:
        if all(o in ("union", "union all") for o in ops) and len(set(ops)) <= 1:
            # homogeneous UNION chain: one concat (+ one distinct)
            out = pa.concat_tables(aligned, promote_options="default")
            if ops and ops[0] == "union":
                out = out.group_by(out.column_names).aggregate([])
        else:
            # mixed chain folds left-to-right (the parser already nested
            # INTERSECT tighter)
            out = aligned[0]
            for op, t in zip(ops, aligned[1:]):
                if op == "union all":
                    out = pa.concat_tables([out, t], promote_options="default")
                elif op == "union":
                    out = pa.concat_tables([out, t], promote_options="default")
                    out = out.group_by(out.column_names).aggregate([])
                else:
                    out = _set_op(out, t, op)
        tm.set_rows(out.num_rows)
    if stmt.order_by:
        # reuse the SELECT sort machinery: expression keys evaluate
        # against the union output, DESC honored. The first member can
        # itself be a nested set-operation chain (INTERSECT binds
        # tighter than UNION), so descend to the first leaf SELECT for
        # a source context.
        first = stmt.selects[0]
        while not isinstance(first, SelectStatement):
            first = first.selects[0]
        sorter = SelectStatement(
            items=[SelectItem(Star(), None)],
            source=first.source,
            order_by=stmt.order_by,
            order_nulls=list(getattr(stmt, "order_nulls", ()) or ()),
        )
        with span("sql.sort", op="SortExec"):
            out = _apply_order(sorter, out, env=out)
    if stmt.offset:
        out = out.slice(stmt.offset)
    if stmt.limit is not None:
        out = out.slice(0, stmt.limit)
    return out


def _set_op(left: pa.Table, right: pa.Table, op: str) -> pa.Table:
    """INTERSECT / EXCEPT with bag ([ALL]) or set semantics, computed
    from per-row multiplicities via ONE concat + group_by — no join, so
    NULL key rows compare equal (SQL set-operation semantics; pyarrow
    joins would drop them)."""
    import numpy as np

    cols = list(left.column_names)
    lt = left.append_column("__side", pa.array(np.zeros(left.num_rows, np.int64)))
    rt = right.append_column("__side", pa.array(np.ones(right.num_rows, np.int64)))
    both = pa.concat_tables([lt, rt], promote_options="default")
    g = both.group_by(cols).aggregate([("__side", "sum"), ([], "count_all")])
    rc = g.column("__side_sum").to_numpy(zero_copy_only=False).astype(np.int64)
    total = g.column("count_all").to_numpy(zero_copy_only=False).astype(np.int64)
    lc = total - rc
    if op == "intersect":
        reps = ((lc > 0) & (rc > 0)).astype(np.int64)
    elif op == "intersect all":
        reps = np.minimum(lc, rc)
    elif op == "except":
        reps = ((lc > 0) & (rc == 0)).astype(np.int64)
    else:  # except all
        reps = np.maximum(lc - rc, 0)
    idx = np.repeat(np.arange(len(reps)), reps)
    return g.select(cols).take(pa.array(idx))


# -------------------------------------------------------- explain/analyze


def plan_select(stmt) -> list[tuple[int, str, str]]:
    """Physical plan tree for a SELECT as (indent, op_key, label) rows —
    the op_key matches the span operators execute_select records, so
    analyze can join metrics onto plan lines (the same contract the
    reference gets from DataFusion operator metrics, query.rs:756)."""
    if getattr(stmt, "ctes", None):
        import copy as _copy

        lines = []
        for name, sub, cols in stmt.ctes:
            lines.append((0, f"CteExec:{name}", f"CteExec: name={name}"
                          + (f" columns=[{', '.join(cols)}]" if cols else "")))
            for d, k, label in plan_select(sub):
                lines.append((d + 1, k, label))
        inner = _copy.copy(stmt)
        inner.ctes = []
        return lines + plan_select(inner)

    if isinstance(stmt, UnionStatement):
        label = (
            f"SetOpExec: [{', '.join(stmt.ops)}]"
            if stmt.ops and set(stmt.ops) - {"union", "union all"}
            else f"UnionExec: all={stmt.all}"
        )
        lines = [(0, "UnionExec", label)]
        for sel in stmt.selects:
            for d, k, label in plan_select(sel):
                lines.append((d + 1, k, label))
        return lines

    all_exprs = (
        [it.expr for it in stmt.items]
        + stmt.group_by
        + [stmt.having]
        + [e for e, _ in stmt.order_by]
    )
    aggs = _find_aggs(all_exprs)
    grouped = bool(stmt.group_by) or bool(aggs)

    lines: list[tuple[int, str, str]] = []
    depth = 0

    def emit(key: str, label: str):
        nonlocal depth
        lines.append((depth, key, label))
        depth += 1

    if stmt.limit is not None or stmt.offset:
        emit("GlobalLimitExec", f"GlobalLimitExec: limit={stmt.limit} offset={stmt.offset}")
    if stmt.distinct:
        emit("DistinctExec", "DistinctExec")
    if stmt.order_by:
        keys = ", ".join(
            f"{e.sql()} {'DESC' if d else 'ASC'}" for e, d in stmt.order_by
        )
        emit("SortExec", f"SortExec: [{keys}]")
    if grouped:
        emit(
            "AggregateExec",
            "AggregateExec: group_by=[%s], aggs=[%s]%s"
            % (
                ", ".join(e.sql() for e in stmt.group_by) or "",
                ", ".join(a.sql() for a in aggs),
                f", having=[{stmt.having.sql()}]" if stmt.having is not None else "",
            ),
        )
    else:
        emit(
            "ProjectionExec",
            "ProjectionExec: [%s]" % ", ".join(it.name for it in stmt.items),
        )
    wins = _find_windows(
        [it.expr for it in stmt.items if not isinstance(it.expr, Star)]
        + [e for e, _ in stmt.order_by]
    )
    if wins:
        emit(
            "WindowAggExec",
            "WindowAggExec: [%s]" % ", ".join(w.sql() for w in wins),
        )
    if stmt.where is not None and _has_corr_nodes(stmt.where):
        emit("CorrelatedFilterExec", "SubqueryFilterExec (per-row when correlated)")
    if stmt.joins:
        if stmt.where is not None:
            emit("FilterExec", f"FilterExec: [{stmt.where.sql()}]")
        join_depth = depth
        for j in reversed(stmt.joins):
            on = " AND ".join(f"{a.sql()} = {b.sql()}" for a, b in j.on)
            lines.append((join_depth, "HashJoinExec", f"HashJoinExec: type={j.how} on=[{on}]"))
            join_depth += 1
        base_depth = join_depth
        lines.append(
            (base_depth, f"ScanExec:{stmt.source.name}", _scan_label(stmt.source, None, None))
        )
        for i, j in enumerate(stmt.joins):
            lines.append(
                (base_depth - i, f"ScanExec:{j.source.name}", _scan_label(j.source, None, None))
            )
    else:
        src = stmt.source
        if src.kind == "fts":
            emit(
                f"FtsExec:{src.name}",
                f"FtsExec: table={src.name} query={src.fts_query.sql()}"
                + (f" k={src.fts_k.sql()}" if src.fts_k is not None else ""),
        )
        elif src.kind == "subquery":
            if stmt.where is not None:
                emit("FilterExec", f"FilterExec: [{stmt.where.sql()}]")
            for d, k, label in plan_select(src.subquery):
                lines.append((depth + d, k, label))
        else:
            has_star = any(isinstance(it.expr, Star) for it in stmt.items)
            aliases = {it.alias for it in stmt.items if it.alias}
            needed = None if has_star else sorted(
                _columns_of(
                    [it.expr for it in stmt.items]
                    + stmt.group_by
                    + [stmt.having, stmt.where]
                    + [e for e, _ in stmt.order_by]
                )
                - aliases
            )
            emit(f"ScanExec:{src.name}", _scan_label(src, stmt.where, needed))
    return lines


def _scan_label(src: TableSource, where, needed) -> str:
    if src.kind == "subquery":
        return "SubqueryExec"
    label = f"ScanExec: table={src.name}"
    if needed is not None:
        label += f" projection=[{', '.join(needed)}]"
    if where is not None:
        label += f" pushdown=[{where.sql()}]"
    return label


def explain_select(sql_or_stmt: str | SelectStatement) -> str:
    """Textual physical plan without executing (reference explain_plan
    over the DataFusion SQL layer)."""
    stmt = parse_select(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    return "\n".join("  " * d + label for d, _, label in plan_select(stmt))


def analyze_select(
    sql_or_stmt: str | SelectStatement,
    open_table: Callable[[str], Any],
) -> tuple[str, pa.Table]:
    """Execute a SELECT collecting per-operator metrics; returns the
    annotated plan text and the result (reference analyze_plan —
    DataFusion-style `metrics=[...]` per plan line)."""
    from .metrics import analyze

    stmt = parse_select(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    with analyze() as run:
        out = execute_select(stmt, open_table)
    op_metrics, elapsed = run.ops, run.elapsed_s
    plan = plan_select(stmt)
    # metrics are recorded per operator NAME; when a plan repeats a name
    # (subqueries, self-joins) the record is a sum over instances —
    # render it once, flagged as aggregated, instead of repeating the
    # total on every matching line
    key_counts: dict = {}
    for _, key, _ in plan:
        key_counts[key] = key_counts.get(key, 0) + 1
    shown: set = set()
    rendered = []
    for d, key, label in plan:
        rec = op_metrics.get(key)
        if rec and key not in shown:
            shown.add(key)
            bits = []
            if "output_rows" in rec:
                bits.append(f"output_rows={rec['output_rows']}")
            bits.append(f"elapsed_compute={rec['elapsed_s'] * 1e3:.2f}ms")
            if rec.get("invocations", 1) > 1:
                bits.append(f"invocations={rec['invocations']}")
            if key_counts[key] > 1:
                bits.append(f"aggregated_over={key_counts[key]} plan nodes")
            label += ", metrics=[%s]" % ", ".join(bits)
        rendered.append("  " * d + label)
    rendered.append(
        f"total: rows={out.num_rows} elapsed={elapsed * 1e3:.2f}ms"
    )
    return "\n".join(rendered), out


def _load_joined(stmt: SelectStatement, open_table) -> tuple[pa.Table, SelectStatement]:
    """Execute the FROM ... JOIN chain with Arrow hash joins; returns the
    joined table and the statement with qualified column references
    rewritten to the joined table's (possibly suffixed) column names.

    Reference behavior: DataFusion joins over TableProviders
    (table/datafusion.rs). Equality keys only; colliding non-key right
    columns are suffixed `_<alias>` (qualify them in SQL to address)."""

    from .metrics import span

    def load(src: TableSource) -> pa.Table:
        if src.kind == "table":
            with span("sql.scan", op=f"ScanExec:{src.name}") as tm:
                obj = open_table(src.name)
                # materialized CTE: already a host table
                out = obj if isinstance(obj, pa.Table) else obj.search(None).limit(None).to_arrow()
                tm.set_rows(out.num_rows)
            return out
        if src.kind == "subquery":
            return execute_select(src.subquery, open_table)
        raise InvalidInputError("fts() sources cannot be joined directly; wrap in a subquery")

    def side_of(col: Column) -> tuple[str | None, str]:
        if "." in col.name:
            q, c = col.name.split(".", 1)
            return q, c
        return None, col.name

    from .sql_spill import spilled_join, sql_memory_budget

    budget = sql_memory_budget()

    def lazy(src: TableSource):
        """(schema, batches_factory) without materializing base tables."""
        if src.kind == "table":
            obj = open_table(src.name)
            if isinstance(obj, pa.Table):
                return obj.schema, lambda: obj.to_batches()
            return obj.schema, lambda: obj.search(None).limit(None).to_batches()
        t = load(src)  # subqueries materialize through their own engine
        return t.schema, lambda: t.to_batches()

    env: dict[str, Expr] = {}
    if budget is None:
        data = load(stmt.source)
        left_names = list(data.schema.names)
        batches_factory = None
    else:
        # Grace mode: the base table streams; every join below radix-
        # partitions to disk instead of building a full-table hash side
        data = None
        lschema, batches_factory = lazy(stmt.source)
        left_names = list(lschema.names)

    def register(alias: str | None, names, suffix: str = ""):
        if alias is None:
            return
        for c in names:
            env[Column(f"{alias}.{c}").sql()] = Column(f"{c}{suffix}")

    base_alias = stmt.source.alias or stmt.source.name
    register(base_alias, left_names)
    for j in stmt.joins:
        if budget is None:
            right = load(j.source)
            right_schema = right.schema
            right_factory = None
        else:
            right_schema, right_factory = lazy(j.source)
        ralias = j.source.alias or j.source.name
        lkeys, rkeys = [], []
        for a, b in j.on:
            qa, ca = side_of(a)
            qb, cb = side_of(b)
            # orient the pair: the side qualified by the right alias is
            # the right key; anything else resolves against the left
            if qb == ralias or (qa == base_alias and qb is None):
                lq, lc, rc = qa, ca, cb
            elif qa == ralias:
                lq, lc, rc = qb, cb, ca
            else:
                lq, lc, rc = qa, ca, cb
            left_ref = env.get(Column(f"{lq}.{lc}").sql()) if lq else None
            lkeys.append(left_ref.name if isinstance(left_ref, Column) else lc)
            rkeys.append(rc)
        collide = (set(right_schema.names) - set(rkeys)) & set(left_names)
        suffix = f"_{ralias}" if collide else ""
        if budget is None:
            with span("sql.hash_join", op="HashJoinExec") as tm:
                data = data.join(
                    right, keys=lkeys, right_keys=rkeys, join_type=j.how,
                    right_suffix=suffix or None,
                )
                tm.set_rows(data.num_rows)
        else:
            # chain: this join's output stream is the next join's left.
            # The joined SCHEMA is derivable without executing (left
            # fields + non-key right fields, suffixed on collision), so
            # a later outer join over an EMPTY intermediate stream can
            # still synthesize its left side.
            def chained(prev=batches_factory, rf=right_factory, lk=list(lkeys),
                        rk=list(rkeys), how=j.how, sfx=suffix or None,
                        ls=lschema, rs=right_schema):
                return spilled_join(
                    prev(), rf(), lk, rk, how, budget,
                    right_suffix=sfx, left_schema=ls, right_schema=rs,
                )

            batches_factory = chained
            rkey_set = set(rkeys)
            joined_fields = list(lschema) + [
                pa.field(f"{f.name}{suffix}" if f.name in collide else f.name, f.type)
                for f in right_schema if f.name not in rkey_set
            ]
            lschema = pa.schema(joined_fields)
        register(ralias, right_schema.names)
        if suffix:
            for c in collide:
                env[Column(f"{ralias}.{c}").sql()] = Column(f"{c}{suffix}")
        # join keys coalesce into the left name
        for lc, rc in zip(lkeys, rkeys):
            env[Column(f"{ralias}.{rc}").sql()] = Column(lc)
        left_names = left_names + [
            f"{c}{suffix}" if c in collide else c
            for c in right_schema.names if c not in set(rkeys)
        ]

    if budget is not None:
        with span("sql.hash_join", op="HashJoinExec") as tm:
            parts = list(batches_factory())
            data = (
                pa.concat_tables(parts, promote_options="default")
                if parts else None
            )
            if data is None:
                # empty join result: synthesize the output schema
                fields = []
                seen = set()
                for n in left_names:
                    if n not in seen:
                        seen.add(n)
                        fields.append(pa.field(n, pa.null()))
                data = pa.Table.from_batches([], schema=pa.schema(fields))
            tm.set_rows(data.num_rows)

    def rw(e):
        return _replace(e, env) if e is not None else None

    new_stmt = SelectStatement(
        items=[SelectItem(rw(it.expr), it.alias) for it in stmt.items],
        source=stmt.source,
        joins=[],
        where=None,
        group_by=[rw(e) for e in stmt.group_by],
        having=rw(stmt.having),
        order_by=[(rw(e), d) for e, d in stmt.order_by],
        limit=stmt.limit,
        offset=stmt.offset,
        distinct=stmt.distinct,
    )
    if stmt.where is not None:
        push, corr = _split_correlated_where(stmt.where)
        if push is not None:
            with span("sql.filter", op="FilterExec") as tm:
                mask = evaluate_predicate_mask(data, rw(push))
                data = data.filter(pa.array(mask))
                tm.set_rows(data.num_rows)
        if corr is not None:
            # correlated residue: outer refs rewritten to the joined
            # layout; execute_select binds it per-row after the join
            new_stmt.where = rw(corr)
    return data, new_stmt


def _load_source(stmt: SelectStatement, open_table) -> pa.Table:
    src = stmt.source
    has_star = any(isinstance(it.expr, Star) for it in stmt.items)
    needed = None
    if not has_star:
        # select-item aliases shadow base columns in ORDER BY/HAVING —
        # they are outputs, not scan columns
        aliases = {it.alias for it in stmt.items if it.alias}
        exprs = (
            [it.expr for it in stmt.items]
            + stmt.group_by
            + [stmt.having, stmt.where, getattr(stmt, "_corr_where", None)]
            + [e for e, _ in stmt.order_by]
        )
        cols = _columns_of(exprs)
        # correlated subqueries reference outer columns from INSIDE the
        # subquery — those must survive projection pushdown
        src_alias = stmt.source.alias or stmt.source.name
        for e in exprs:
            if e is None:
                continue
            for nd in _walk(e):
                if isinstance(nd, (Subquery, Exists)):
                    for c in _free_columns(nd.stmt, open_table):
                        name = c.name
                        if "." in name:
                            q, tail = name.split(".", 1)
                            if q == src_alias:
                                cols.add(tail)
                        else:
                            cols.add(name)
        needed = sorted(cols - aliases)
    if src.kind == "dual":
        return pa.table({"__dual__": pa.array([0])})
    if src.kind == "table":
        from .metrics import span

        tbl = open_table(src.name)
        if isinstance(tbl, pa.Table):
            # materialized CTE: filter/project on the host
            with span("sql.scan", op=f"ScanExec:{src.name}") as tm:
                out = tbl
                if stmt.where is not None:
                    mask = evaluate_predicate_mask(out, stmt.where)
                    out = out.filter(pa.array(mask))
                if needed is not None:
                    cols = [c for c in needed if c in out.column_names]
                    if cols:
                        out = out.select(cols)
                tm.set_rows(out.num_rows)
            return out
        qb = tbl.search(None)
        if stmt.where is not None:
            qb = qb.where(stmt.where.sql())  # pushdown (incl. scalar indexes)
        if needed is not None:
            cols = [c for c in needed if c in tbl.schema.names]
            if cols:
                qb = qb.select(cols)
        with span("sql.scan", op=f"ScanExec:{src.name}") as tm:
            out = qb.to_arrow()
            tm.set_rows(out.num_rows)
        return out
    if src.kind == "fts":
        tbl = open_table(src.name)
        if isinstance(tbl, pa.Table):
            raise InvalidInputError("fts() requires an indexed base table, not a CTE")
        qv = src.fts_query
        if not isinstance(qv, Literal) or not isinstance(qv.value, str):
            raise InvalidInputError("fts() query must be a string literal")
        query: Any = qv.value
        if query.lstrip().startswith("{"):
            # reference udtf/fts.rs accepts a JSON-encoded structured
            # query; map it onto the FTS query AST
            query = _fts_query_from_json(query)
        k = tbl.count_rows()
        if src.fts_k is not None:
            if not isinstance(src.fts_k, Literal):
                raise InvalidInputError("fts() k must be an integer literal")
            k = int(src.fts_k.value)
        from .metrics import span

        with span("sql.fts", op=f"FtsExec:{src.name}") as tm:
            out = tbl._execute_fts(
                query, k=k, filter=stmt.where.sql() if stmt.where else None
            )
            tm.set_rows(out.num_rows)
        return out
    if src.kind == "subquery":
        from .metrics import span

        data = execute_select(src.subquery, open_table)
        if stmt.where is not None:
            with span("sql.filter", op="FilterExec") as tm:
                mask = evaluate_predicate_mask(data, stmt.where)
                data = data.filter(pa.array(mask))
                tm.set_rows(data.num_rows)
        return data
    raise AssertionError(src.kind)


def _fts_query_from_json(text: str):
    import json

    from .query_fts import fts_query_from_json

    try:
        return fts_query_from_json(json.loads(text))
    except ValueError as e:
        raise InvalidInputError(str(e)) from None


def _execute_plain(stmt: SelectStatement, data: pa.Table) -> pa.Table:
    from .metrics import span

    wins = _find_windows(
        [it.expr for it in stmt.items if not isinstance(it.expr, Star)]
        + [e for e, _ in stmt.order_by]
    )
    if wins:
        # windows evaluate over the post-WHERE row set, before projection
        # (standard SQL / DataFusion operator order)
        import copy as _copy

        wbind: dict[str, Expr] = {}
        with span("sql.window_agg", op="WindowAggExec") as tm:
            env = data
            for i, wf in enumerate(wins):
                env = env.append_column(f"__win{i}", _eval_window(data, wf))
                wbind[wf.sql()] = Column(f"__win{i}")
            data = env
            tm.set_rows(data.num_rows)
        stmt = _copy.copy(stmt)
        stmt.items = [
            it if isinstance(it.expr, Star)
            else SelectItem(_replace(it.expr, wbind), it.alias or it.name)
            for it in stmt.items
        ]
        stmt.order_by = [(_replace(e, wbind), d) for e, d in stmt.order_by]
    out_cols: dict[str, pa.Array] = {}
    for it in stmt.items:
        if isinstance(it.expr, Star):
            for name in data.column_names:
                if not name.startswith(("__win", "__corr")):
                    out_cols[name] = data.column(name)
        else:
            out_cols[it.name] = _as_array(evaluate_expression(data, it.expr), data.num_rows)
    out = pa.table(out_cols)
    if stmt.distinct:
        # DISTINCT precedes ORDER BY; afterwards sort keys must be
        # output columns (standard SQL restriction for DISTINCT)
        with span("sql.distinct", op="DistinctExec") as tm:
            out = out.group_by(out.column_names).aggregate([])
            tm.set_rows(out.num_rows)
        if stmt.order_by:
            with span("sql.sort", op="SortExec"):
                out = _apply_order(stmt, out, env=out)
        return out
    if stmt.order_by:
        with span("sql.sort", op="SortExec"):
            out = _apply_order(stmt, out, env=data)
    return out


def _grouped_prelude(stmt: SelectStatement, aggs: list[Aggregate]):
    """Shared planning for grouped execution: group-key / aggregate-input
    expressions with generated names, pyarrow agg specs, and the binding
    that maps original expressions to aggregated-output columns."""
    binding: dict[str, Expr] = {}  # expr.sql() -> Column placeholder
    key_exprs: list[tuple[str, Expr]] = []
    key_names: list[str] = []
    for i, ge in enumerate(stmt.group_by):
        name = f"__gk{i}"
        key_exprs.append((name, ge))
        binding[ge.sql()] = Column(name)
        key_names.append(name)
    agg_inputs: list[tuple[str, Expr]] = []
    agg_specs: list[tuple] = []
    transforms: list[tuple[str, str, object]] = []
    n_count_all = 0
    for j, ag in enumerate(aggs):
        if ag.func in ("corr", "covar_samp", "covar_pop"):
            # pairwise stats: NULL-pair-masked x/y/x·y (+ squares for
            # corr) reduce to sums+count; a post-transform combines them
            # (Postgres semantics: pairs with either side NULL excluded)
            if ag.arg2 is None:
                raise InvalidInputError(f"{ag.func}() requires two arguments")
            either_null = BinaryOp(
                "or", UnaryOp("is_null", ag.arg), UnaryOp("is_null", ag.arg2)
            )
            xm = Case(whens=((either_null, Literal(None)),), else_=ag.arg)
            ym = Case(whens=((either_null, Literal(None)),), else_=ag.arg2)
            base = f"__ain{j}"
            parts = {"x": xm, "y": ym, "xy": BinaryOp("mul", xm, ym)}
            if ag.func == "corr":
                parts["xx"] = BinaryOp("mul", xm, xm)
                parts["yy"] = BinaryOp("mul", ym, ym)
            names = {}
            for kx, ex in parts.items():
                nm = f"{base}_{kx}"
                agg_inputs.append((nm, ex))
                agg_specs.append((nm, "sum"))
                names[kx] = f"{nm}_sum"
            agg_specs.append((f"{base}_xy", "count"))
            names["n"] = f"{base}_xy_count"
            out_col = f"{base}__{ag.func}"
            binding[ag.sql()] = Column(out_col)
            transforms.append((out_col, ag.func, names))
            continue
        pa_fn, pa_opts = _PA_AGG[ag.func]
        if ag.func == "count_all":
            if n_count_all == 0:
                agg_specs.append(([], "count_all"))
                n_count_all = 1
            binding[ag.sql()] = Column("count_all")
        else:
            name = f"__ain{j}"
            agg_inputs.append((name, ag.arg))
            agg_specs.append(
                (name, pa_fn) if pa_opts is None else (name, pa_fn, pa_opts)
            )
            binding[ag.sql()] = Column(f"{name}_{pa_fn}")
            if ag.func == "string_agg":
                if not isinstance(ag.arg2, Literal) or not isinstance(ag.arg2.value, str):
                    raise InvalidInputError(
                        "string_agg() separator must be a string literal"
                    )
                transforms.append((f"{name}_{pa_fn}", "join", ag.arg2.value))
    return key_exprs, agg_inputs, agg_specs, binding, key_names, transforms


def _execute_grouped(stmt: SelectStatement, data: pa.Table, aggs: list[Aggregate],
                     open_table=None) -> pa.Table:
    for it in stmt.items:
        if isinstance(it.expr, Star):
            raise InvalidInputError("SELECT * cannot be combined with GROUP BY / aggregates")

    key_exprs, agg_inputs, agg_specs, binding, key_names, transforms = _grouped_prelude(stmt, aggs)
    pre: dict[str, pa.Array] = {}
    for name, e in key_exprs + agg_inputs:
        pre[name] = _as_array(evaluate_expression(data, e), data.num_rows)
    pre_tbl = pa.table(pre) if pre else pa.table({"__one": pa.array([1] * data.num_rows)})

    if key_names:
        env = pre_tbl.group_by(key_names).aggregate(agg_specs)
    else:
        # single implicit group
        env_cols: dict[str, pa.Array] = {}
        for spec in agg_specs:
            col, fn = spec[0], spec[1]
            opts = spec[2] if len(spec) > 2 else None
            if fn == "count_all":
                env_cols["count_all"] = pa.array([data.num_rows], type=pa.int64())
                continue
            arr = pre_tbl.column(col)
            if fn == "count":
                val = pc.count(arr).as_py()
            elif fn == "count_distinct":
                val = pc.count_distinct(arr).as_py()
            elif fn == "mean":
                val = pc.mean(arr).as_py()
            elif fn in ("stddev", "variance"):
                val = getattr(pc, fn)(arr, ddof=opts.ddof if opts else 0).as_py()
            elif fn == "list":
                # keep NULL elements (pyarrow hash 'list' and Postgres
                # array_agg do); string_agg's join transform skips them
                env_cols[f"{col}_{fn}"] = pa.array([arr.to_pylist()])
                continue
            else:
                val = getattr(pc, fn)(arr).as_py()
            env_cols[f"{col}_{fn}"] = pa.array([val])
        env = pa.table(env_cols) if env_cols else pa.table({"__dummy": pa.array([0])})

    env = _apply_agg_transforms(env, transforms)
    return _grouped_finish(stmt, env, binding, open_table)


def _execute_grouped_streaming(
    stmt: SelectStatement,
    batches,
    aggs: list[Aggregate],
    budget: int,
    stats: dict | None = None,
    source_schema: pa.Schema | None = None,
    open_table=None,
) -> pa.Table:
    """Grouped aggregation over a batch stream in bounded memory.

    Keyed: pre-columns evaluate per batch and radix-spill to disk
    (sql_spill.spilled_group_by) — working set is one batch + one
    partition. Keyless: running accumulators (count/sum/min/max/mean);
    COUNT(DISTINCT) keeps the distinct set, bounded by cardinality."""
    for it in stmt.items:
        if isinstance(it.expr, Star):
            raise InvalidInputError("SELECT * cannot be combined with GROUP BY / aggregates")
    key_exprs, agg_inputs, agg_specs, binding, key_names, transforms = _grouped_prelude(stmt, aggs)
    arg_of = dict(agg_inputs)

    if key_names:
        from .sql_spill import spilled_group_by

        def pre_batches():
            for b in batches:
                tb = pa.Table.from_batches([b]) if isinstance(b, pa.RecordBatch) else b
                cols = {
                    name: _as_array(evaluate_expression(tb, e), tb.num_rows)
                    for name, e in key_exprs + agg_inputs
                }
                yield pa.table(cols)

        # empty scans yield NO batches (zero-row batches are
        # suppressed), so precompute the pre-columns schema from a
        # 0-row source table for the empty-stream fallback
        empty_pre = None
        if source_schema is not None:
            try:
                et = source_schema.empty_table()
                empty_pre = pa.table({
                    name: _as_array(evaluate_expression(et, e), 0)
                    for name, e in key_exprs + agg_inputs
                }).schema
            except Exception:
                empty_pre = None
        env = spilled_group_by(
            pre_batches(), key_names, agg_specs, budget, stats=stats,
            schema=empty_pre,
        )
        env = _apply_agg_transforms(env, transforms)
        return _grouped_finish(stmt, env, binding, open_table)

    # keyless: one global group, O(1) state per aggregate (sum/sum² for
    # stddev/variance; bool_and/bool_or fold; median/array_agg
    # accumulate their column — bounded by that column's size, which the
    # result must hold anyway for array_agg)
    n_rows = 0
    state: dict[str, dict] = {
        name: {"sum": 0, "sum2": 0.0, "cnt": 0, "min": None, "max": None,
               "distinct": set(), "saw": False, "all": True, "any": False,
               "vals": []}
        for name, _ in agg_inputs
    }
    spec_fns = {}
    for spec in agg_specs:
        if spec[1] != "count_all":
            spec_fns.setdefault(spec[0], set()).add(spec[1])
    for b in batches:
        tb = pa.Table.from_batches([b]) if isinstance(b, pa.RecordBatch) else b
        n_rows += tb.num_rows
        if stats is not None:
            stats["peak_batch_bytes"] = max(stats.get("peak_batch_bytes", 0), tb.nbytes)
        for name, e in agg_inputs:
            arr = _as_array(evaluate_expression(tb, e), tb.num_rows)
            st = state[name]
            fns0 = spec_fns.get(name, set())
            if "list" in fns0 and len(arr):
                # all-NULL batches still contribute NULL elements
                st["vals"].extend(arr.to_pylist())
            cnt = pc.count(arr).as_py()
            if cnt:
                st["cnt"] += cnt
                st["saw"] = True
                fns = spec_fns.get(name, set())
                if fns & {"sum", "mean", "stddev", "variance"}:
                    st["sum"] += pc.sum(arr).as_py()
                if fns & {"stddev", "variance"}:
                    st["sum2"] += pc.sum(
                        pc.multiply(pc.cast(arr, pa.float64()), pc.cast(arr, pa.float64()))
                    ).as_py()
                if "min" in fns:
                    m = pc.min(arr).as_py()
                    st["min"] = m if st["min"] is None else min(st["min"], m)
                if "max" in fns:
                    m = pc.max(arr).as_py()
                    st["max"] = m if st["max"] is None else max(st["max"], m)
                if "count_distinct" in fns:
                    st["distinct"].update(v for v in arr.to_pylist() if v is not None)
                if "all" in fns:
                    st["all"] = st["all"] and bool(pc.all(arr).as_py())
                if "any" in fns:
                    st["any"] = st["any"] or bool(pc.any(arr).as_py())
                if "approximate_median" in fns and "list" not in fns:
                    st["vals"].extend(v for v in arr.to_pylist() if v is not None)
    env_cols: dict[str, pa.Array] = {}
    for spec in agg_specs:
        col, fn = spec[0], spec[1]
        opts = spec[2] if len(spec) > 2 else None
        if fn == "count_all":
            env_cols["count_all"] = pa.array([n_rows], type=pa.int64())
            continue
        st = state[col]
        if fn == "count":
            val = st["cnt"]
        elif fn == "count_distinct":
            val = len(st["distinct"])
        elif fn == "mean":
            val = (st["sum"] / st["cnt"]) if st["cnt"] else None
        elif fn == "sum":
            val = st["sum"] if st["saw"] else None
        elif fn == "min":
            val = st["min"]
        elif fn == "max":
            val = st["max"]
        elif fn in ("stddev", "variance"):
            ddof = opts.ddof if opts else 0
            c = st["cnt"]
            if c <= ddof:
                val = None
            else:
                var = max(st["sum2"] - st["sum"] * st["sum"] / c, 0.0) / (c - ddof)
                val = var if fn == "variance" else var ** 0.5
        elif fn == "approximate_median":
            val = pc.approximate_median(pa.array(st["vals"])).as_py() if st["vals"] else None
        elif fn == "list":
            env_cols[f"{col}_{fn}"] = pa.array([st["vals"]])
            continue
        elif fn == "all":
            val = st["all"] if st["saw"] else None
        elif fn == "any":
            val = st["any"] if st["saw"] else None
        else:
            raise InvalidInputError(f"unsupported streaming aggregate {fn!r}")
        env_cols[f"{col}_{fn}"] = pa.array([val])
    env = pa.table(env_cols) if env_cols else pa.table({"__dummy": pa.array([0])})
    env = _apply_agg_transforms(env, transforms)
    return _grouped_finish(stmt, env, binding, open_table)


def _apply_agg_transforms(env: pa.Table, transforms: list[tuple[str, str, object]]) -> pa.Table:
    """Post-aggregation column rewrites: string_agg joins its collected
    list with the separator (NULL elements skipped, Postgres-style;
    NULL group stays NULL)."""
    import numpy as np

    for col, kind, param in transforms:
        if kind == "join":
            arr = env.column(col)
            joined = pa.array(
                [
                    None if v is None
                    else str(param).join(str(x) for x in v if x is not None)
                    for v in arr.to_pylist()
                ],
                type=pa.string(),
            )
            env = env.set_column(env.schema.get_field_index(col), col, joined)
            continue
        # corr / covar_samp / covar_pop from sums + pair count
        names = param

        def fcol(nm):
            return pc.cast(env.column(nm), pa.float64()).to_numpy(zero_copy_only=False)

        n = fcol(names["n"])
        sx, sy, sxy = fcol(names["x"]), fcol(names["y"]), fcol(names["xy"])
        with np.errstate(invalid="ignore", divide="ignore"):
            if kind == "covar_pop":
                val = (sxy - sx * sy / n) / n
                bad = n < 1
            elif kind == "covar_samp":
                val = (sxy - sx * sy / n) / (n - 1)
                bad = n < 2
            else:  # corr
                sxx, syy = fcol(names["xx"]), fcol(names["yy"])
                den = np.sqrt((n * sxx - sx * sx) * (n * syy - sy * sy))
                val = (n * sxy - sx * sy) / den
                bad = n < 2
        bad = bad | ~np.isfinite(val)
        env = env.append_column(
            col, pa.array(np.where(bad, 0.0, val), mask=bad)
        )
    return env


def _grouped_finish(stmt: SelectStatement, env: pa.Table, binding: dict[str, Expr],
                    open_table=None) -> pa.Table:
    """Post-aggregation pipeline shared by the in-memory and spilled
    grouped paths: HAVING → window functions → projection → DISTINCT →
    ORDER BY."""
    # group keys with nulls: pyarrow group_by keeps null groups (SQL too)
    if stmt.having is not None:
        # HAVING may reference select-item aliases (HAVING n > 3 for
        # COUNT(*) AS n) — standard SQL / DataFusion behavior
        having_binding = dict(binding)
        for it in stmt.items:
            if it.alias and not isinstance(it.expr, Star):
                # standard SQL: a grouped COLUMN of the same name takes
                # precedence over the select alias in HAVING
                having_binding.setdefault(
                    Column(it.alias).sql(), _replace(it.expr, binding)
                )
        bound_having = _replace(stmt.having, having_binding)
        if _has_corr_nodes(bound_having):
            # correlated HAVING: the outer row is the GROUP row (keys +
            # aggregates) — bind the subquery per distinct group key
            # (reference gets this from DataFusion's decorrelation,
            # table/datafusion.rs:37-44). The group env uses internal
            # __gk/agg column names; expose the binding's plain names
            # so correlation variables (`dept`, `e.dept`) resolve.
            if open_table is None:
                raise InvalidInputError(
                    "correlated subqueries in HAVING are not supported here"
                )
            alias_cols: list[str] = []
            for k, v in binding.items():
                nm = k.strip("`")
                if nm in env.column_names or not all(
                    ch.isalnum() or ch in "_." for ch in nm
                ):
                    continue
                try:
                    arr = _as_array(evaluate_expression(env, v), env.num_rows)
                except Exception:
                    continue
                env = env.append_column(nm, arr)
                alias_cols.append(nm)
            corr_counter = [0]
            bound_having, env = _bind_correlated_expr(
                env, bound_having, open_table, corr_counter
            )
            mask = evaluate_predicate_mask(env, bound_having)
            env = env.filter(pa.array(mask))
            drop = alias_cols + [c for c in env.column_names if c.startswith("__corr")]
            if drop:
                env = env.drop_columns(drop)
        else:
            mask = evaluate_predicate_mask(env, bound_having)
            env = env.filter(pa.array(mask))

    from .metrics import span

    # window functions over the AGGREGATED rows (DataFusion: windows
    # execute after GROUP BY/HAVING; their args may reference group
    # keys and aggregates)
    wins = _find_windows(
        [_replace(it.expr, binding) for it in stmt.items]
        + [_replace(e, binding) for e, _ in stmt.order_by]
    )
    if wins:
        with span("sql.window_agg", op="WindowAggExec") as tm:
            for i, wf in enumerate(wins):
                for nd in _walk(wf):
                    if isinstance(nd, Aggregate):
                        raise InvalidInputError(
                            f"aggregate {nd.sql()} not resolvable inside window "
                            "(is it missing from the GROUP BY context?)"
                        )
                    if (
                        isinstance(nd, Column)
                        and not nd.name.startswith("__")
                        and nd.name not in env.column_names
                    ):
                        raise InvalidInputError(
                            f"column {nd.name!r} must appear in GROUP BY or inside an aggregate"
                        )
                env = env.append_column(f"__win{i}", _eval_window(env, wf))
                binding[wf.sql()] = Column(f"__win{i}")
            tm.set_rows(env.num_rows)

    out_cols: dict[str, pa.Array] = {}
    for it in stmt.items:
        bound = _replace(it.expr, binding)
        for n in _walk(bound):
            if isinstance(n, Aggregate):
                raise InvalidInputError(
                    f"aggregate {n.sql()} not resolvable (is it missing from GROUP BY context?)"
                )
            if isinstance(n, Column) and not n.name.startswith("__") and n.name not in env.column_names:
                raise InvalidInputError(
                    f"column {n.name!r} must appear in GROUP BY or inside an aggregate"
                )
        out_cols[it.name] = _as_array(evaluate_expression(env, bound), env.num_rows)
    out = pa.table(out_cols)
    if stmt.distinct:
        with span("sql.distinct", op="DistinctExec") as tm:
            out = out.group_by(out.column_names).aggregate([])
            tm.set_rows(out.num_rows)
        if stmt.order_by:
            with span("sql.sort", op="SortExec"):
                out = _apply_order(stmt, out, env=out)
        return out
    if stmt.order_by:
        with span("sql.sort", op="SortExec"):
            out = _apply_order(stmt, out, env=env, binding=binding)
    return out


def _apply_order(
    stmt: SelectStatement, out: pa.Table, env: pa.Table, binding: dict[str, Expr] | None = None
) -> pa.Table:
    sort_cols = []
    aux: dict[str, pa.Array] = {}
    alias_map = {it.name: it.expr for it in stmt.items if not isinstance(it.expr, Star)}
    order_nulls = list(getattr(stmt, "order_nulls", ()) or ())

    def add_key(idx: int, name: str, arr, direction: str, desc: bool) -> None:
        # SQL null placement (DataFusion/Postgres: nulls sort HIGH, so
        # ASC → last, DESC → first; explicit NULLS FIRST/LAST wins).
        # pyarrow always puts nulls at the end, so a null flag key is
        # prepended whenever the column has nulls and the wanted
        # placement differs per key.
        nulls = order_nulls[idx] if idx < len(order_nulls) else None
        if nulls is None:
            nulls = "first" if desc else "last"
        col_arr = arr if arr is not None else out.column(name)
        null_count = (
            col_arr.null_count if hasattr(col_arr, "null_count") else 0
        )
        if null_count:
            flag = pc.is_null(col_arr)
            fname = f"__nullord{idx}"
            aux[fname] = flag
            sort_cols.append(
                (fname, "descending" if nulls == "first" else "ascending")
            )
        if arr is not None:
            aux[name] = arr
        sort_cols.append((name, direction))

    for idx, (e, desc) in enumerate(stmt.order_by):
        direction = "descending" if desc else "ascending"
        # alias or projected column reference → sort the output column
        if isinstance(e, Column) and e.name in out.column_names:
            add_key(idx, e.name, None, direction, desc)
            continue
        if isinstance(e, Column) and e.name in alias_map and e.name in out.column_names:
            add_key(idx, e.name, None, direction, desc)
            continue
        if isinstance(e, Column) and e.name in alias_map:
            sort_cols.append((e.name, direction))
            continue
        be = _replace(e, binding) if binding else e
        arr = _as_array(evaluate_expression(env, be), env.num_rows)
        if out.num_rows != env.num_rows:
            raise InvalidInputError("ORDER BY expression must be computable on the result")
        add_key(idx, f"__ord{idx}", arr, direction, desc)
    if aux:
        combined = out
        for n, a in aux.items():
            combined = combined.append_column(n, a)
        idxs = pc.sort_indices(combined, sort_keys=sort_cols)
        return out.take(idxs)
    return out.sort_by(sort_cols)


def _as_array(v, num_rows: int) -> pa.Array:
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    if isinstance(v, pa.Array):
        return v
    if isinstance(v, pa.Scalar):
        return pa.array([v.as_py()] * num_rows, type=v.type)
    return pa.array([v] * num_rows)
