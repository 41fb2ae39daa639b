"""Evaluate filter/projection ASTs against Arrow data.

This is the host half of the filter pipeline. Predicates evaluate to
boolean masks with SQL three-valued-logic handled by pyarrow compute;
the mask is then either applied host-side (postfilter) or shipped to
the device as a row bitmask consumed inside the scan kernels
(prefilter) — matching the reference's prefilter/postfilter split
(reference: rust/lancedb/src/query.rs `prefilter`, SURVEY.md §7).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import InvalidInputError, SqlParseError
from .sql import (
    Case,
    Between,
    BinaryOp,
    Cast,
    Column,
    Expr,
    FunctionCall,
    Literal,
    UnaryOp,
    parse_sql_expr,
)

_CAST_TYPES = {
    "int": pa.int64(), "integer": pa.int64(), "bigint": pa.int64(),
    "smallint": pa.int16(), "tinyint": pa.int8(),
    "float": pa.float32(), "real": pa.float32(),
    "double": pa.float64(),
    "string": pa.string(), "varchar": pa.string(), "text": pa.string(),
    "boolean": pa.bool_(), "bool": pa.bool_(),
    "timestamp": pa.timestamp("us"),
    "date": pa.date32(),
}

# function registry: name -> callable(args...) -> Array/Scalar
_FUNCTIONS = {
    "lower": lambda a: pc.utf8_lower(a),
    "upper": lambda a: pc.utf8_upper(a),
    "length": lambda a: pc.utf8_length(a),
    "char_length": lambda a: pc.utf8_length(a),
    "trim": lambda a: pc.utf8_trim_whitespace(a),
    "ltrim": lambda a: pc.utf8_ltrim_whitespace(a),
    "rtrim": lambda a: pc.utf8_rtrim_whitespace(a),
    "abs": lambda a: pc.abs(a),
    "ceil": lambda a: pc.ceil(a),
    "floor": lambda a: pc.floor(a),
    "round": lambda a, nd=None: pc.round(a, ndigits=int(_scalar(nd)) if nd is not None else 0),
    "sqrt": lambda a: pc.sqrt(a),
    "exp": lambda a: pc.exp(a),
    "ln": lambda a: pc.ln(a),
    "log10": lambda a: pc.log10(a),
    "power": lambda a, b: pc.power(a, b),
    "pow": lambda a, b: pc.power(a, b),
    "coalesce": lambda *args: pc.coalesce(*args),
    "starts_with": lambda a, b: pc.starts_with(a, pattern=_scalar(b)),
    "ends_with": lambda a, b: pc.ends_with(a, pattern=_scalar(b)),
    "contains": lambda a, b: pc.match_substring(a, pattern=_scalar(b)),
    "regexp_match": lambda a, b: pc.match_substring_regex(a, pattern=_scalar(b)),
    "is_nan": lambda a: pc.is_nan(a),
    "array_length": lambda a: pc.list_value_length(a),
    "array_has": lambda a, b: _array_has(a, b),
    "date_part": lambda part, a: _date_part(_scalar(part), a),
    "to_timestamp": lambda a: pc.cast(a, pa.timestamp("us")),
    "timestamp": lambda a: pc.cast(a, pa.timestamp("us")),
    "date": lambda a: pc.cast(a, pa.date32()),
    "greatest": lambda *args: pc.max_element_wise(*args),
    "least": lambda *args: pc.min_element_wise(*args),
    "concat": lambda *args: _concat(*args, null_handling="skip"),
    # string surface (DataFusion names; 1-based SQL indexing)
    "substr": lambda a, start, ln=None: _substr(a, start, ln),
    "substring": lambda a, start, ln=None: _substr(a, start, ln),
    "replace": lambda a, pat, rep: pc.replace_substring(
        a, pattern=_scalar(pat), replacement=_scalar(rep)
    ),
    "strpos": lambda a, sub: pc.add(pc.find_substring(a, pattern=_scalar(sub)), 1),
    "position": lambda a, sub: pc.add(pc.find_substring(a, pattern=_scalar(sub)), 1),
    "left": lambda a, n: _left(a, n),
    "right": lambda a, n: _right(a, n),
    "lpad": lambda a, n, fill=" ": pc.utf8_lpad(
        a, width=int(_scalar(n)), padding=_scalar(fill)
    ),
    "rpad": lambda a, n, fill=" ": pc.utf8_rpad(
        a, width=int(_scalar(n)), padding=_scalar(fill)
    ),
    "reverse": lambda a: pc.utf8_reverse(a),
    "initcap": lambda a: pc.utf8_title(a),
    "split_part": lambda a, sep, n: _split_part(a, sep, n),
    # numeric / conditional
    # NULLIF(a, b) = NULL only when a = b is TRUE; a null comparison
    # (either side NULL) keeps a, so coalesce the condition to false
    "nullif": lambda a, b: pc.if_else(
        pc.fill_null(pc.equal(a, b), False),
        pa.scalar(None, type=getattr(a, "type", None) or pa.null()),
        a,
    ),
    "ifnull": lambda a, b: pc.coalesce(a, b),
    "nvl": lambda a, b: pc.coalesce(a, b),
    "sign": lambda a: pc.sign(a),
    "trunc": lambda a: pc.trunc(a),
    "log": lambda base, a=None: pc.log10(base) if a is None else pc.logb(a, base),
    "log2": lambda a: pc.log2(a),
    "sin": lambda a: pc.sin(a),
    "cos": lambda a: pc.cos(a),
    "tan": lambda a: pc.tan(a),
    "asin": lambda a: pc.asin(a),
    "acos": lambda a: pc.acos(a),
    "atan": lambda a: pc.atan(a),
    "atan2": lambda a, b: pc.atan2(a, b),
    # temporal
    "date_trunc": lambda part, a: pc.floor_temporal(a, unit=_scalar(part).lower()),
}


def _concat(*args, null_handling: str = "emit_null"):
    """SQL concat: cast every operand to string and join element-wise.

    The || operator propagates NULL (emit_null); the concat() function
    skips NULL arguments, matching DataFusion/Postgres."""
    casted = [
        a if (hasattr(a, "type") and pa.types.is_string(a.type)) else pc.cast(a, pa.string())
        for a in args
    ]
    return pc.binary_join_element_wise(*casted, "", null_handling=null_handling)


def _scalar(v):
    if isinstance(v, pa.Scalar):
        return v.as_py()
    return v


def _substr(a, start, ln=None):
    """SQL substr: 1-based start; non-positive starts count from the
    virtual position (Postgres: substr('apple', 0, 3) = 'ap')."""
    s = int(_scalar(start)) - 1  # 0-based, may be negative
    if ln is None:
        return pc.utf8_slice_codeunits(a, max(s, 0), None)
    stop = s + max(int(_scalar(ln)), 0)  # exclusive end in virtual coords
    s = max(s, 0)
    return pc.utf8_slice_codeunits(a, s, max(stop, s))


def _left(a, n):
    k = int(_scalar(n))
    if k >= 0:
        return pc.utf8_slice_codeunits(a, 0, k)
    # negative n: everything except the last |n| chars (Postgres)
    return pc.utf8_reverse(pc.utf8_slice_codeunits(pc.utf8_reverse(a), -k, None))


def _right(a, n):
    k = int(_scalar(n))
    if k == 0:
        return pc.utf8_slice_codeunits(a, 0, 0)
    if k < 0:
        # negative n: everything except the first |n| chars (Postgres)
        return pc.utf8_slice_codeunits(a, -k, None)
    return pc.utf8_reverse(pc.utf8_slice_codeunits(pc.utf8_reverse(a), 0, k))


def _split_part(a, sep, n):
    """split_part(s, sep, n): 1-based nth field, '' past the end."""
    k = int(_scalar(n))
    if k <= 0:
        raise InvalidInputError("split_part() field index must be positive")
    splits = pc.split_pattern(a, pattern=_scalar(sep))
    lens = pc.list_value_length(splits)
    valid = pc.and_(pc.is_valid(lens), pc.greater_equal(lens, k))
    picked = pc.if_else(
        valid, pc.list_element(_pad_lists(splits, k), k - 1), pa.scalar("", pa.string())
    )
    return pc.if_else(pc.is_valid(a), picked, pa.scalar(None, pa.string()))


def _pad_lists(splits, k):
    """Pad each list to length >= k so list_element(k-1) never throws."""
    lens = pc.list_value_length(splits)
    shortest = pc.min(pc.fill_null(lens, k)).as_py()  # None on empty input
    if shortest is not None and shortest >= k:
        return splits
    py = splits.to_pylist()
    return pa.array(
        [(v or []) + [""] * (k - len(v or [])) for v in py], type=pa.list_(pa.string())
    )


def _array_has(arr, val):
    """list-column membership: does the list contain val? (NULL list → NULL)"""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    v = _scalar(val)
    flat = pc.list_flatten(arr)
    parent = pc.list_parent_indices(arr)
    hit = np.asarray(pc.fill_null(pc.equal(flat, pa.scalar(v)), False))
    out = np.zeros(len(arr), dtype=bool)
    out[parent.to_numpy(zero_copy_only=False)[hit]] = True
    isnull = np.asarray(pc.is_null(arr))
    return pa.array(out, mask=isnull)


def _date_part(part: str, a):
    part = part.lower()
    fns = {
        "year": pc.year, "month": pc.month, "day": pc.day, "hour": pc.hour,
        "minute": pc.minute, "second": pc.second, "dow": pc.day_of_week,
        "doy": pc.day_of_year,
    }
    if part not in fns:
        raise SqlParseError(f"unsupported date_part {part!r}")
    return fns[part](a)


class Evaluator:
    """Evaluates an AST against one RecordBatch/Table."""

    def __init__(self, data: pa.Table | pa.RecordBatch):
        self.data = data
        self.num_rows = data.num_rows

    def _column(self, name: str):
        cols = self.data.schema.names
        # a dotted name may itself be a column (e.g. merge_insert exposes
        # 'target.price' / 'source.price' as flat columns)
        if "." in name and name in cols:
            if isinstance(self.data, pa.Table):
                return self.data.column(name)
            return self.data.column(cols.index(name))
        parts = name.split(".")
        # exact match first (case-preserving like reference expr `col()`)
        if name in cols:
            return self.data.column(name) if isinstance(self.data, pa.Table) else self.data.column(cols.index(name))
        # case-insensitive fallback
        lowered = {c.lower(): c for c in cols}
        if parts[0] not in cols and parts[0].lower() in lowered:
            parts[0] = lowered[parts[0].lower()]
        if parts[0] not in cols:
            raise SqlParseError(f"unknown column {name!r}; available: {cols}")
        arr = self.data.column(parts[0]) if isinstance(self.data, pa.Table) else self.data.column(cols.index(parts[0]))
        for field_name in parts[1:]:
            arr = pc.struct_field(arr, field_name)
        return arr

    def evaluate(self, e: Expr):
        if isinstance(e, Literal):
            if isinstance(e.value, (list, tuple)):
                return e.value  # only valid as the RHS of IN
            return pa.scalar(e.value)
        if isinstance(e, Column):
            return self._column(e.name)
        if isinstance(e, UnaryOp):
            if e.op == "not":
                return pc.invert(self._as_bool(self.evaluate(e.operand)))
            if e.op == "neg":
                return pc.negate(self.evaluate(e.operand))
            if e.op == "is_null":
                return pc.is_null(self.evaluate(e.operand))
            if e.op == "is_not_null":
                return pc.is_valid(self.evaluate(e.operand))
            raise AssertionError(e.op)
        if isinstance(e, BinaryOp):
            return self._binary(e)
        if isinstance(e, Case):
            return self._case(e)
        if isinstance(e, Between):
            v = self.evaluate(e.operand)
            lo = self.evaluate(e.low)
            hi = self.evaluate(e.high)
            res = pc.and_kleene(
                self._as_bool(pc.greater_equal(v, lo)), self._as_bool(pc.less_equal(v, hi))
            )
            return pc.invert(res) if e.negated else res
        if isinstance(e, FunctionCall):
            fn = _FUNCTIONS.get(e.name)
            if fn is None:
                raise SqlParseError(f"unsupported function {e.name!r}")
            args = [self.evaluate(a) for a in e.args]
            return fn(*args)
        if isinstance(e, Cast):
            ty = _CAST_TYPES.get(e.type_name)
            if ty is None:
                raise SqlParseError(f"unsupported CAST target {e.type_name!r}")
            return pc.cast(self.evaluate(e.operand), ty, safe=False)
        raise AssertionError(type(e))

    def _binary(self, e: BinaryOp):
        op = e.op
        if op in ("and", "or"):
            left = self._as_bool(self.evaluate(e.left))
            right = self._as_bool(self.evaluate(e.right))
            return pc.and_kleene(left, right) if op == "and" else pc.or_kleene(left, right)
        if op in ("in", "not_in"):
            left = self.evaluate(e.left)
            values = e.right.value if isinstance(e.right, Literal) else self.evaluate(e.right)
            if not isinstance(values, (list, tuple)):
                raise SqlParseError("IN requires a literal list")
            res = pc.is_in(left, value_set=pa.array(list(values)))
            # SQL 3VL: NULL IN (...) is NULL (is_in says false), and an
            # unmatched x against a list containing NULL is NULL too;
            # invert then propagates NULL for NOT IN (Kleene negation)
            null_b = pa.scalar(None, pa.bool_())
            if any(v is None for v in values):
                res = pc.if_else(res, pa.scalar(True), null_b)
            res = pc.if_else(pc.is_valid(left), res, null_b)
            return pc.invert(res) if op == "not_in" else res
        if op in ("like", "not_like"):
            left = self.evaluate(e.left)
            pattern = _scalar(self.evaluate(e.right))
            res = pc.match_like(left, pattern)
            return pc.invert(res) if op == "not_like" else res
        left = self.evaluate(e.left)
        right = self.evaluate(e.right)
        fns = {
            "eq": pc.equal, "ne": pc.not_equal, "lt": pc.less, "le": pc.less_equal,
            "gt": pc.greater, "ge": pc.greater_equal, "add": pc.add, "sub": pc.subtract,
            "mul": pc.multiply, "div": pc.divide, "mod": _mod,
            "concat": _concat,
        }
        return fns[op](left, right)

    def _case(self, e: Case):
        """CASE with SQL short-circuit semantics: each THEN/ELSE branch
        evaluates ONLY on the rows its condition selects (a take over
        the matched subset), so guarded expressions never fault on
        unmatched rows (e.g. CASE WHEN b != 0 THEN a / b ELSE 0 END).
        NULL conditions count as not-matched, per the standard."""
        n = self.num_rows
        remaining = np.ones(n, dtype=bool)
        branches = list(e.whens) + [(None, e.else_)]
        idx_parts: list[np.ndarray] = []
        val_parts: list[pa.Array] = []
        for cond, val in branches:
            if not remaining.any():
                break
            if cond is None:
                sel = remaining.copy()
            else:
                c = self._as_bool(self.evaluate(cond))
                if isinstance(c, pa.Scalar):
                    hit = bool(c.as_py()) if c.as_py() is not None else False
                    sel = remaining.copy() if hit else np.zeros(n, dtype=bool)
                else:
                    cn = c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c
                    sel = remaining & np.asarray(
                        pc.fill_null(cn, False).to_numpy(zero_copy_only=False)
                    )
            if not sel.any():
                continue
            remaining &= ~sel
            idx = np.nonzero(sel)[0]
            if val is None:
                idx_parts.append(idx)
                val_parts.append(None)  # typed null, resolved below
                continue
            sub = Evaluator(self.data.take(pa.array(idx)))
            v = sub.evaluate(val)
            if isinstance(v, pa.Scalar):
                v = pa.array([v.as_py()] * len(idx), type=v.type)
            elif isinstance(v, pa.ChunkedArray):
                v = v.combine_chunks()
            idx_parts.append(idx)
            val_parts.append(v)
        # resolve output type from the first typed part
        out_type = next(
            (v.type for v in val_parts if v is not None and not pa.types.is_null(v.type)),
            pa.null(),
        )
        arrays = []
        for idx, v in zip(idx_parts, val_parts):
            if v is None or pa.types.is_null(v.type):
                v = pa.nulls(len(idx), type=out_type)
            elif v.type != out_type:
                v = pc.cast(v, out_type)
            arrays.append(v)
        if not arrays:
            # no branch matched any row (e.g. zero-row input): a bare
            # pa.nulls(n) is null-typed and breaks downstream kernels
            # (coalesce/equal have no (int64, null) variants), so infer
            # the output type by evaluating a branch on the empty slice
            empty = Evaluator(self.data.slice(0, 0))
            for _, val in branches:
                if val is None:
                    continue
                try:
                    v = empty.evaluate(val)
                except Exception:
                    continue
                t = v.type
                if not pa.types.is_null(t):
                    return pa.nulls(n, type=t)
            return pa.nulls(n)
        combined = pa.concat_arrays(arrays)
        order = np.empty(n, dtype=np.int64)
        all_idx = np.concatenate(idx_parts)
        order[all_idx] = np.arange(len(all_idx))
        return combined.take(pa.array(order))

    def _as_bool(self, arr):
        if isinstance(arr, pa.Scalar):
            return pa.scalar(bool(arr.as_py()), type=pa.bool_())
        if pa.types.is_boolean(arr.type):
            return arr
        raise SqlParseError("expected a boolean expression")


def _mod(a, b):
    """SQL % is truncated remainder (sign of the dividend), matching
    DataFusion/PostgreSQL: -7 % 3 = -1, not Python's floored 2."""
    def _is_int(x):
        t = x.type if hasattr(x, "type") else None
        return t is not None and (pa.types.is_integer(t))

    int_in = _is_int(a) and _is_int(b)
    fa = pc.cast(a, pa.float64())
    fb = pc.cast(b, pa.float64())
    out = pc.subtract(fa, pc.multiply(pc.trunc(pc.divide(fa, fb)), fb))
    return pc.cast(out, pa.int64()) if int_in else out


def evaluate_predicate_mask(
    data: pa.Table | pa.RecordBatch, predicate: str | Expr
) -> np.ndarray:
    """Evaluate a boolean predicate → numpy bool mask (NULL ⇒ False)."""
    ast = parse_sql_expr(predicate) if isinstance(predicate, str) else predicate
    try:
        out = Evaluator(data).evaluate(ast)
    except pa.lib.ArrowInvalid as e:
        raise InvalidInputError(f"predicate failed: {e}") from None
    except pa.lib.ArrowNotImplementedError as e:
        raise InvalidInputError(f"type error in predicate: {e}") from None
    if isinstance(out, pa.Scalar):
        v = out.as_py()
        return np.full(data.num_rows, bool(v) if v is not None else False)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    if not pa.types.is_boolean(out.type):
        raise SqlParseError("filter must be a boolean expression")
    # NULL → False (SQL WHERE semantics)
    out = pc.fill_null(out, False)
    return np.asarray(out)


def evaluate_expression(data: pa.Table | pa.RecordBatch, expr: str | Expr) -> pa.Array:
    """Evaluate a scalar expression column-wise (for dynamic SELECT /
    update assignments / add_columns backfill)."""
    ast = parse_sql_expr(expr) if isinstance(expr, str) else expr
    try:
        out = Evaluator(data).evaluate(ast)
    except pa.lib.ArrowInvalid as e:
        raise InvalidInputError(f"expression failed: {e}") from None
    except pa.lib.ArrowNotImplementedError as e:
        # type mismatches (e.g. int + string) surface as typed errors
        raise InvalidInputError(f"type error in expression: {e}") from None
    if isinstance(out, pa.Scalar):
        return pa.array([out.as_py()] * data.num_rows, type=out.type)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    return out


def referenced_columns(e: Expr) -> set[str]:
    """Top-level column names referenced by an expression (for projection
    pushdown when scanning fragments)."""
    out: set[str] = set()

    def walk(node: Expr):
        if isinstance(node, Column):
            out.add(node.name.split(".")[0])
        elif isinstance(node, Case):
            for c, v in node.whens:
                walk(c)
                walk(v)
            if node.else_ is not None:
                walk(node.else_)
        elif isinstance(node, UnaryOp):
            walk(node.operand)
        elif isinstance(node, BinaryOp):
            walk(node.left)
            walk(node.right)
        elif isinstance(node, Between):
            walk(node.operand), walk(node.low), walk(node.high)
        elif isinstance(node, FunctionCall):
            for a in node.args:
                walk(a)
        elif isinstance(node, Cast):
            walk(node.operand)

    walk(e)
    return out
