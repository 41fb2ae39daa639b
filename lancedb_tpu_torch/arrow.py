"""Arrow interchange: sanitize arbitrary user data into Arrow tables.

Covers the input surface of the reference Python SDK (list-of-dicts,
dict-of-lists, pandas, polars, numpy vectors, Arrow tables/batches/
readers, pydantic LanceModel rows — reference python table.py `add`,
nodejs arrow.ts sanitization) plus vector-column inference: uniform-
length numeric list columns become FixedSizeList<float32> so they are
index-able on device.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import pyarrow as pa

from .errors import InvalidInputError, SchemaError

VECTOR_COLUMN_NAME = "vector"


def flatten_columns(tbl: pa.Table, flatten=None) -> pa.Table:
    """Flatten struct columns: ``True`` flattens until no structs
    remain, a positive int flattens that many levels, None/False is a
    no-op (reference util.py:160 flatten_columns)."""
    if flatten is True:
        while any(pa.types.is_struct(f.type) for f in tbl.schema):
            tbl = tbl.flatten()
    elif isinstance(flatten, int) and not isinstance(flatten, bool):
        if flatten <= 0:
            raise ValueError("flatten must be a positive integer or True")
        for _ in range(flatten):
            tbl = tbl.flatten()
    return tbl


def vector(dim: int, value_type: pa.DataType = pa.float32()) -> pa.DataType:
    """Schema helper: a vector column type (reference python schema.py `vector`)."""
    return pa.list_(value_type, dim)


def is_vector_type(t: pa.DataType) -> bool:
    return pa.types.is_fixed_size_list(t) and (
        pa.types.is_floating(t.value_type) or t.value_type in (pa.uint8(), pa.int8())
    )


def is_multivector_type(t: pa.DataType) -> bool:
    """A list of float vectors per row (the reference's
    index/multivector.py is_multivector_type)."""
    return (
        (pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_fixed_size_list(t))
        and pa.types.is_fixed_size_list(t.value_type)
        and pa.types.is_floating(t.value_type.value_type)
    )


def refuse_multivector(schema: pa.Schema, column: str) -> None:
    """Multivector columns wait for a later slice: raise before any work."""
    if column in schema.names and is_multivector_type(schema.field(column).type):
        raise NotImplementedError(
            f"column {column!r} holds multivectors, which are not ported to "
            "lancedb_tpu_torch yet (ROADMAP A9)"
        )


def sanitize_vectors(
    table: pa.Table, on_bad_vectors: str = "error", fill_value: float = 0.0
) -> pa.Table:
    """Handle bad vectors — null entries or non-finite elements — per
    the reference's on_bad_vectors modes (python table.py:331-376):
    'error' raises, 'drop' removes the rows, 'fill' replaces the vector
    with fill_value, 'null' nulls the entry."""
    if on_bad_vectors not in ("error", "drop", "fill", "null"):
        raise InvalidInputError(
            f"on_bad_vectors must be error|drop|fill|null, got {on_bad_vectors!r}"
        )
    drop_mask = None
    for i, field in enumerate(table.schema):
        if not is_vector_type(field.type) or not pa.types.is_floating(field.type.value_type):
            continue
        col = table.column(i).combine_chunks()
        if isinstance(col, pa.ChunkedArray):
            col = col.chunk(0) if col.num_chunks else pa.array([], type=field.type)
        dim = field.type.list_size
        flat = col.values.to_numpy(zero_copy_only=False)
        mat = np.asarray(flat, dtype=np.float64).reshape(-1, dim)
        bad = ~np.isfinite(mat).all(axis=1)
        if col.null_count:
            bad |= np.asarray(col.is_null())
        if not bad.any():
            continue
        if on_bad_vectors == "error":
            raise InvalidInputError(
                f"{int(bad.sum())} bad vector(s) in column {field.name!r} "
                "(null or non-finite); pass on_bad_vectors='drop'|'fill'|'null'"
            )
        if on_bad_vectors == "drop":
            drop_mask = bad if drop_mask is None else (drop_mask | bad)
            continue
        if on_bad_vectors == "fill":
            mat = mat.copy()
            mat[bad] = float(fill_value)
            fixed = pa.FixedSizeListArray.from_arrays(
                pa.array(mat.ravel().astype(flat.dtype)), dim
            )
        else:  # null
            mat = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
            fixed = pa.FixedSizeListArray.from_arrays(
                pa.array(mat.ravel().astype(flat.dtype)), dim, mask=pa.array(bad)
            )
        table = table.set_column(i, field.name, fixed.cast(field.type))
    if drop_mask is not None:
        table = table.filter(pa.array(~drop_mask))
    return table


def infer_vector_columns(table: pa.Table) -> pa.Table:
    """Promote uniform-length numeric list columns to FixedSizeList."""
    out = table
    for i, field in enumerate(table.schema):
        if pa.types.is_fixed_size_list(field.type):
            continue
        if not (pa.types.is_list(field.type) or pa.types.is_large_list(field.type)):
            continue
        vt = field.type.value_type
        if pa.types.is_list(vt) or pa.types.is_large_list(vt):
            # list<list<numeric>> with constant inner length → a
            # multivector column list<fixed_size_list<float, d>>
            # (reference MultiVector pydantic type; late-interaction
            # search needs the fsl inner shape)
            ivt = vt.value_type
            if not (pa.types.is_floating(ivt) or pa.types.is_integer(ivt)):
                continue
            col = table.column(i)
            if col.null_count:
                continue
            inner = pa.compute.list_flatten(col.combine_chunks())
            if len(inner) == 0 or inner.null_count:
                continue
            ilen = pa.compute.unique(pa.compute.list_value_length(inner))
            if len(ilen) != 1 or not ilen[0].as_py():
                continue
            d = ilen[0].as_py()
            itype = ivt if pa.types.is_floating(ivt) else pa.float32()
            mv_type = pa.list_(pa.list_(itype, d))
            out = out.set_column(
                i, pa.field(field.name, mv_type), col.cast(mv_type)
            )
            continue
        if not pa.types.is_floating(vt) and not pa.types.is_integer(vt):
            continue
        col = table.column(i)
        if col.null_count:
            continue
        lengths = pa.compute.list_value_length(col)
        uniq = pa.compute.unique(lengths)
        if len(uniq) != 1:
            continue
        dim = uniq[0].as_py()
        if not dim:
            continue
        value_type = (
            field.type.value_type
            if pa.types.is_floating(field.type.value_type)
            else pa.float32()
        )
        casted = col.cast(pa.list_(value_type, dim))
        out = out.set_column(i, pa.field(field.name, pa.list_(value_type, dim)), casted)
    return out


def _from_list_of_dicts(rows: list[dict], schema: pa.Schema | None) -> pa.Table:
    if schema is not None:
        return pa.Table.from_pylist(rows, schema=schema)
    # normalize numpy values so pyarrow infers cleanly
    norm = []
    for row in rows:
        r = {}
        for k, v in row.items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, np.generic):
                v = v.item()
            r[k] = v
        norm.append(r)
    return infer_vector_columns(pa.Table.from_pylist(norm))


def _from_dict_of_columns(data: dict, schema: pa.Schema | None) -> pa.Table:
    arrays = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray) and v.ndim == 2:
            dim = v.shape[1]
            values = pa.array(np.ascontiguousarray(v, dtype=np.float32).ravel())
            arrays[k] = pa.FixedSizeListArray.from_arrays(values, dim)
        elif isinstance(v, np.ndarray):
            arrays[k] = pa.array(v)
        else:
            arrays[k] = v if isinstance(v, (pa.Array, pa.ChunkedArray)) else pa.array(v)
    tbl = pa.table(arrays)
    if schema is not None:
        tbl = align_table(tbl, schema)
    else:
        tbl = infer_vector_columns(tbl)
    return tbl


def to_arrow_table(data: Any, schema: pa.Schema | None = None) -> pa.Table:
    """Convert any supported input into an Arrow table."""
    if data is None:
        if schema is None:
            raise InvalidInputError("either data or schema is required")
        return schema.empty_table()
    if isinstance(data, pa.Table):
        tbl = data
    elif isinstance(data, pa.RecordBatch):
        tbl = pa.Table.from_batches([data])
    elif isinstance(data, pa.RecordBatchReader):
        tbl = data.read_all()
    elif isinstance(data, dict):
        return _from_dict_of_columns(data, schema)
    elif _is_pandas(data):
        tbl = pa.Table.from_pandas(data, schema=schema, preserve_index=False)
        if schema is None:
            tbl = infer_vector_columns(tbl)
    elif _is_polars(data):
        tbl = data.to_arrow()
        if schema is None:
            tbl = infer_vector_columns(tbl)
    elif isinstance(data, (list, tuple)):
        if len(data) == 0:
            if schema is None:
                raise InvalidInputError("cannot infer schema from empty data")
            return schema.empty_table()
        first = data[0]
        if isinstance(first, dict):
            tbl = _from_list_of_dicts(list(data), schema)
        elif isinstance(first, pa.RecordBatch):
            tbl = pa.Table.from_batches(list(data))
        elif hasattr(first, "model_dump"):  # pydantic v2 models
            tbl = _from_list_of_dicts([m.model_dump() for m in data], schema)
        elif hasattr(first, "dict") and callable(getattr(first, "dict", None)):
            tbl = _from_list_of_dicts([m.dict() for m in data], schema)
        else:
            raise InvalidInputError(f"unsupported row type {type(first)}")
    elif isinstance(data, Iterable):
        batches = list(data)
        return to_arrow_table(batches, schema)
    else:
        raise InvalidInputError(f"unsupported data type {type(data)}")
    if schema is not None:
        tbl = align_table(tbl, schema)
    return tbl


def align_table(tbl: pa.Table, schema: pa.Schema) -> pa.Table:
    """Cast a table to the target schema (order, types, missing nullables)."""
    import pyarrow.compute as pc

    arrays = []
    for field in schema:
        if field.name in tbl.schema.names:
            col = tbl.column(field.name)
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            if col.type != field.type:
                try:
                    col = col.cast(field.type)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
                    raise SchemaError(
                        f"cannot cast column {field.name!r} from {col.type} to {field.type}: {e}"
                    ) from None
        elif field.nullable:
            col = pa.nulls(tbl.num_rows, field.type)
        else:
            raise SchemaError(f"missing non-nullable column {field.name!r}")
        arrays.append(col)
    return pa.Table.from_arrays(arrays, schema=schema)


def _is_pandas(obj: Any) -> bool:
    mod = type(obj).__module__
    return mod.startswith("pandas.") and type(obj).__name__ == "DataFrame"


def _is_polars(obj: Any) -> bool:
    mod = type(obj).__module__
    return mod.startswith("polars.") and type(obj).__name__ == "DataFrame"


def vector_column_name(schema: pa.Schema, requested: str | None = None) -> str:
    """Resolve which column holds vectors (reference default 'vector',
    else the single FixedSizeList column)."""
    if requested is not None:
        if requested not in schema.names:
            raise InvalidInputError(f"no column {requested!r} in schema")
        return requested
    def _is_searchable(t: pa.DataType) -> bool:
        if is_vector_type(t):
            return True
        # multivector: list<fixed_size_list<float>>
        return (
            (pa.types.is_list(t) or pa.types.is_large_list(t))
            and pa.types.is_fixed_size_list(t.value_type)
            and pa.types.is_floating(t.value_type.value_type)
        )

    if VECTOR_COLUMN_NAME in schema.names and _is_searchable(
        schema.field(VECTOR_COLUMN_NAME).type
    ):
        return VECTOR_COLUMN_NAME
    candidates = [f.name for f in schema if _is_searchable(f.type)]
    if len(candidates) == 1:
        return candidates[0]
    if not candidates:
        raise InvalidInputError("table has no vector (FixedSizeList) column")
    raise InvalidInputError(
        f"multiple vector columns {candidates}; specify vector_column_name explicitly"
    )


def fsl_to_numpy(col: pa.ChunkedArray | pa.Array, dtype=np.float32) -> np.ndarray:
    """FixedSizeList column → (n, dim) numpy matrix, zero-copy when possible."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if not pa.types.is_fixed_size_list(col.type):
        raise InvalidInputError(f"expected FixedSizeList column, got {col.type}")
    dim = col.type.list_size
    flat = col.flatten()
    out = flat.to_numpy(zero_copy_only=False).reshape(-1, dim)
    if out.dtype != dtype:
        out = out.astype(dtype)
    return out


def numpy_to_fsl(mat: np.ndarray, value_type: pa.DataType = pa.float32()) -> pa.Array:
    mat = np.ascontiguousarray(mat)
    values = pa.array(mat.ravel(), type=value_type)
    return pa.FixedSizeListArray.from_arrays(values, mat.shape[1])
