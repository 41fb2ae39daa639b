"""Pydantic integration: define table schemas as models.

Reference: python pydantic.py (LanceModel `:463`, Vector `:69`,
MultiVector `:166`, pydantic→arrow conversion `:487`). Usage::

    class Item(LanceModel):
        id: int
        text: str
        vector: Vector(128)

    tbl = db.create_table("items", schema=Item)
    tbl.add([Item(id=1, text="hi", vector=[0.0]*128)])
    hits = tbl.search(q).limit(5).to_pydantic(Item)
"""

from __future__ import annotations

import datetime
import enum
import types
import typing
from typing import Any, get_args, get_origin

import numpy as np
import pyarrow as pa

try:
    import pydantic
    from pydantic import BaseModel
    from pydantic_core import core_schema

    HAVE_PYDANTIC = True
except ImportError:  # pragma: no cover
    HAVE_PYDANTIC = False
    BaseModel = object  # type: ignore[assignment,misc]

from .errors import InvalidInputError


def Vector(dim: int, value_type: pa.DataType | None = None, nullable: bool = True):
    """Fixed-size vector field type (reference pydantic.py:69)."""
    value_type = value_type or pa.float32()

    class FixedSizeList(list):
        DIM = dim
        VALUE_TYPE = value_type
        NULLABLE = nullable

        @classmethod
        def __get_pydantic_core_schema__(cls, _source_type, _handler):
            def validate(v):
                if isinstance(v, np.ndarray):
                    v = v.tolist()
                if len(v) != dim:
                    raise ValueError(f"vector must have {dim} elements, got {len(v)}")
                return [float(x) for x in v]

            return core_schema.no_info_plain_validator_function(validate)

    FixedSizeList.__name__ = f"Vector[{dim}]"
    return FixedSizeList


def MultiVector(dim: int, value_type: pa.DataType | None = None):
    """Variable count of fixed-size vectors (reference pydantic.py:166) —
    the storage type behind ColBERT-style multivector columns."""
    value_type = value_type or pa.float32()

    class MultiVectorList(list):
        DIM = dim
        VALUE_TYPE = value_type
        MULTI = True

        @classmethod
        def __get_pydantic_core_schema__(cls, _source_type, _handler):
            def validate(v):
                if isinstance(v, np.ndarray):
                    v = v.tolist()
                out = []
                for vec in v:
                    if isinstance(vec, np.ndarray):
                        vec = vec.tolist()
                    if len(vec) != dim:
                        raise ValueError(f"each vector must have {dim} elements")
                    out.append([float(x) for x in vec])
                return out

            return core_schema.no_info_plain_validator_function(validate)

    MultiVectorList.__name__ = f"MultiVector[{dim}]"
    return MultiVectorList


_SCALARS = {
    int: pa.int64(),
    float: pa.float64(),
    bool: pa.bool_(),
    str: pa.utf8(),
    bytes: pa.large_binary(),
    datetime.datetime: pa.timestamp("us"),
    datetime.date: pa.date32(),
}


def _pytype_to_arrow(py_type, field_info=None) -> tuple[pa.DataType, bool]:
    """Python/pydantic annotation → (arrow type, nullable)."""
    nullable = False
    origin = get_origin(py_type)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(py_type) if a is not type(None)]
        if len(args) != len(get_args(py_type)):
            nullable = True
        if len(args) != 1:
            raise InvalidInputError(f"unsupported union type {py_type}")
        inner, _ = _pytype_to_arrow(args[0], field_info)
        return inner, nullable
    if isinstance(py_type, type) and issubclass(py_type, list) and hasattr(py_type, "DIM"):
        if getattr(py_type, "MULTI", False):
            return pa.list_(pa.list_(py_type.VALUE_TYPE, py_type.DIM)), getattr(
                py_type, "NULLABLE", True
            )
        return pa.list_(py_type.VALUE_TYPE, py_type.DIM), getattr(py_type, "NULLABLE", True)
    if origin in (list, typing.List):
        (arg,) = get_args(py_type) or (float,)
        inner, _ = _pytype_to_arrow(arg, None)
        return pa.list_(inner), False
    if origin in (dict, typing.Dict):
        kt, vt = get_args(py_type)
        k, _ = _pytype_to_arrow(kt)
        v, _ = _pytype_to_arrow(vt)
        return pa.map_(k, v), False
    if HAVE_PYDANTIC and isinstance(py_type, type) and issubclass(py_type, BaseModel):
        fields = []
        for name, finfo in py_type.model_fields.items():
            t, null = _pytype_to_arrow(finfo.annotation, finfo)
            fields.append(pa.field(name, t, nullable=null))
        return pa.struct(fields), False
    if py_type in _SCALARS:
        return _SCALARS[py_type], False
    if py_type is np.ndarray:
        return pa.list_(pa.float32()), False
    if isinstance(py_type, type) and issubclass(py_type, enum.Enum):
        # enums map to the Arrow type of their value mixin: str enums
        # become dictionary<utf8> (low cardinality), int enums int64
        # (reference pydantic.py, test_pydantic.py test_enum_types)
        if issubclass(py_type, str):
            return pa.dictionary(pa.int32(), pa.utf8()), False
        if issubclass(py_type, int):
            return pa.int64(), False
        vals = [m.value for m in py_type]
        if vals and all(isinstance(v, str) for v in vals):
            return pa.dictionary(pa.int32(), pa.utf8()), False
        if vals and all(isinstance(v, int) for v in vals):
            return pa.int64(), False
    raise InvalidInputError(f"cannot convert python type {py_type!r} to arrow")


def pydantic_to_schema(model_cls) -> pa.Schema:
    """Model class → Arrow schema (reference pydantic.py `pydantic_to_schema`)."""
    if not HAVE_PYDANTIC:
        raise InvalidInputError("pydantic is not installed")
    fields = []
    for name, finfo in model_cls.model_fields.items():
        t, nullable = _pytype_to_arrow(finfo.annotation, finfo)
        if not finfo.is_required():
            nullable = True
        fields.append(pa.field(name, t, nullable=nullable))
    return pa.schema(fields)


def parse_embedding_functions(model_cls) -> list:
    """Extract EmbeddingDefinitions from SourceField/VectorField markers
    on a LanceModel (reference python table.py `parse_embedding_functions`
    over pydantic json_schema_extra). A SourceField with no matching
    VectorField targets the default ``vector`` column; a VectorField
    whose function has no SourceField is an error."""
    from .embeddings.registry import EmbeddingDefinition

    sources: list[tuple[str, Any]] = []
    vectors: list[tuple[str, Any]] = []
    for name, finfo in getattr(model_cls, "model_fields", {}).items():
        extra = getattr(finfo, "json_schema_extra", None)
        if not isinstance(extra, dict):
            continue
        if "source_column_for" in extra:
            sources.append((name, extra["source_column_for"]))
        if "vector_column_for" in extra:
            vectors.append((name, extra["vector_column_for"]))
    paired = set()
    defs = []
    for src_name, fn in sources:
        vec_name = next(
            (v for v, f in vectors if f is fn), None
        )
        if vec_name is not None:
            paired.add(vec_name)
        # safe_model_dump (not raw _config): refuses hardcoded secrets
        # on directly-instantiated functions so they never land in
        # table schema metadata
        defs.append(EmbeddingDefinition(
            source_column=src_name,
            vector_column=vec_name or "vector",
            function_name=type(fn).name,
            config=(
                fn.safe_model_dump()
                if hasattr(fn, "safe_model_dump")
                else dict(getattr(fn, "_config", {}) or {})
            ),
        ))
    orphans = [v for v, _ in vectors if v not in paired]
    if orphans:
        raise InvalidInputError(
            f"VectorField column(s) {orphans} have no matching SourceField"
        )
    return defs


if HAVE_PYDANTIC:

    class LanceModel(BaseModel):
        """Base class for table row models (reference pydantic.py:463)."""

        @classmethod
        def to_arrow_schema(cls) -> pa.Schema:
            return pydantic_to_schema(cls)

        @classmethod
        def field_names(cls) -> list[str]:
            return list(cls.model_fields)

else:  # pragma: no cover

    class LanceModel:  # type: ignore[no-redef]
        pass
