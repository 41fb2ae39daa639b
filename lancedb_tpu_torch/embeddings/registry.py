"""Singleton embedding registry (reference python embeddings/registry.py:
10-100): providers register by name; table schemas carry the embedding
config in Arrow schema metadata so reopening a table reconnects the
functions automatically."""

from __future__ import annotations

import json
from dataclasses import dataclass

import pyarrow as pa

from ..errors import EmbeddingFunctionNotFoundError, InvalidInputError
from .base import EmbeddingFunction

METADATA_KEY = b"embedding_functions"


@dataclass
class EmbeddingDefinition:
    """Binds a source column to a vector column via a named provider
    (reference rust embeddings.rs EmbeddingDefinition)."""

    source_column: str
    vector_column: str = "vector"
    function_name: str = ""
    config: dict | None = None


@dataclass
class EmbeddingFunctionConfig:
    """A live function instance bound to its source/vector columns
    (reference python embeddings/registry.py EmbeddingFunctionConfig —
    the instance-level counterpart of EmbeddingDefinition)."""

    function: EmbeddingFunction
    source_column: str
    vector_column: str = "vector"


class EmbeddingFunctionRegistry:
    _instance: "EmbeddingFunctionRegistry | None" = None

    def __init__(self):
        self._functions: dict[str, type[EmbeddingFunction]] = {}
        self._variables: dict[str, str] = {}

    @classmethod
    def get_instance(cls) -> "EmbeddingFunctionRegistry":
        if cls._instance is None:
            cls._instance = cls()
            from . import multimodal, providers, rest_providers  # noqa: F401  (self-registration)
        return cls._instance

    # --- registration ----------------------------------------------------
    def register(self, alias: str | None = None):
        def decorator(klass: type[EmbeddingFunction]):
            name = alias or klass.name or klass.__name__
            klass.name = name
            self._functions[name] = klass
            return klass

        return decorator

    def get(self, name: str):
        if name not in self._functions:
            raise EmbeddingFunctionNotFoundError(
                f"no embedding function registered under {name!r}; "
                f"available: {sorted(self._functions)}"
            )
        klass = self._functions[name]
        registry = self

        class _Creator:
            def create(_self, **kwargs) -> EmbeddingFunction:
                fn = klass(**registry.resolve_variables(klass, kwargs))
                # persist the UNRESOLVED args: `$var:` references (not
                # secrets) are what lands in table schema metadata
                fn._config = dict(kwargs)
                return fn

        return _Creator()

    def resolve_variables(self, klass, kwargs: dict) -> dict:
        """Resolve ``$var:name[:default]`` config values against the
        registry's variables and refuse hardcoded sensitive values
        (reference embeddings/base.py:46-70 __resolveVariables): secrets
        must arrive via ``$var:`` or the provider's env variable so they
        are never persisted into table metadata."""
        sensitive = set(getattr(klass, "sensitive_keys", lambda: [])())
        out = {}
        for k, v in kwargs.items():
            if isinstance(v, str) and v.startswith("$var:"):
                parts = v[5:].split(":", maxsplit=1)
                if len(parts) == 1:
                    if parts[0] not in self._variables:
                        raise InvalidInputError(
                            f"variable {parts[0]!r} is not set; call "
                            f"get_registry().set_var({parts[0]!r}, ...) first"
                        )
                    out[k] = self._variables[parts[0]]
                else:
                    out[k] = self._variables.get(parts[0], parts[1])
            elif k in sensitive and isinstance(v, str):
                raise InvalidInputError(
                    f"sensitive key {k!r} cannot be set to a hardcoded value "
                    f"(it would be persisted in table metadata); use a "
                    f"'$var:name' reference or the provider's env variable"
                )
            else:
                out[k] = v
        return out

    def list_functions(self) -> list[str]:
        return sorted(self._functions)

    def reset(self) -> None:
        """Clear every registered provider (reference registry.py:72)."""
        self._functions = {}

    # --- instance-level config round trip (reference registry.py:91-158) -
    def function_to_metadata(self, conf: EmbeddingFunctionConfig) -> dict:
        """One EmbeddingFunctionConfig → the serializable metadata entry."""
        return {
            "name": type(conf.function).name or type(conf.function).__name__,
            "model": conf.function.safe_model_dump(),
            "source_column": conf.source_column,
            "vector_column": conf.vector_column,
        }

    def get_table_metadata(self, func_list) -> dict[str, bytes] | None:
        """A list of EmbeddingFunctionConfig → the Arrow schema-metadata
        dict ({b'embedding_functions': json} shape shared with
        attach_metadata)."""
        if not func_list:
            return None
        doc = [self.function_to_metadata(c) for c in func_list]
        return {METADATA_KEY.decode(): json.dumps(doc).encode()}

    def parse_functions(self, metadata) -> dict[str, EmbeddingFunctionConfig]:
        """Arrow schema metadata → {vector_column: config}; empty dict
        when the metadata carries no embedding functions."""
        if not metadata:
            return {}
        raw = metadata.get(METADATA_KEY) or metadata.get(METADATA_KEY.decode())
        if raw is None:
            return {}
        out = {}
        for vec_col, fn in self.parse_functions_from_schema_metadata(raw).items():
            out[vec_col] = EmbeddingFunctionConfig(
                function=fn,
                source_column=fn.source_column,
                vector_column=vec_col,
            )
        return out

    # --- variables (reference registry set_var/get_var) ------------------
    def set_var(self, name: str, value: str) -> None:
        if ":" in name:
            raise InvalidInputError("variable names cannot contain colons")
        self._variables[name] = value

    def get_var(self, name: str) -> str:
        return self._variables[name]

    # --- schema metadata round trip --------------------------------------
    def attach_metadata(self, schema: pa.Schema, definitions: list[EmbeddingDefinition]) -> pa.Schema:
        doc = [
            {
                "source_column": d.source_column,
                "vector_column": d.vector_column,
                "name": d.function_name,
                "model": d.config or {},
            }
            for d in definitions
        ]
        meta = dict(schema.metadata or {})
        meta[METADATA_KEY] = json.dumps(doc).encode()
        return schema.with_metadata(meta)

    def parse_functions_from_schema_metadata(self, raw: bytes) -> dict[str, EmbeddingFunction]:
        out = {}
        for entry in json.loads(raw):
            fn = self.get(entry["name"]).create(
                source_column=entry["source_column"], **entry.get("model", {})
            )
            fn.source_column = entry["source_column"]
            out[entry["vector_column"]] = fn
        return out


def get_registry() -> EmbeddingFunctionRegistry:
    """Module-level accessor (reference python get_registry())."""
    return EmbeddingFunctionRegistry.get_instance()
