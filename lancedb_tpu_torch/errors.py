"""Typed error hierarchy for lancedb_tpu.

Mirrors the contract of the reference error enum (reference:
rust/lancedb/src/error.rs:1-342) — one exception class per user-facing
failure mode, so SDK code can catch narrowly.
"""

from __future__ import annotations


class LanceDBError(Exception):
    """Base class for all lancedb_tpu errors."""


class InvalidInputError(LanceDBError, ValueError):
    """Bad user input (reference error.rs `InvalidInput`)."""


class TableNotFoundError(LanceDBError):
    def __init__(self, name: str):
        super().__init__(f"Table '{name}' was not found")
        self.name = name


class TableAlreadyExistsError(LanceDBError):
    def __init__(self, name: str):
        super().__init__(f"Table '{name}' already exists")
        self.name = name


class DatabaseNotFoundError(LanceDBError):
    pass


class IndexNotFoundError(LanceDBError):
    def __init__(self, name: str):
        super().__init__(f"Index '{name}' was not found")
        self.name = name


class EmbeddingFunctionNotFoundError(LanceDBError):
    pass


class SchemaError(LanceDBError):
    """Schema mismatch between data and table (reference error.rs `Schema`)."""


class CommitConflictError(LanceDBError):
    """Optimistic-concurrency manifest commit lost the race.

    The reference resolves these inside the lance commit layer with
    retries; we surface the same semantics at the Dataset.commit level.
    """

    def __init__(self, version: int, message: str = ""):
        super().__init__(
            f"Commit conflict at version {version}: {message or 'another writer committed first'}"
        )
        self.version = version


class VersionNotFoundError(LanceDBError):
    def __init__(self, version):
        super().__init__(f"Version {version} does not exist")
        self.version = version


class TagNotFoundError(LanceDBError):
    def __init__(self, tag: str):
        super().__init__(f"Tag '{tag}' does not exist")
        self.tag = tag


class BranchNotFoundError(LanceDBError):
    def __init__(self, branch: str):
        super().__init__(f"Branch '{branch}' does not exist")
        self.branch = branch


class SqlParseError(LanceDBError, ValueError):
    """Raised by the SQL predicate parser on malformed input."""


class RuntimeLanceDBError(LanceDBError, RuntimeError):
    """Internal invariant violation (reference error.rs `Runtime`)."""


class HttpError(LanceDBError):
    """Remote-client HTTP failure (reference error.rs `Http`)."""

    def __init__(self, message: str, status_code: int | None = None, request_id: str | None = None):
        super().__init__(message)
        self.status_code = status_code
        self.request_id = request_id


class RetryError(HttpError):
    """All retries exhausted (reference remote/retry.rs)."""


class JobFailureError(LanceDBError):
    """Async server-side job failed (reference error.rs `JobFailure`)."""
