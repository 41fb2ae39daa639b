"""Ecosystem integrations (reference python integrations/)."""

from .pyarrow import (
    PyarrowDatasetAdapter,
    PyarrowScannerAdapter,
    to_pyarrow_dataset,
)

__all__ = ["PyarrowScannerAdapter", "PyarrowDatasetAdapter", "to_pyarrow_dataset"]
