"""lancedb_tpu_torch — the vector database of ``lancedb_tpu`` in PyTorch,
with hand-written CUDA kernels for one NVIDIA H100.

Same surface and on-disk format as ``lancedb_tpu``:

    db = lancedb_tpu_torch.connect("/path/to/db")          # the CUDA card
    db = lancedb_tpu_torch.connect("/path/to/db", device="cpu")
    tbl = db.create_table("items", data)
    tbl.create_index(config=IvfPq(num_partitions=1024, num_sub_vectors=16))
    tbl.search(q).where("category < 5").nprobes(20).refine_factor(10).limit(10).to_arrow()
    tbl.create_index(config=IvfFlat(num_partitions=1024))  # or Flat()
    tbl.create_index(config=HnswFlat())  # or HnswSq(), HnswPq()
    tbl.search(q).ef(64).limit(10).to_arrow()

The package imports neither JAX nor ``lancedb_tpu``; CUDA kernels build
from ``csrc/`` with nvcc on first use.
"""

from .db import LanceDBConnection, connect
from .errors import (
    IndexNotFoundError,
    InvalidInputError,
    LanceDBError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
from .index import Flat, HnswFlat, HnswPq, HnswSq, IvfFlat, IvfPq
from .session import Session
from .table import Table

__version__ = "0.1.0"

__all__ = [
    "connect",
    "LanceDBConnection",
    "Table",
    "Session",
    "Flat",
    "HnswFlat",
    "HnswPq",
    "HnswSq",
    "IvfFlat",
    "IvfPq",
    "LanceDBError",
    "InvalidInputError",
    "IndexNotFoundError",
    "TableAlreadyExistsError",
    "TableNotFoundError",
]
