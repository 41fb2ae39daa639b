"""Index configuration — the FLAT, IVF_FLAT, IVF_PQ and HNSW part of the
reference's index surface.

The other index types (IVF_SQ, IVF_RQ, scalar and full-text indexes)
wait for later slices (ROADMAP A7, A12).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IvfFlat:
    """IVF with a full-precision scan of the probed partitions (reference
    IvfFlatIndexBuilder)."""

    distance_type: str = "l2"
    num_partitions: int | None = None  # default √N at build time
    sample_rate: int = 256
    max_iterations: int = 50
    seed: int = 0
    # dtype of the one-time table upload for the k-means (as IvfPq's)
    build_precision: str = "bfloat16"
    # device storage for the scan: float32 ranks exactly; bfloat16 halves
    # device memory and scan bytes at some recall cost (the files stay f32)
    precision: str = "float32"

    index_type: str = "IVF_FLAT"


@dataclass
class IvfPq:
    """IVF + product-quantized residuals (reference IvfPqIndexBuilder)."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    num_sub_vectors: int | None = None  # default dim/16
    num_bits: int = 8
    sample_rate: int = 256
    max_iterations: int = 50
    seed: int = 0
    # dtype of the one-time table upload for the build: bfloat16 halves
    # the copy (the assignment product already runs in bf16 on the card);
    # float32 keeps residual and codebook training at input precision.
    # CPU builds always use float32, as the reference's do.
    build_precision: str = "bfloat16"
    # OPQ rotation learned at build (host Procrustes steps between PQ
    # trainings); the search rotates the query instead of the codes
    opq: bool = False
    opq_iters: int = 8

    index_type: str = "IVF_PQ"


@dataclass
class Flat:
    """Brute-force scan 'index': the table resident on the device, searched
    exactly (reference Index::Flat)."""

    distance_type: str = "l2"

    index_type: str = "FLAT"


@dataclass
class HnswPq:
    """HNSW graph over PQ codes (reference IvfHnswPqIndexBuilder); served
    by the host walk only, as in the reference."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    num_sub_vectors: int | None = None
    m: int = 20
    ef_construction: int = 300

    index_type: str = "IVF_HNSW_PQ"


@dataclass
class HnswSq:
    """HNSW graph over int8 affine codes (reference IvfHnswSqIndexBuilder)."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    m: int = 20
    ef_construction: int = 300

    index_type: str = "IVF_HNSW_SQ"


@dataclass
class HnswFlat:
    """HNSW graph over the f32 rows (reference IvfHnswFlatIndexBuilder)."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    m: int = 20
    ef_construction: int = 300

    index_type: str = "IVF_HNSW_FLAT"


def default_num_partitions(num_rows: int) -> int:
    """Reference default: √N (index/vector.rs:63-70)."""
    import math

    return max(1, round(math.sqrt(max(1, num_rows))))
