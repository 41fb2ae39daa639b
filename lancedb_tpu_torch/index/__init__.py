"""Index configuration — the FLAT, IVF_FLAT, IVF_SQ, IVF_PQ, IVF_RQ, HNSW,
scalar (BTREE, BITMAP, LABEL_LIST, FM) and full-text (FTS) part of the
reference's index surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


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
class IvfSq:
    """IVF + int8 scalar quantization (reference IvfSqIndexBuilder)."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    sample_rate: int = 256
    max_iterations: int = 50
    seed: int = 0
    # dtype of the one-time table upload for the k-means (as IvfPq's); the
    # affine codes are computed on the host from the f32 rows
    build_precision: str = "bfloat16"

    index_type: str = "IVF_SQ"


@dataclass
class IvfRq:
    """IVF + RaBitQ-style binary residual quantization (reference IvfRq)."""

    distance_type: str = "l2"
    num_partitions: int | None = None
    num_bits: int = 1
    sample_rate: int = 256
    max_iterations: int = 50
    seed: int = 0
    # dtype of the one-time table upload for the k-means and residuals
    build_precision: str = "bfloat16"

    index_type: str = "IVF_RQ"


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


@dataclass
class BTree:
    """Sorted scalar index for range/equality predicates (reference BTree,
    4096-row blocks — index/scalar.rs:14-29)."""

    index_type: str = "BTREE"


@dataclass
class Bitmap:
    """Per-value bitmap index for low-cardinality columns."""

    index_type: str = "BITMAP"


@dataclass
class LabelList:
    """Bitmap index over list-valued label columns."""

    index_type: str = "LABEL_LIST"


@dataclass
class Fm:
    """Substring-search scalar index (reference `Fm`, index.rs:31-56):
    resolves ``col LIKE '%needle%'`` (and prefix/suffix/exact LIKEs)
    from the index alone. Backed by a suffix array over the
    concatenated column text — same capability as the reference's
    FM-index, host-side structure chosen for numpy-friendly builds."""

    index_type: str = "FM"


@dataclass
class FTS:
    """BM25 full-text index (reference FtsIndexBuilder + python index.py
    tokenizer params, index.py:111-188)."""

    with_position: bool = True
    base_tokenizer: Literal[
        "simple", "whitespace", "raw", "ngram", "unicode", "cjk",
        "icu", "jieba", "lindera",
    ] = "simple"
    language: str = "English"
    max_token_length: int | None = 40
    lower_case: bool = True
    stem: bool = True
    remove_stop_words: bool = True
    ascii_folding: bool = True
    ngram_min_length: int = 3
    ngram_max_length: int = 3
    prefix_only: bool = False
    # user dictionary for the jieba/lindera dictionary-backed CJK
    # segmenters (jieba format: 'word [freq [tag]]' per line)
    dict_path: str | None = None

    index_type: str = "FTS"


@dataclass
class Auto:
    """Pick the index from the column's type (reference ``Index::Auto``,
    table/create_index.rs:186-213): vector columns get IVF_PQ;
    numeric/temporal/string/boolean columns get BTREE; anything else is
    an error."""

    distance_type: str = "l2"

    index_type: str = "AUTO"


SCALAR_INDEX_TYPES = {"BTREE", "BITMAP", "LABEL_LIST", "FM"}


def default_num_partitions(num_rows: int) -> int:
    """Reference default: √N (index/vector.rs:63-70)."""
    import math

    return max(1, round(math.sqrt(max(1, num_rows))))
