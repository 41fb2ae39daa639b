"""Table API: the user-facing handle over one versioned dataset.

Port of the slice of the reference's table.py that the ported paths
run: add, delete, count_rows, create_index (FLAT, IVF_FLAT, IVF_PQ and
the HNSW family) and search. The device
chosen at ``connect()`` travels from the connection to every index
build and searcher of the table. The rest of the reference's surface
raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Literal

import pyarrow as pa

from ._surface import NotPortedSurface
from .arrow import sanitize_vectors, to_arrow_table
from .arrow import vector_column_name as _vector_column_name
from .errors import InvalidInputError
from .index import Flat, HnswFlat, HnswPq, HnswSq, IvfFlat, IvfPq
from .query import LanceVectorQueryBuilder
from .storage.dataset import Dataset


class Table(NotPortedSurface):
    """A handle on one table of a database."""

    _NOT_PORTED = {
        **dict.fromkeys(
            ("update", "merge_insert", "query", "vector_search", "to_arrow", "head",
             "take_offsets", "take_row_ids", "list_indices", "index_stats", "drop_index",
             "prewarm_index", "wait_for_index", "create_index_async", "add_columns",
             "alter_columns", "drop_columns", "merge", "list_versions", "checkout",
             "checkout_latest", "restore", "tags", "create_branch", "checkout_branch",
             "list_branches", "delete_branch", "diff_branch", "merge_branch", "optimize",
             "compact_files", "cleanup_old_versions", "stats", "to_pandas", "to_polars",
             "to_lance", "update_field_metadata", "declare_primary_key",
             "set_unenforced_primary_key"),
            "A4",
        ),
        **dict.fromkeys(
            ("create_scalar_index", "create_fts_index", "tokenize", "fetch_blobs",
             "fetch_blob_files", "fetch_blob_ranges", "set_lsm_write_spec", "flush_lsm",
             "checkpoint_lsm", "compact_lsm", "lsm_stats", "enable_sharded_serving"),
            "A12",
        ),
    }

    def __init__(self, connection, name: str, dataset: Dataset):
        self._conn = connection
        self.name = name
        self._dataset = dataset
        self._searchers: dict[str, Any] = {}

    @property
    def _device(self):
        return self._conn.device

    def _invalidate_caches(self) -> None:
        self._searchers.clear()
        self._conn.session.invalidate(self._dataset.root)

    @property
    def schema(self) -> pa.Schema:
        return self._dataset.schema

    @property
    def version(self) -> int:
        return self._dataset.version

    def __repr__(self) -> str:
        return f"Table(name={self.name!r}, version={self.version}, rows={self.count_rows()})"

    def __len__(self) -> int:
        return self.count_rows()

    def count_rows(self, filter: str | None = None) -> int:
        return self._dataset.count_rows(filter)

    # ------------------------------------------------------------- write

    def add(
        self,
        data: Any,
        mode: Literal["append", "overwrite"] = "append",
        *,
        on_bad_vectors: str = "error",
        fill_value: float = 0.0,
    ) -> None:
        tbl = to_arrow_table(data, schema=self.schema if mode == "append" else None)
        tbl = sanitize_vectors(tbl, on_bad_vectors, fill_value)
        if mode == "append":
            self._dataset.append(tbl)
        elif mode == "overwrite":
            self._dataset.overwrite(tbl)
        else:
            raise InvalidInputError(f"unknown add mode {mode!r}")
        self._invalidate_caches()

    def delete(self, where: str) -> int:
        n = self._dataset.delete(where)
        self._invalidate_caches()
        return n

    # ------------------------------------------------------------ search

    def search(self, query: Any = None, vector_column_name: str | None = None) -> LanceVectorQueryBuilder:
        """Vector search (reference table.py:3404). Text, full-text and
        hybrid queries and plain scans wait for later slices (ROADMAP A4, A12)."""
        if query is None or isinstance(query, (str, tuple)):
            raise NotImplementedError(
                "only vector queries are ported to lancedb_tpu_torch yet (ROADMAP A4, A12)"
            )
        return LanceVectorQueryBuilder(self, query, vector_column_name)

    def _get_searcher(self, index_meta):
        from .index.vector import load_searcher

        key = index_meta.uuid
        ds = self._dataset
        s = self._searchers.get(key)
        if s is None:
            s = self._conn.session.get_or_load(
                f"{ds.root}/{key}", lambda: load_searcher(ds, index_meta, self._device)
            )
            self._searchers[key] = s
        return s

    # ------------------------------------------------------------- index

    def create_index(
        self,
        metric: str = "l2",
        num_partitions: int | None = None,
        num_sub_vectors: int | None = None,
        vector_column_name: str | None = None,
        replace: bool = True,
        index_type: str = "IVF_PQ",
        num_bits: int = 8,
        sample_rate: int = 256,
        max_iterations: int = 50,
        *,
        config: IvfPq | IvfFlat | Flat | HnswFlat | HnswSq | HnswPq | None = None,
        name: str | None = None,
    ) -> None:
        """Build a FLAT, IVF_FLAT, IVF_PQ or IVF_HNSW_* vector index on the
        connection's device (reference table.py:2604 create_index). IVF_SQ
        and IVF_RQ raise, naming their ROADMAP item (A7)."""
        from .index.hnsw import HNSW_INDEX_TYPES, build_hnsw_index
        from .index.vector import PORTED_INDEX_TYPES, _not_ported, build_vector_index

        column = vector_column_name or _vector_column_name(self.schema)
        if config is None:
            it = index_type.upper()
            if it == "IVF_PQ":
                config = IvfPq(
                    distance_type=metric,
                    num_partitions=num_partitions,
                    num_sub_vectors=num_sub_vectors,
                    num_bits=num_bits,
                    sample_rate=sample_rate,
                    max_iterations=max_iterations,
                )
            elif it == "IVF_FLAT":
                config = IvfFlat(
                    distance_type=metric,
                    num_partitions=num_partitions,
                    sample_rate=sample_rate,
                    max_iterations=max_iterations,
                )
            elif it == "FLAT":
                config = Flat(distance_type=metric)
            elif it in HNSW_INDEX_TYPES:
                cls = {"IVF_HNSW_FLAT": HnswFlat, "IVF_HNSW_SQ": HnswSq, "IVF_HNSW_PQ": HnswPq}[it]
                kwargs = dict(distance_type=metric, num_partitions=num_partitions)
                if it == "IVF_HNSW_PQ":
                    kwargs["num_sub_vectors"] = num_sub_vectors
                config = cls(**kwargs)
            else:
                raise _not_ported(it)
        if config.index_type in HNSW_INDEX_TYPES:
            build = build_hnsw_index
        elif config.index_type in PORTED_INDEX_TYPES:
            build = build_vector_index
        else:
            raise _not_ported(config.index_type)
        meta = build(self._dataset, column, config, name=name or f"{column}_idx",
                     device=self._device)
        self._dataset.add_index(meta, replace=replace)
        self._invalidate_caches()

