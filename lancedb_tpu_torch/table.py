"""Table API: the user-facing handle over one versioned dataset.

Port of the slice of the reference's table.py that the ported paths
run: add, delete, count_rows, create_index (FLAT, IVF_FLAT, IVF_SQ,
IVF_PQ, IVF_RQ, the HNSW family, AUTO, and the token index of a
multivector column), create_scalar_index, create_fts_index, tokenize and
search (vector, multivector, full-text and hybrid). The device chosen at
``connect()`` travels from the connection to every index build and
searcher of the table; scalar and full-text indexes live on the host.
The rest of the reference's surface raises NotImplementedError naming
its ROADMAP item.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Literal

import pyarrow as pa

from ._surface import NotPortedSurface
from .arrow import is_vector_type, sanitize_vectors, to_arrow_table
from .arrow import vector_column_name as _vector_column_name
from .errors import InvalidInputError
from .index import (
    FTS,
    Auto,
    Bitmap,
    BTree,
    Flat,
    Fm,
    HnswFlat,
    HnswPq,
    HnswSq,
    IvfFlat,
    IvfPq,
    IvfRq,
    IvfSq,
    LabelList,
)
from .query import DEFAULT_TOP_K, LanceQueryBuilder
from .storage.dataset import Dataset


@dataclass
class FtsToken:
    """One token produced by Table.tokenize (reference FtsToken)."""

    text: str
    position: int


def _supported_btree_type(t: pa.DataType) -> bool:
    """Types Index::Auto maps to BTREE (reference utils/mod.rs:228-242)."""
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or pa.types.is_time(t)
        or pa.types.is_date(t)
        or pa.types.is_timestamp(t)
        or pa.types.is_fixed_size_binary(t)
    )


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
            ("fetch_blobs", "fetch_blob_files", "fetch_blob_ranges", "set_lsm_write_spec",
             "flush_lsm", "checkpoint_lsm", "compact_lsm", "lsm_stats",
             "enable_sharded_serving"),
            "A12",
        ),
    }

    def __init__(self, connection, name: str, dataset: Dataset):
        self._conn = connection
        self.name = name
        self._dataset = dataset
        self._searchers: dict[str, Any] = {}
        self._fts_indexes: dict[str, Any] = {}
        # a batched hybrid search asks for the FTS index from several
        # threads at once: one of them loads it
        self._fts_lock = threading.Lock()

    @property
    def _device(self):
        return self._conn.device

    def _invalidate_caches(self) -> None:
        self._searchers.clear()
        self._fts_indexes.clear()
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

    def search(
        self,
        query: Any = None,
        vector_column_name: str | None = None,
        query_type: str = "auto",
        fts_columns: list[str] | None = None,
    ) -> LanceQueryBuilder:
        """Vector, full-text or hybrid search (reference table.py:640 →
        LanceQueryBuilder.create): a vector, a string or FTS query node, or
        a (vector, text) pair. Plain scans wait for a later slice (A4)."""
        return LanceQueryBuilder.create(
            self, query, query_type=query_type,
            vector_column_name=vector_column_name, fts_columns=fts_columns,
        )

    def _embed_query(self, text: str):
        """A text query with no vector needs the table's embedding function
        (reference table.py:718), which the port does not have yet."""
        raise NotImplementedError(
            "text queries that need an embedding function are not ported to "
            "lancedb_tpu_torch yet (ROADMAP A12, embeddings); pass a vector"
        )

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
        config: IvfPq | IvfFlat | IvfSq | IvfRq | Flat | HnswFlat | HnswSq | HnswPq | Auto
        | None = None,
        name: str | None = None,
    ) -> None:
        """Build a FLAT, IVF_FLAT, IVF_SQ, IVF_PQ, IVF_RQ or IVF_HNSW_*
        vector index on the connection's device (reference table.py:2604
        create_index). AUTO picks IVF_PQ for a vector column and a BTREE
        scalar index for a scalar one (reference table.py:764-772). A
        multivector column gets its token-level FLAT index whatever the
        index type (reference table.py:779-783)."""
        from .arrow import is_multivector_type
        from .index.hnsw import HNSW_INDEX_TYPES, build_hnsw_index
        from .index.multivector import build_multivector_index
        from .index.vector import PORTED_INDEX_TYPES, build_vector_index, unsupported_index_type

        column = vector_column_name or _vector_column_name(self.schema)
        if (config is not None and config.index_type == "AUTO") or (
            config is None and index_type.upper() == "AUTO"
        ):
            # Index::Auto (reference table/create_index.rs:186-213)
            if config is not None:
                metric = config.distance_type
            config = None
            field_type = self.schema.field(column).type
            if is_vector_type(field_type) or is_multivector_type(field_type):
                index_type = "IVF_PQ"
            elif _supported_btree_type(field_type):
                self.create_scalar_index(column, index_type="BTREE", replace=replace)
                return
            else:
                raise InvalidInputError(
                    f"there are no indices supported for the field {column!r} "
                    f"with the data type {field_type}"
                )
        if column in self.schema.names and is_multivector_type(self.schema.field(column).type):
            meta = build_multivector_index(self._dataset, column, config,
                                           name=name or f"{column}_idx")
            self._dataset.add_index(meta, replace=replace)
            self._invalidate_caches()
            return
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
            elif it in ("IVF_SQ", "IVF_RQ"):
                config = (IvfSq if it == "IVF_SQ" else IvfRq)(
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
                raise unsupported_index_type(it)
        if config.index_type in HNSW_INDEX_TYPES:
            build = build_hnsw_index
        elif config.index_type in PORTED_INDEX_TYPES:
            build = build_vector_index
        else:
            raise unsupported_index_type(config.index_type)
        meta = build(self._dataset, column, config, name=name or f"{column}_idx",
                     device=self._device)
        self._dataset.add_index(meta, replace=replace)
        self._invalidate_caches()


    def create_scalar_index(
        self,
        column: str,
        *,
        index_type: str = "BTREE",
        replace: bool = True,
        config: BTree | Bitmap | LabelList | Fm | None = None,
    ) -> None:
        """Build a BTREE, BITMAP, LABEL_LIST or FM index on a scalar column
        (reference table.py:848); prefilters use it when it covers the table."""
        from .index.scalar import build_scalar_index

        if config is None:
            cls = {"BTREE": BTree, "BITMAP": Bitmap, "LABEL_LIST": LabelList,
                   "FM": Fm}.get(index_type.upper())
            if cls is None:
                raise InvalidInputError(f"unknown scalar index type {index_type!r}")
            config = cls()
        meta = build_scalar_index(self._dataset, column, config)
        self._dataset.add_index(meta, replace=replace)

    @staticmethod
    def infer_tokenizer_configs(tokenizer_name: str) -> dict:
        """Expand a lance-style tokenizer shorthand ("default", "raw",
        "whitespace", "ngram", "<language>_stem") into the full FTS
        tokenizer kwargs (reference table.py:3205)."""
        base = {
            "base_tokenizer": "simple",
            "language": "English",
            "max_token_length": 40,
            "lower_case": True,
            "stem": False,
            "remove_stop_words": False,
            "ascii_folding": False,
            "ngram_min_length": 3,
            "ngram_max_length": 3,
            "prefix_only": False,
        }
        if tokenizer_name == "default":
            return base
        if tokenizer_name in ("raw", "whitespace"):
            return {**base, "base_tokenizer": tokenizer_name,
                    "max_token_length": None, "lower_case": False}
        if tokenizer_name == "ngram":
            return {**base, "base_tokenizer": "ngram"}
        if tokenizer_name.endswith("_stem"):
            code = tokenizer_name[: -len("_stem")].lower()
            iso = {
                "en": "English", "fr": "French", "de": "German",
                "es": "Spanish", "it": "Italian", "pt": "Portuguese",
            }
            return {
                **base, "stem": True,
                "language": iso.get(code, code.capitalize()),
            }
        raise InvalidInputError(f"unknown tokenizer name {tokenizer_name!r}")

    def create_fts_index(
        self,
        field_names: str | list[str],
        *,
        replace: bool = True,
        with_position: bool = True,
        tokenizer_name: str | None = None,
        base_tokenizer: str = "simple",
        language: str = "English",
        max_token_length: int | None = 40,
        lower_case: bool = True,
        stem: bool = True,
        remove_stop_words: bool = True,
        ascii_folding: bool = True,
        ngram_min_length: int = 3,
        ngram_max_length: int = 3,
        prefix_only: bool = False,
        dict_path: str | None = None,
    ) -> None:
        """Build the BM25 inverted index on the host (reference
        table.py:905); the native builder serves the simple tokenizer.

        ``dict_path``: user dictionary for the jieba/lindera
        dictionary-backed CJK tokenizers ('word [freq [tag]]' lines).
        """
        from .index.fts import build_fts_index

        fields = [field_names] if isinstance(field_names, str) else list(field_names)
        if tokenizer_name is not None:
            cfgs = self.infer_tokenizer_configs(tokenizer_name)
            base_tokenizer = cfgs["base_tokenizer"]
            language = cfgs["language"]
            max_token_length = cfgs["max_token_length"]
            lower_case = cfgs["lower_case"]
            stem = cfgs["stem"]
            remove_stop_words = cfgs["remove_stop_words"]
            ascii_folding = cfgs["ascii_folding"]
        config = FTS(
            with_position=with_position,
            base_tokenizer=base_tokenizer,  # type: ignore[arg-type]
            language=language,
            max_token_length=max_token_length,
            lower_case=lower_case,
            stem=stem,
            remove_stop_words=remove_stop_words,
            ascii_folding=ascii_folding,
            ngram_min_length=ngram_min_length,
            ngram_max_length=ngram_max_length,
            prefix_only=prefix_only,
            dict_path=dict_path,
        )
        meta = build_fts_index(self._dataset, fields, config)
        self._dataset.add_index(meta, replace=replace)
        self._invalidate_caches()

    # --------------------------------------------------------------- fts

    def _get_fts_index(self, meta):
        from .index.fts import load_fts_index

        with self._fts_lock:
            fts = self._fts_indexes.get(meta.uuid)
            if fts is None:
                fts = load_fts_index(self._dataset, meta)
                self._fts_indexes[meta.uuid] = fts
        return fts

    def tokenize(
        self, query: str, *, column: str | None = None, index_name: str | None = None
    ) -> list[FtsToken]:
        """Tokenize a query with the tokenizer configured on an FTS index
        (reference table.py:1027). Specify at most one of ``column`` /
        ``index_name``; with neither, the table's first FTS index is used."""
        if column is not None and index_name is not None:
            raise InvalidInputError("specify only one of column / index_name")
        chosen = None
        for ix in self._dataset.manifest.indices:
            if ix.index_type != "FTS":
                continue
            if index_name is not None and ix.name != index_name:
                continue
            if column is not None and column not in ix.columns:
                continue
            chosen = ix
            break
        if chosen is None:
            raise InvalidInputError("no matching FTS index to tokenize with")
        tok = self._get_fts_index(chosen).tokenizer
        return [FtsToken(text=t, position=i) for i, t in enumerate(tok.tokenize(query))]

    def _execute_fts(
        self,
        query,
        columns=None,
        k: int = DEFAULT_TOP_K,
        offset: int = 0,
        filter: str | None = None,
        prefilter: bool = True,
        select=None,
        with_row_id: bool = False,
    ) -> pa.Table:
        from .index.fts import execute_fts_query

        return execute_fts_query(
            self, query, columns=columns, k=k, offset=offset, filter=filter,
            prefilter=prefilter, select=select, with_row_id=with_row_id,
        )
