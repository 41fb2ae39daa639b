"""lancedb_tpu_torch — the vector database of ``lancedb_tpu`` in PyTorch,
with hand-written CUDA kernels for one NVIDIA H100.

Same surface and on-disk format as ``lancedb_tpu``:

    db = lancedb_tpu_torch.connect("/path/to/db")          # the CUDA card
    db = lancedb_tpu_torch.connect("/path/to/db", device="cpu")
    tbl = db.create_table("items", data)
    tbl.create_index(config=IvfPq(num_partitions=1024, num_sub_vectors=16))
    tbl.search(q).where("category < 5").nprobes(20).refine_factor(10).limit(10).to_arrow()
    tbl.create_index(config=IvfFlat(num_partitions=1024))  # or Flat()
    tbl.create_index(config=IvfSq(num_partitions=1024))  # or IvfRq()
    tbl.create_index(config=HnswFlat())  # or HnswSq(), HnswPq()
    tbl.search(q).ef(64).limit(10).to_arrow()
    tbl.search(q).metric("dot").distance_range(upper_bound=0.5).offset(5).to_arrow()
    tbl.search(token_bag).limit(10).to_arrow()  # a multivector column: MaxSim
    tbl.create_fts_index("text"); tbl.create_scalar_index("category", index_type="BITMAP")
    tbl.search("quick fox", query_type="fts").limit(10).to_arrow()
    tbl.search((q, "quick fox"), query_type="hybrid").rerank(RRFReranker()).to_arrow()
    tbl.merge_insert("id").when_matched_update_all().when_not_matched_insert_all().execute(rows)
    tbl.update(where="category = 3", values={"category": 42}); tbl.delete("id < 10")
    tbl.optimize()  # compaction, then the stale indexes rebuilt on the table's device
    tbl.checkout(v); tbl.checkout_latest(); tbl.tags.create("t", v); tbl.restore(v)
    tbl.query().where("category = 42").order_by("id").limit(5).to_arrow()
    tbl.search(q).analyze_plan()
    db.sql("SELECT category, count(*) FROM items WHERE category < 5 GROUP BY category")
    db.sql("SELECT id, _score FROM fts(docs, 'quick fox', 10)")  # EXPLAIN [ANALYZE] too
    class Doc(LanceModel):                     # embedding functions (embeddings/)
        text: str = fn.SourceField()           # fn = get_registry().get("hash").create()
        vector: Vector(fn.ndims()) = fn.VectorField()
    tbl = db.create_table("docs", schema=Doc); tbl.add([{"text": "a quick fox"}])
    tbl.search("quick fox", query_type="vector").limit(10).to_pydantic(Doc)
    tbl.fetch_blobs("media", row_ids)  # a blob_field("media") column, stored out of line
    tbl.merge_insert("id").when_matched_update_all().when_not_matched_insert_all().use_lsm()
    tbl.query().use_lsm().to_arrow(); tbl.flush_lsm()  # after tbl.set_lsm_write_spec(...)
    db = await lancedb_tpu_torch.connect_async("/path/to/db")
    server = remote.QueryServer(db).start()  # the card's server, over HTTP
    lancedb_tpu_torch.connect("db://x", host_override=server.url).open_table("items")
    ns = lancedb_tpu_torch.connect_namespace("/path/to/catalog"); ns.open_table(["prod", "items"])
    tbl.enable_sharded_serving()  # IVF_PQ over every card (lancedb_tpu_torch.parallel)
    TorchBatchFeeder(StreamingDataset(tbl), 4096)  # rows onto the cards (lancedb_tpu_torch.data)

The package imports neither JAX nor ``lancedb_tpu``; CUDA kernels build
from ``csrc/`` with nvcc on first use, and the host library of the
full-text index from ``native/lancedb_native.cpp`` with g++.
"""

from .aio import AsyncConnection, AsyncTable, connect_async
from .arrow import vector
from .blob import blob_field
from .context import contextualize
from .db import DBConnection, LanceDBConnection, connect, deserialize_conn
from .errors import (
    IndexNotFoundError,
    InvalidInputError,
    LanceDBError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
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
from .query import (
    DEFAULT_TOP_K,
    ColumnOrdering,
    LanceEmptyQueryBuilder,
    LanceFtsQueryBuilder,
    LanceHybridQueryBuilder,
    LanceQueryBuilder,
    LanceVectorQueryBuilder,
)
from .query_fts import (
    BooleanQuery,
    BoostQuery,
    FullTextQueryType,
    MatchQuery,
    MultiMatchQuery,
    Occur,
    Operator,
    PhraseQuery,
)
from .namespace import LanceNamespaceConnection, connect_namespace
from .namespace_rest import NamespaceServer, RestNamespace, connect_namespace_client
from .session import Session
from .sql_spill import set_sql_memory_budget, sql_memory_budget
from .table import MergeInsertBuilder, Table

__version__ = "0.1.0"

__all__ = [
    "set_sql_memory_budget",
    "sql_memory_budget",
    "blob_field",
    "contextualize",
    "connect",
    "connect_async",
    "connect_namespace",
    "connect_namespace_client",
    "NamespaceServer",
    "RestNamespace",
    "LanceNamespaceConnection",
    "deserialize_conn",
    "vector",
    "DBConnection",
    "LanceDBConnection",
    "AsyncConnection",
    "AsyncTable",
    "ColumnOrdering",
    "DEFAULT_TOP_K",
    "LanceEmptyQueryBuilder",
    "LanceFtsQueryBuilder",
    "LanceHybridQueryBuilder",
    "LanceQueryBuilder",
    "LanceVectorQueryBuilder",
    "MergeInsertBuilder",
    "BooleanQuery",
    "BoostQuery",
    "FullTextQueryType",
    "MatchQuery",
    "MultiMatchQuery",
    "Occur",
    "Operator",
    "PhraseQuery",
    "Table",
    "Session",
    "Auto",
    "Bitmap",
    "BTree",
    "FTS",
    "Fm",
    "LabelList",
    "Flat",
    "HnswFlat",
    "HnswPq",
    "HnswSq",
    "IvfFlat",
    "IvfPq",
    "IvfRq",
    "IvfSq",
    "LanceDBError",
    "InvalidInputError",
    "IndexNotFoundError",
    "TableAlreadyExistsError",
    "TableNotFoundError",
    "__version__",
]
