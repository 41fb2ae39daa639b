"""The device mesh: sharded search, distributed k-means and sharded
IVF_PQ serving over a (query, shard) grid of torch devices driven by one
process, and the searches and k-means over a grid that spans several
processes under torch.distributed (port of the reference's parallel/)."""

from .build import ShardedIvfPqIndex, distributed_kmeans
from .mesh import (QUERY_AXIS, SHARD_AXIS, Mesh, make_mesh, make_process_mesh, replicate,
                   shard_local_rows, shard_rows)
from .search import (
    ShardedFlatIndex,
    make_distributed_kmeans_step,
    make_sharded_flat_search,
    make_sharded_ivf_search,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_process_mesh",
    "shard_local_rows",
    "shard_rows",
    "replicate",
    "SHARD_AXIS",
    "QUERY_AXIS",
    "ShardedFlatIndex",
    "make_sharded_flat_search",
    "make_sharded_ivf_search",
    "make_distributed_kmeans_step",
    "ShardedIvfPqIndex",
    "distributed_kmeans",
]
