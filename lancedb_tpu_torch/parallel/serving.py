"""Serve a table's IVF_PQ index across a device mesh, through the normal
query path.

Port of the reference's parallel/serving.py. The persisted index is
dealt over the mesh (parallel/build.py ``ShardedIvfPqIndex``: blocks
sharded, per-shard top-k, merged on each query row's first device) and
plugs into the query layer the single-device searcher serves:

    tbl.enable_sharded_serving(mesh)        # once
    tbl.search(q).nprobes(20).to_arrow()    # now fans out over the mesh

``ShardedServingSearcher`` has what query.py reads from a searcher:
``search``, ``slot_penalty``, ``refine``, ``metric``,
``will_fuse_refine``, ``prepare_device_refine``, ``device_refine_active``
and ``row_ids_flat``. Prefiltered and deletion-masked queries fan out
too: the per-slot penalty is in the block layout the shards were dealt
from, so each shard adds its slice before its scan. A refine fuses per
shard against a sharded copy of the column when it fits, and otherwise
reranks the candidates on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..errors import InvalidInputError
from ..index.vector import _INVALID_ROWID


class ShardedServingSearcher:
    """Mesh-sharded stand-in for VectorSearcher (index/vector.py)."""

    def __init__(self, sharded, metric: str, params: dict, index_type: str):
        self._sharded = sharded
        self.metric = metric
        self.params = params
        self.index_type = index_type
        self._refine_unavailable = False

    @property
    def row_ids_flat(self) -> np.ndarray:
        """The row ids the index holds (padding slots dropped), which the
        query layer reads to mask fragments that have gone."""
        rid = self._sharded.row_ids
        return rid[rid != _INVALID_ROWID]

    def slot_penalty(self, allowed_row_ids, deleted_row_ids, vanished_fragments=None):
        return self._sharded.slot_penalty(
            allowed_row_ids, deleted_row_ids, vanished_fragments=vanished_fragments
        )

    def search(self, queries, params, slot_penalty=None):
        # refine reranks k·refine_factor candidates, as VectorSearcher does
        k_eff = params.k if params.refine_factor is None else params.k * params.refine_factor
        refine_k = params.k if self.will_fuse_refine(params) else None
        return self._sharded.search(
            np.asarray(queries, np.float32), k=k_eff, nprobes=params.nprobes,
            slot_penalty=slot_penalty, refine_k=refine_k,
        )

    @property
    def device_refine_active(self) -> bool:
        return self._sharded.refine_attached

    def will_fuse_refine(self, params) -> bool:
        """As VectorSearcher.will_fuse_refine: a precision='float32'
        request never reranks against a narrower table."""
        if params.refine_factor is None or not self.device_refine_active:
            return False
        return (getattr(params, "precision", "default") != "float32"
                or self._sharded.refine_dtype == torch.float32)

    def prepare_device_refine(self, dataset, column: str, precision: str | None = None) -> bool:
        """Shard a resident copy of the column over the mesh, so that
        search(refine_factor=rf) reranks per shard before the merge.

        The single-device searcher's rule (VectorSearcher.
        prepare_device_refine), under the reference's environment names:
        off with LANCEDB_TPU_DEVICE_REFINE=0; 'auto' stores f32 when the
        live rows fit LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET bytes (2e9) and
        f16 residuals against each slot's block centroid above it, so a
        1-shard mesh reranks as one device does; the table must fit
        LANCEDB_TPU_DEVICE_REFINE_BUDGET bytes (6e9) per shard. (The
        reference's sharded table is ``matmul_dtype`` unless
        precision='float32': bf16 full vectors on its TPU.)"""
        from ..ops.util import matmul_dtype
        from .mesh import SHARD_AXIS

        if self.device_refine_active:
            return True
        if self._refine_unavailable:
            return False  # remembered: no column rescan per query
        if os.environ.get("LANCEDB_TPU_DEVICE_REFINE", "1") == "0":
            return False
        sh = self._sharded
        dim = int(sh._centroids[0][0].shape[1])
        if precision in (None, "auto"):
            f32_budget = float(os.environ.get("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", 2e9))
            precision = "float32" if dataset.count_rows() * dim * 4 <= f32_budget else "float16"
        dtype = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": matmul_dtype(sh.mesh.first())}.get(precision, torch.float16)
        bytes_per = 4 if dtype == torch.float32 else 2
        budget = float(os.environ.get("LANCEDB_TPU_DEVICE_REFINE_BUDGET", 6e9))
        # checked on the index's geometry before the column is read
        if sh.num_slots * dim * bytes_per > budget * max(1, sh.mesh.shape[SHARD_AXIS]):
            self._refine_unavailable = True
            return False
        if dataset.count_rows() == 0:
            self._refine_unavailable = True
            return False
        sh.fill_refine_table(dataset, column, dtype, residual=dtype == torch.float16)
        return True

    def refine(self, dataset, column, queries, dists, row_ids, k):
        from ..index.vector import refine_candidates

        return refine_candidates(dataset, column, queries, row_ids, k, self.metric,
                                 self._sharded.mesh.first())


def make_sharded_searcher(mesh, dataset, index_meta) -> ShardedServingSearcher:
    """The serving searcher of one persisted IVF_PQ index. Raises
    InvalidInputError for an index type or metric the sharded scan does
    not serve (the caller then serves it on one device)."""
    from .build import ShardedIvfPqIndex

    if index_meta.index_type != "IVF_PQ":
        raise InvalidInputError(
            f"sharded serving supports IVF_PQ indexes (got {index_meta.index_type})"
        )
    metric = index_meta.params.get("metric", "l2")
    if metric not in ("l2", "cosine"):
        # the sharded ADC scan computes l2 expansions, which on the unit
        # sphere also give cosine; dot needs the single-device path
        raise InvalidInputError(
            f"sharded serving supports l2/cosine metrics (index is {metric})"
        )
    sharded = ShardedIvfPqIndex.from_dataset(mesh, dataset, index_meta)
    return ShardedServingSearcher(sharded, metric=metric, params=dict(index_meta.params),
                                  index_type=index_meta.index_type)
