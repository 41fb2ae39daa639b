"""Sharded search and data-parallel k-means over a device mesh.

Port of the reference's parallel/search.py. There each program is a
``shard_map``: database rows (or IVF partitions) sharded over the
``shard`` axis, queries over the ``query`` axis, per-device top-k merged
with ``all_gather``. Here each is a plain function that loops over the
mesh's grid (parallel/mesh.py), with the same arithmetic:

* ``make_sharded_flat_search``: each cell scores its (query block × row
  shard) tile, keeps its local top-k, and the shards' candidates merge
  on the query row's first device;
* ``make_sharded_ivf_search``: centroids replicated, padded partitions
  sharded; every shard selects the same global probes and scans only
  those it owns (partition p lives on shard p // p_loc), the others
  masked with PAD;
* ``make_distributed_kmeans_step``: one Lloyd iteration with rows sharded
  over both axes: local assignment and per-cluster sums, ``psum``
  reductions, the update.

On a mesh of several processes (mesh.py ``make_process_mesh``) each rank
runs its own cells and meets the others in ``all_gather_cells``: twice a
chunk of queries (the candidates' values, then their ids) and twice a
k-means step (the sums, then the counts). The merge and the sums then
run on every rank in global shard order, so every rank returns the whole
result, bit for bit the one-process mesh's.

The products run in ``ops/util.matmul_dtype``: bf16 on the card, f32 on
the CPU, as the reference runs them in bf16 on the TPU and f32 on its CPU
backend. Queries are scanned a chunk at a time so a step's transients
stay bounded; the chunks change no result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.vector import _PAD as PAD
from ..ops.kmeans import _sum_rows
from ..ops.topk import topk_smallest
from ..ops.util import lowp
from .mesh import (QUERY_AXIS, SHARD_AXIS, all_gather_cat, all_gather_cells, first_owned,
                   pad_to_multiple, psum, replicate, shard_rows)

# bytes one chunk of a step's largest transient may take (the flat tile's
# distances with their sort, the IVF step's gathered partitions)
_CHUNK_BYTES = 1 << 30


def _local_flat_scores(q, x, norms2, metric: str) -> torch.Tensor:
    qf = q.float()
    dots = lowp(qf) @ lowp(x).T
    if metric == "dot":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(torch.square(qf), dim=-1, keepdim=True))
        return 1.0 - dots / torch.clamp(qn, min=1e-30)
    qn2 = torch.sum(torch.square(qf), dim=-1, keepdim=True)
    return qn2 - 2.0 * dots + norms2[None, :]


def _merge(vals: list, ids: list, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates, gathered in shard order, → the k smallest."""
    all_vals = all_gather_cat(vals, 1, device)
    all_ids = all_gather_cat(ids, 1, device)
    m_vals, pos = topk_smallest(all_vals, k)
    return m_vals, torch.gather(all_ids, 1, pos)


def _query_rows(mesh, q, chunk: int, k: int, local):
    """Run ``local(i, j, q_chunk) → (vals, ids)`` on every owned cell for
    each chunk of its query block, gather the cells' candidates across
    ranks, merge each query row's k smallest over its shards on the row's
    first device, and concatenate the rows on the mesh's first device →
    (Q, k) values and ids, on every rank. Every query block has the same
    rows, so every rank counts the same chunks and meets the others in
    each gather."""
    qp, sn = mesh.shape[QUERY_AXIS], mesh.shape[SHARD_AXIS]
    out_v, out_i = [[] for _ in range(qp)], [[] for _ in range(qp)]
    for c0 in range(0, first_owned(q).shape[0], chunk):
        vals = [[None] * sn for _ in range(qp)]
        ids = [[None] * sn for _ in range(qp)]
        for i, j in mesh.cells:
            vals[i][j], ids[i][j] = local(i, j, q[i][j][c0 : c0 + chunk])
        vals, ids = all_gather_cells(mesh, vals), all_gather_cells(mesh, ids)
        for i in range(qp):
            v, idx = _merge(vals[i], ids[i], k, mesh.first(i))
            out_v[i].append(v.to(mesh.first()))
            out_i[i].append(idx.to(mesh.first()))
    return torch.cat([v for row in out_v for v in row]), torch.cat([i for row in out_i for i in row])


def make_sharded_flat_search(mesh, k: int, metric: str = "l2"):
    """A sharded brute-force search step.

    Inputs, placed on the mesh (parallel/mesh.py):
      q        (Q, D)  shard_rows(..., over=QUERY_AXIS)
      x        (N, D)  shard_rows over SHARD_AXIS
      norms2   (N,)    sharded like x (+PAD on padding rows)
      rowids   (N,)    int32 global slot ids, sharded like x
    Output: (Q, k) distances + (Q, k) global ids on the mesh's first device."""

    def step(q, x, norms2, rowids):
        n_loc = first_owned(x).shape[0]
        chunk = max(1, _CHUNK_BYTES // max(1, 16 * n_loc))

        def local(i, j, q_blk):
            d = _local_flat_scores(q_blk, x[i][j], norms2[i][j], metric)
            vals, idx = topk_smallest(d, min(k, d.shape[1]))
            ids = rowids[i][j][idx]
            if vals.shape[1] < k:
                pad = k - vals.shape[1]
                vals = torch.nn.functional.pad(vals, (0, pad), value=PAD)
                ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            return vals, ids

        return _query_rows(mesh, q, chunk, k, local)

    return step


def make_sharded_ivf_search(mesh, k: int, nprobes: int, metric: str = "l2"):
    """A sharded IVF_FLAT search step.

    Inputs, placed on the mesh (P partitions, sharded over SHARD_AXIS):
      q          (Q, D)        shard_rows(..., over=QUERY_AXIS)
      centroids  (P, D)        replicate
      parts      (P, pmax, D)  shard_rows over SHARD_AXIS
      norms2     (P, pmax)     sharded like parts (+PAD padding)
      rowids     (P, pmax)     int32 global ids, sharded like parts
    Output: (Q, k) distances + (Q, k) global ids on the mesh's first device."""

    def step(q, centroids, parts, norms2, rowids):
        p_loc, pmax, dim = first_owned(parts).shape
        chunk = max(1, _CHUNK_BYTES // max(1, 8 * nprobes * pmax * dim))

        def local(i, j, q_blk):
            cents, parts_loc = centroids[i][j], parts[i][j]
            n2_loc, rid_loc = norms2[i][j], rowids[i][j]
            # global probe selection on the replicated centroids
            qf = q_blk.float()
            dots = lowp(qf) @ lowp(cents).T
            cn2 = torch.sum(torch.square(cents), dim=-1)
            cd = torch.sum(torch.square(qf), -1, keepdim=True) - 2.0 * dots + cn2[None, :]
            _, probe_ids = topk_smallest(cd, nprobes)  # (Qb, nprobes) global
            # ownership: partition p lives on shard p // p_loc at local p % p_loc
            mine = torch.div(probe_ids, p_loc, rounding_mode="floor") == j
            safe_ids = torch.where(mine, probe_ids % p_loc, 0)
            g_vecs = parts_loc[safe_ids]  # (Qb, np, pmax, D)
            g_n2 = n2_loc[safe_ids]
            g_rid = rid_loc[safe_ids]
            dots_p = torch.einsum("qnpd,qd->qnp", lowp(g_vecs), lowp(qf))
            pad_pen = torch.where(g_n2 >= PAD, PAD, 0.0)
            if metric == "dot":
                d = -dots_p + pad_pen
            elif metric == "cosine":
                qn = torch.sqrt(torch.sum(torch.square(qf), -1))[:, None, None]
                d = 1.0 - dots_p / torch.clamp(qn, min=1e-30) + pad_pen
            else:
                qn2 = torch.sum(torch.square(qf), -1)[:, None, None]
                d = qn2 - 2.0 * dots_p + g_n2
            d = torch.where(mine[:, :, None], d, PAD)  # mask probes this shard does not own
            qb = q_blk.shape[0]
            vals, pos = topk_smallest(d.reshape(qb, -1), k)
            return vals, torch.gather(g_rid.reshape(qb, -1), 1, pos)

        return _query_rows(mesh, q, chunk, k, local)

    return step


def make_distributed_kmeans_step(mesh, k: int, metric: str = "l2"):
    """One data-parallel Lloyd iteration (the training step).

    x (N, D) placed with shard_rows(..., over=(QUERY_AXIS, SHARD_AXIS));
    centroids (K, D) replicated. Returns the updated centroids and the
    global counts, both replicated. The partial sums and counts reduce
    over the shard axis, then over the query axis, as the reference's
    two ``psum``s do. The assignment is l2 whatever ``metric`` says, as
    in the reference, whose signature this keeps."""

    def step(x, centroids):
        qp, sn = mesh.shape[QUERY_AXIS], mesh.shape[SHARD_AXIS]
        first = mesh.first()
        sums = [[None] * sn for _ in range(qp)]
        counts = [[None] * sn for _ in range(qp)]
        for i, j in mesh.cells:
            sums[i][j], counts[i][j] = _kmeans_partials(x[i][j], centroids[i][j], k)
        sums, counts = all_gather_cells(mesh, sums), all_gather_cells(mesh, counts)
        g_sums = psum([psum(sums[i], mesh.first(i)) for i in range(qp)], first)
        g_counts = psum([psum(counts[i], mesh.first(i)) for i in range(qp)], first)
        new = g_sums / torch.clamp(g_counts[:, None], min=1.0)
        new = torch.where((g_counts > 0)[:, None], new, first_owned(centroids).to(first))
        return replicate(mesh, new), replicate(mesh, g_counts)

    return step


def _kmeans_partials(x_loc: torch.Tensor, cents: torch.Tensor, k: int):
    """One cell's assignment → (per-cluster sums (K, D) f32 of the rows
    rounded to matmul_dtype, counts (K,) f32), a chunk of rows at a time."""
    dev = x_loc.device
    c_lp = lowp(cents)
    cn2 = torch.sum(torch.square(cents), dim=-1)
    sums = torch.zeros((k, x_loc.shape[1]), dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    chunk = max(1, _CHUNK_BYTES // (8 * k))
    for s in range(0, x_loc.shape[0], chunk):
        xf = x_loc[s : s + chunk].float()
        xb = lowp(xf)
        xn2 = torch.sum(torch.square(xf), dim=-1)
        assign = torch.argmin(xn2[:, None] - 2.0 * (xb @ c_lp.T) + cn2[None, :], dim=-1)
        _sum_rows(sums, assign, xb)
        counts += torch.bincount(assign, minlength=k).float()
    return sums, counts


class ShardedFlatIndex:
    """Vectors sharded over a mesh, served in batches (BASELINE config #5's
    sharded half: a table larger than one device's memory)."""

    def __init__(self, mesh, vectors: np.ndarray, row_ids: np.ndarray, metric: str = "l2"):
        self.mesh = mesh
        self.metric = metric
        n_shards = mesh.shape[SHARD_AXIS] * mesh.shape.get(QUERY_AXIS, 1)
        vecs, n_real = pad_to_multiple(np.asarray(vectors, np.float32), n_shards, axis=0)
        norms2 = np.sum(vecs.astype(np.float64) ** 2, axis=1).astype(np.float32)
        norms2[n_real:] = np.float32(3.0e38)
        self.row_ids = row_ids
        self.n_real = n_real
        self.x = shard_rows(mesh, vecs)
        self.norms2 = shard_rows(mesh, norms2)
        self.slot_ids = shard_rows(mesh, np.arange(len(vecs), dtype=np.int32))

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = q.shape[0]
        pad_q = (-nq) % max(self.mesh.shape[QUERY_AXIS], 1)
        if pad_q:
            q = np.pad(q, ((0, pad_q), (0, 0)))
        step = make_sharded_flat_search(self.mesh, k, self.metric)
        vals, slots = step(shard_rows(self.mesh, q, over=QUERY_AXIS), self.x, self.norms2,
                           self.slot_ids)
        vals = vals.cpu().numpy()[:nq]
        slots = slots.cpu().numpy()[:nq]
        ids = np.where(
            (slots >= 0) & (slots < self.n_real) & np.isfinite(vals),
            self.row_ids[np.clip(slots, 0, self.n_real - 1)],
            np.uint64(np.iinfo(np.uint64).max),
        )
        return vals, ids
