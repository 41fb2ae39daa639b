"""Sharded IVF_PQ over a device mesh: distributed build and serving.

Port of the reference's parallel/build.py (BASELINE config #5, "DEEP100M-
scale sharded IVF_PQ": when a table exceeds one device's memory, both
the build and the serving shard over the mesh).

Build (``ShardedIvfPqIndex(mesh, vectors, ...)``):
  1. coarse centroids: data-parallel k-means (``distributed_kmeans``,
     rows sharded, ``psum`` reductions, parallel/search.py);
  2. assignment, residuals and the PQ encode on the mesh's first device
     (ops/kmeans.assign_residuals_device, ops/pq.pq_train and
     pq_encode_rnorms);
  3. the balanced padded layout of index/vector.py, padded to a multiple
     of the shard count with never-probed dummy blocks and dealt round
     robin: block b goes to shard b % shard_n at local position
     b // shard_n.

``from_dataset`` serves a persisted IVF_PQ index (OPQ included) built by
either package, without retraining.

Serving (``search``): every shard selects the same global probes, then
keeps only those it owns, compacted to the front in probe order (a
stable sort) under a per-shard budget of about 2·nprobes/shards, so the
scan's work shrinks with the mesh instead of being masked out. Each
shard launches B1 (ops/adc.ivf_pq_adc_scan, the CUDA kernel on the card)
on its own blocks, once per chunk of 128 queries (the single-device
searcher's chunk); the local top-k, an
optional per-shard fused refine and the merge follow.

Both run from one controller, as the reference's do: a mesh of several
processes (mesh.py ``make_process_mesh``) is refused.

Two orders meet here: codes, rnorms, the penalty and the refine table
are dealt, while ``row_ids`` and the global slot ``block·pmax + offset``
stay in the original block order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.vector import (_INVALID_ROWID, _Q_CHUNK, _balanced_layout, _pq_dlut,
                            _scatter_padded, _select_probes)
from ..ops.adc import PMAX_ALIGN, S_ALIGN, ivf_pq_adc_scan
from ..ops.kmeans import assign_residuals_device
from ..ops.pq import default_num_sub_vectors, pq_encode_rnorms, pq_train
from ..ops.topk import topk_smallest
from ..ops.util import cdiv, matmul_dtype, round_up
from .mesh import (QUERY_AXIS, SHARD_AXIS, _as_tensor, _owned_grid, _to, all_gather_cat,
                   first_owned, one_process_only, replicate, shard_rows)
from .search import PAD, make_distributed_kmeans_step

# centroid magnitude for never-probed dummy blocks (|c|² ≈ 1e30 keeps
# the padded block out of every probe list without overflowing f32)
_DUMMY_CENTROID = np.float32(1.0e15)


def distributed_kmeans(
    mesh, data: np.ndarray, k: int, iters: int = 25, seed: int = 0
) -> np.ndarray:
    """Full distributed Lloyd: rows sharded over the mesh, centroids
    replicated, ``psum`` reductions per iteration. The pad rows and the
    initial centroids are the reference's numpy draws. On a mesh of
    several processes every rank passes the same ``data`` and ``seed``
    (the reference's ``device_put`` of one host array), places its own
    cells' rows and gets the same centroids."""
    rng = np.random.default_rng(seed)
    n_dev = mesh.size
    n = len(data)
    pad = (-n) % n_dev
    if pad:
        data = np.concatenate([data, data[rng.integers(0, n, pad)]])
    step = make_distributed_kmeans_step(mesh, k=k)
    xj = shard_rows(mesh, np.asarray(data, np.float32), over=(QUERY_AXIS, SHARD_AXIS))
    cents = replicate(mesh, np.asarray(data[rng.choice(n, k, replace=False)], np.float32))
    for _ in range(iters):
        cents, _counts = step(xj, cents)
    return first_owned(cents).cpu().numpy()



class ShardedIvfPqIndex:
    """Mesh-sharded IVF_PQ: blocks sharded, centroids and codebooks
    replicated; per-shard compacted-probe ADC scan and a merge."""

    def __init__(
        self,
        mesh,
        vectors: np.ndarray,
        row_ids: np.ndarray,
        num_partitions: int,
        num_sub_vectors: int | None = None,
        metric: str = "l2",
        kmeans_iters: int = 25,
        seed: int = 0,
        num_bits: int = 8,
    ):
        one_process_only(mesh, "sharded IVF_PQ builds and serves")
        self.mesh = mesh
        self.metric = metric
        n, dim = vectors.shape
        nsub = num_sub_vectors or default_num_sub_vectors(dim)

        # 1. distributed coarse k-means
        centroids = distributed_kmeans(mesh, vectors, num_partitions, kmeans_iters, seed)
        # 2. assignment + residuals + PQ, on the mesh's first device
        dev = mesh.first()
        xd = _to(_as_tensor(np.asarray(vectors, np.float32)), dev)
        cents_d = _to(torch.from_numpy(centroids), dev)
        chunk = min(1 << 17, int(round_up(n, 8)))
        assign_d, res_d = assign_residuals_device(xd, cents_d, metric="l2", chunk=chunk,
                                                  with_residuals=True)
        del xd
        assign = assign_d.cpu().numpy()
        train_rows = min(n, 256 * 256)
        rng = np.random.default_rng(seed + 1)
        sel = rng.choice(n, train_rows, replace=False) if train_rows < n else np.arange(n)
        codebooks = pq_train(res_d[torch.from_numpy(sel).to(dev)].cpu().numpy(), nsub,
                             num_bits=num_bits, seed=seed, device=dev)
        codes, rnorms_flat = pq_encode_rnorms(res_d, cents_d, assign_d, codebooks)
        del res_d, assign_d, cents_d

        # 3. balanced layout, padded to a shard multiple with dummy blocks
        order, block_cents, counts, pmax = _balanced_layout(
            assign, centroids, pad_multiple=PMAX_ALIGN
        )
        codes_p = _scatter_padded(codes, order, counts, pmax)  # (B, pmax, S)
        rn_p = _scatter_padded(rnorms_flat, order, counts, pmax, fill=np.float32(PAD))
        rid_p = _scatter_padded(np.asarray(row_ids).view(np.int64), order, counts, pmax, fill=-1)
        # kernel layout: subvectors, then slots
        s_pad = int(round_up(nsub, S_ALIGN))
        codes_psp = np.ascontiguousarray(codes_p.transpose(0, 2, 1))
        if s_pad != nsub:
            codes_psp = np.pad(codes_psp, ((0, 0), (0, s_pad - nsub), (0, 0)))
        self._place(codes_psp, rn_p, rid_p, block_cents, codebooks, pmax, num_partitions)

    @classmethod
    def from_dataset(cls, mesh, dataset, index_meta) -> "ShardedIvfPqIndex":
        """Serve a persisted IVF_PQ index across the mesh: load the
        balanced-block arrays build_vector_index wrote (codes (P, S_pad,
        pmax), rnorms, centroids, row_ids, codebooks, the OPQ rotation)
        and deal them round robin. Built once, served on N devices."""
        from ..index.vector import _load_npy

        one_process_only(mesh, "sharded IVF_PQ builds and serves")
        if index_meta.index_type != "IVF_PQ":
            raise ValueError(f"from_dataset serves IVF_PQ; got {index_meta.index_type}")
        store = dataset.store
        prefix = dataset.index_dir(index_meta.uuid)
        self = cls.__new__(cls)
        self.mesh = mesh
        self.metric = index_meta.params["metric"]

        def load(stem: str) -> np.ndarray:
            return np.asarray(_load_npy(store, f"{prefix}/{stem}.npy"))

        codes_psp = load("codes")
        self._place(
            codes_psp, load("rnorms"), load("row_ids"), load("centroids"), load("codebooks"),
            index_meta.params["pmax"],
            index_meta.params.get("num_logical_partitions", codes_psp.shape[0]),
            rotation=load("rotation") if index_meta.params.get("opq") else None,
        )
        return self

    def _place(self, codes_psp, rn_p, rid_p, block_cents, codebooks, pmax, num_logical,
               rotation=None):
        """Shard-pad, deal round robin, place on the mesh."""
        mesh = self.mesh
        shard_n = mesh.shape[SHARD_AXIS]
        nblocks = codes_psp.shape[0]
        dim = block_cents.shape[1]
        pad_blocks = (-nblocks) % shard_n
        if pad_blocks:
            codes_psp = np.pad(codes_psp, ((0, pad_blocks), (0, 0), (0, 0)))
            rn_p = np.pad(rn_p, ((0, pad_blocks), (0, 0)), constant_values=np.float32(PAD))
            rid_p = np.pad(rid_p, ((0, pad_blocks), (0, 0)), constant_values=-1)
            block_cents = np.concatenate(
                [block_cents, np.full((pad_blocks, dim), _DUMMY_CENTROID, np.float32)]
            )
            nblocks += pad_blocks

        self.row_ids = np.ascontiguousarray(rid_p).reshape(-1).view(np.uint64)
        self.pmax = pmax
        self.nblocks = nblocks
        self.num_logical_partitions = num_logical
        # deal blocks round robin: block b goes to shard b % shard_n at
        # local position b // shard_n, which spreads centroid-space
        # neighbours (probed together) over the mesh. row_ids stay in the
        # original block order: global slot = b·pmax + offset.
        self._deal = np.concatenate([np.arange(s, nblocks, shard_n) for s in range(shard_n)])
        self.num_slots = nblocks * pmax
        self._centroids = replicate(mesh, np.asarray(block_cents, np.float32))
        self._codebooks = replicate(mesh, np.asarray(codebooks, np.float32))
        self._codes = shard_rows(mesh, codes_psp[self._deal])
        self._rnorms = shard_rows(mesh, np.asarray(rn_p, np.float32)[self._deal])
        # OPQ: codes quantize rotated residuals; the LUT builds from R·q
        self._rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self._refine_vecs = self._refine_norms2 = None
        self._refine_residual = False

    def _budget(self, nprobes: int) -> int:
        """The static per-shard probe budget: every shard owns about
        nprobes/shard_n of a query's probes (blocks deal round robin);
        twice that plus slack keeps a drop rare, and a shard can never
        usefully scan more than the blocks it owns."""
        shard_n = self.mesh.shape[SHARD_AXIS]
        return min(nprobes, self.nblocks // shard_n, 2 * cdiv(nprobes, shard_n) + 4)

    def _scan_inputs(self, i: int, j: int, q: torch.Tensor, q_lut: torch.Tensor, pen,
                     nprobes: int):
        """One shard's B1 inputs for one chunk of queries → (the six
        arguments of ivf_pq_adc_scan, the selected global block ids, which
        of them this shard owns)."""
        shard_n = self.mesh.shape[SHARD_AXIS]
        codes_loc = self._codes[i][j]
        rn_loc = self._rnorms[i][j]
        if pen is not None:
            # the prefilter/deletion penalty adds into the residual-norm
            # term; clamped, so PAD + PAD stays PAD
            rn_loc = torch.clamp(rn_loc + pen[i][j], max=PAD)
        probe_ids, probe_dots = _select_probes(q, self._centroids[i][j], nprobes, "l2")
        # blocks deal round robin: block b lives on shard b % shard_n
        mine = probe_ids % shard_n == j
        # this shard's probes first, in probe order, under the budget
        comp = torch.argsort((~mine).to(torch.int8), dim=1, stable=True)[:, :self._budget(nprobes)]
        sel_ids = torch.gather(probe_ids, 1, comp)
        sel_dots = torch.gather(probe_dots, 1, comp)
        sel_mine = torch.gather(mine, 1, comp)
        local_ids = torch.where(sel_mine, torch.div(sel_ids, shard_n, rounding_mode="floor"),
                                0).to(torch.int32)
        dlut = _pq_dlut(q_lut, self._codebooks[i][j], codes_loc.shape[1])
        qn2 = torch.sum(torch.square(q), dim=-1)
        args = (local_ids, dlut, codes_loc, rn_loc.contiguous(), sel_dots.contiguous(),
                qn2.contiguous())
        return args, sel_ids, sel_mine

    def _shard_step(self, i: int, j: int, q: torch.Tensor, q_lut: torch.Tensor, pen, k: int,
                    nprobes: int, refine_k: int | None):
        """One shard's scan of one chunk of queries → (vals, global slots)."""
        pmax = self.pmax
        qb = q.shape[0]
        args, sel_ids, sel_mine = self._scan_inputs(i, j, q, q_lut, pen, nprobes)
        local_ids, qn2 = args[0], args[5]
        d = ivf_pq_adc_scan(*args)  # (Q, budget, pmax)
        d = torch.where(sel_mine[:, :, None], d, PAD)
        # k may exceed this shard's candidate pool (small nprobes × refine)
        vals, pos = topk_smallest(d.reshape(qb, -1), min(k, d.shape[1] * pmax))
        blk_pos = torch.div(pos, pmax, rounding_mode="floor")
        off = pos % pmax
        slots = torch.gather(sel_ids, 1, blk_pos) * pmax + off
        if refine_k is not None:
            # each shard's candidates are its own rows, so the refine
            # table shards with the blocks: rerank the local pool exactly,
            # keep the local top refine_k, merge by exact distance
            rvec, rn2 = self._refine_vecs[i][j], self._refine_norms2[i][j]
            lb = torch.gather(local_ids.long(), 1, blk_pos)
            cand = rvec[lb, off].float()  # (Q, kl, D)
            if self._refine_residual:
                # x̂ = the slot's block centroid + its stored residual, in f32
                cand = cand + self._centroids[i][j][torch.div(slots, pmax,
                                                              rounding_mode="floor")]
                q_r = q
            else:
                q_r = q.to(rvec.dtype).float()
            dots_r = torch.einsum("qd,qcd->qc", q_r, cand)
            if self.metric == "cosine":
                exact = 1.0 - dots_r  # unit norm on both sides
            else:
                exact = torch.clamp(qn2[:, None] - 2.0 * dots_r + rn2[lb, off], min=0.0)
            exact = torch.where(vals >= PAD / 2, PAD, exact)
            vals, rpos = topk_smallest(exact, min(refine_k, exact.shape[1]))
            slots = torch.gather(slots, 1, rpos)
        return vals, slots

    def attach_refine_table(self, vecs_slot: np.ndarray, norms2_slot: np.ndarray,
                            dtype=None, residual: bool = False) -> None:
        """Shard a refine table over the mesh for the fused per-shard
        rerank. ``vecs_slot`` (num_slots, D) holds the original vectors in
        slot order (unit norm for cosine, zeros on padding and dead slots),
        or with ``residual`` their residuals against each slot's block
        centroid; ``norms2_slot`` (num_slots,) the rows' exact f32 squared
        norms. Dealt like the codes, so every shard reranks its own rows.
        ``dtype`` sets the resident precision (torch.float32 for exact
        reranks; default ``matmul_dtype``, bf16 on the card)."""
        if vecs_slot.shape[0] != self.num_slots:
            raise ValueError(
                f"refine table has {vecs_slot.shape[0]} slots, index has {self.num_slots}"
            )
        dt = dtype if dtype is not None else matmul_dtype(self.mesh.first())
        vec_b = np.asarray(vecs_slot, np.float32).reshape(self.nblocks, self.pmax, -1)[self._deal]
        self._refine_vecs = shard_rows(self.mesh, torch.from_numpy(vec_b).to(dt))
        self._refine_residual = residual
        self._refine_norms2 = shard_rows(
            self.mesh,
            np.asarray(norms2_slot, np.float32).reshape(self.nblocks, self.pmax)[self._deal],
        )

    def fill_refine_table(self, dataset, column: str, dtype, residual: bool = False) -> None:
        """Shard the refine table ``attach_refine_table`` takes, filled on
        each shard's device from ``column`` streamed a block of rows at a
        time: the same values (each slot's row, unit norm for cosine, zeros
        on padding and dead slots, or with ``residual`` the row less its
        slot's block centroid, in ``dtype``; f32 norms of the original
        rows) in the same dealt order. A block finds its slots through the
        slots sorted by row id (8 bytes a slot on the host); the host never
        holds the (num_slots, D) table, which at 100M x 96 is 59 GB of f32."""
        from ..index.vector import _column_blocks, _scan_row_ids, _sq_norms

        mesh = self.mesh
        shard_n = mesh.shape[SHARD_AXIS]
        pmax = self.pmax
        local_slots = self.nblocks // shard_n * pmax
        dim = int(self._centroids[0][0].shape[1])
        devs = [mesh.devices[0, j] for j in range(shard_n)]
        vecs = [torch.zeros((local_slots, dim), dtype=dtype, device=d) for d in devs]
        norms2 = [torch.zeros(local_slots, dtype=torch.float32, device=d) for d in devs]
        by_rid = np.argsort(self.row_ids)  # padding (2^64 - 1) sorts last
        rid_sorted = self.row_ids[by_rid]
        rid_scan, _ = _scan_row_ids(dataset)
        first = mesh.first()
        for start, blk in _column_blocks(dataset, column, self.metric, first):
            rid = rid_scan[start : start + blk.shape[0]]
            lo = np.searchsorted(rid_sorted, rid.min())
            hi = np.searchsorted(rid_sorted, rid.max(), side="right")
            cand_rid, cand_slot = rid_sorted[lo:hi], by_rid[lo:hi]
            row_order = np.argsort(rid)
            at = np.clip(np.searchsorted(rid, cand_rid, sorter=row_order), 0, len(rid) - 1)
            rows = row_order[at]
            hit = rid[rows] == cand_rid
            rows, slots = rows[hit], cand_slot[hit]
            block = slots // pmax
            shard = block % shard_n
            for j, dev in enumerate(devs):
                mine = shard == j
                if not mine.any():
                    continue
                x = blk[torch.from_numpy(rows[mine]).to(first)].to(dev)
                local = (block[mine] // shard_n) * pmax + slots[mine] % pmax
                at_j = torch.from_numpy(local).to(dev)
                norms2[j][at_j] = _sq_norms(x)
                if residual:
                    x = x - self._centroids[0][j][torch.from_numpy(block[mine]).to(dev)]
                vecs[j][at_j] = x.to(dtype)
        self._refine_vecs = _owned_grid(
            mesh, lambda i, j: _to(vecs[j].reshape(-1, pmax, dim), mesh.devices[i, j]))
        self._refine_norms2 = _owned_grid(
            mesh, lambda i, j: _to(norms2[j].reshape(-1, pmax), mesh.devices[i, j]))
        self._refine_residual = residual

    @property
    def refine_attached(self) -> bool:
        return self._refine_vecs is not None

    @property
    def refine_dtype(self) -> torch.dtype | None:
        return None if self._refine_vecs is None else self._refine_vecs[0][0].dtype

    def slot_penalty(
        self,
        allowed_row_ids: np.ndarray | None,
        deleted_row_ids: np.ndarray | None,
        vanished_fragments: set[int] | None = None,
    ) -> np.ndarray | None:
        """Per-slot additive penalty in the original block order (the
        single-device searcher's layout, VectorSearcher.slot_penalty),
        sized to this index's shard-padded slot count."""
        no_deleted = deleted_row_ids is None or not len(deleted_row_ids)
        if allowed_row_ids is None and no_deleted and not vanished_fragments:
            return None
        penalty = np.zeros(self.num_slots, dtype=np.float32)
        rid = self.row_ids
        if allowed_row_ids is not None:
            penalty[~np.isin(rid, allowed_row_ids)] = PAD
        if not no_deleted:
            penalty[np.isin(rid, deleted_row_ids)] = PAD
        if vanished_fragments:
            frag_of = (rid >> np.uint64(32)).astype(np.int64)
            dead = np.isin(frag_of, np.fromiter(vanished_fragments, dtype=np.int64))
            penalty[dead] = PAD
        return penalty

    def dealt_penalty(self, slot_penalty: np.ndarray | None):
        """A per-slot penalty in block order (this index's, or the
        single-device searcher's, which is a prefix of it) dealt into shard
        order as the blocks were, placed on the mesh."""
        if slot_penalty is None:
            return None
        full = np.zeros(self.num_slots, dtype=np.float32)
        full[: len(slot_penalty)] = slot_penalty
        return shard_rows(self.mesh, full.reshape(self.nblocks, self.pmax)[self._deal])

    def block_nprobes(self, nprobes: int) -> int:
        """The user's nprobes in blocks (duplicate-centroid splitting)."""
        return min(
            self.nblocks,
            max(1, int(np.ceil(nprobes * self.nblocks / self.num_logical_partitions))),
        )

    def search(self, queries: np.ndarray, k: int, nprobes: int = 20,
               slot_penalty: np.ndarray | None = None,
               refine_k: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(distances (Q, k) f32, row ids (Q, k) uint64); slots that fell
        off the index come back as +inf and 2^64 - 1."""
        mesh = self.mesh
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == "cosine":
            # the index quantizes unit vectors; the ADC scan then gives
            # l2² = 2·(1 − cos), as the single-device cosine path does
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        nq = q.shape[0]
        pad_q = (-nq) % max(mesh.shape[QUERY_AXIS], 1)
        if pad_q:
            q = np.pad(q, ((0, pad_q), (0, 0)))
        npb = self.block_nprobes(nprobes)
        if refine_k is not None and not self.refine_attached:
            raise ValueError("refine_k requires attach_refine_table first")
        pen = self.dealt_penalty(slot_penalty)
        q_lut = q if self._rotation is None else q @ self._rotation.T
        qs = shard_rows(mesh, q, over=QUERY_AXIS)
        qls = shard_rows(mesh, np.ascontiguousarray(q_lut, np.float32), over=QUERY_AXIS)
        k_merge = refine_k if refine_k is not None else k
        out_v, out_s = [], []
        for i in range(mesh.shape[QUERY_AXIS]):
            for c0 in range(0, qs[i][0].shape[0], _Q_CHUNK):
                parts = [
                    self._shard_step(i, j, qs[i][j][c0 : c0 + _Q_CHUNK],
                                     qls[i][j][c0 : c0 + _Q_CHUNK], pen, k, npb, refine_k)
                    for j in range(mesh.shape[SHARD_AXIS])
                ]
                all_v = all_gather_cat([p[0] for p in parts], 1, mesh.first(i))
                all_s = all_gather_cat([p[1] for p in parts], 1, mesh.first(i))
                mv, mp = topk_smallest(all_v, min(k_merge, all_v.shape[1]))
                out_v.append(mv.cpu())
                out_s.append(torch.gather(all_s, 1, mp).cpu())
        vals = torch.cat(out_v).numpy()[:nq]
        slots = torch.cat(out_s).numpy()[:nq]
        rids = self.row_ids[slots]
        invalid = vals >= np.float32(3.0e38) / 2
        rids = np.where(invalid, _INVALID_ROWID, rids)
        vals = np.where(invalid, np.inf, vals)
        if self.metric == "cosine" and refine_k is None:
            # unit-sphere l2² → cosine distance (as single-device); refined
            # values are already cosine distances
            vals = np.where(np.isfinite(vals), vals / 2.0, vals)
        if vals.shape[1] < k_merge:
            # a candidate pool smaller than k: pad with the invalid markers
            pad = k_merge - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
            rids = np.pad(rids, ((0, 0), (0, pad)), constant_values=_INVALID_ROWID)
        return vals.astype(np.float32), rids
