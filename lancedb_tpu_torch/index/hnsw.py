"""HNSW graph indexes: IVF_HNSW_FLAT / IVF_HNSW_SQ / IVF_HNSW_PQ.

Port of the reference's index/hnsw.py. The reference computes the graph
and its batched beam in XLA ops (no Pallas kernel), so here they are
torch ops on the device; the host walks are numpy, copied.

Build (batch-first, CAGRA-style, on the device): per layer a kNN graph
from a bf16 coarse product and an exact f32 rescore (one exact f32 pass
at 8192 rows or fewer), occlusion pruning, a 2-hop candidate pool and a
second prune, then a dense padded adjacency with degree-capped reverse
edges. The files are the reference's ``dense_v2`` layout, so either
package serves the other's graph.

Serving is two-tier, routed as in the reference: batches of 16 or more
over FLAT or SQ storage with ef ≤ 512 take the batched device beam
(seeded by one product over the layer-1 nodes); the rest, and every PQ
index, take the host walks. A failure on the device raises: nothing
falls back to the host.

Not ported: the reference's ``lax.scan`` over chunks becomes a Python
loop over chunks, and its query-count buckets (B padding) and the
padding of the graph's rows to whole scan blocks are XLA's static shapes,
with no use here. The beam width ``E`` is part of the result and keeps
the reference's buckets. ``approx_max_k`` of the coarse pass is exact
here (it is approximate only on the TPU), which can only raise recall.
"""

from __future__ import annotations

import heapq
import json
import time
from collections import Counter

import numpy as np
import torch

from ..arrow import refuse_multivector
from ..errors import InvalidInputError
from ..ops.distance import normalize_metric
from ..ops.pq import adc_lut, default_num_sub_vectors, pq_encode, pq_train
from ..ops.util import resolve_device
from ..storage.manifest import IndexMeta, new_uuid
from .vector import (
    PAD_PENALTY,
    SearchParams,
    _collect_vectors,
    _load_npy,
    _save_npy,
    _to_device,
    refine_candidates,
)

DEFAULT_M = 20  # reference index/vector.rs:402
DEFAULT_EF_CONSTRUCTION = 300  # reference index/vector.rs:415
DEFAULT_EF_SEARCH = 64

# on-disk graph layout: dense padded adjacency level{lv}_adj.npy (local
# ids, -1 pads) and, for the upper layers, level{lv}_nodes.npy
GRAPH_FORMAT = "dense_v2"

HNSW_INDEX_TYPES = ("IVF_HNSW_FLAT", "IVF_HNSW_SQ", "IVF_HNSW_PQ")
_KIND = {"IVF_HNSW_FLAT": "FLAT", "IVF_HNSW_SQ": "SQ", "IVF_HNSW_PQ": "PQ"}

_KNN_QUERY_CHUNK = 1024  # kNN rows per product: (1024, N) f32 distances
_KNN_EXACT_ROWS = 8192  # at most this many rows: one exact f32 pass
_PRUNE_CHUNK = 4096  # rows per prune step: (chunk, kc, kc) pairwise distances
_BEAM_QUERY_CHUNK = 256  # queries per beam call (the reference's largest B)
_INVALID_ROWID = np.uint64(np.iinfo(np.uint64).max)

# device work of the graph on the card, by stage; chip_smoke.py reads it
# to show that the beam ran there
device_runs: Counter = Counter()


def _count(stage: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        device_runs[stage] += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage(timings, name: str, t0: float, device: torch.device) -> float:
    """Add the wall clock since ``t0`` (the device's work included) to
    ``timings[name]``; meta.json carries the stages as ``build_timings``."""
    _sync(device)
    now = time.time()
    if timings is not None:
        timings[name] = timings.get(name, 0.0) + (now - t0)
    return now


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and come back to f32: the reference's coarse
    products take bf16 inputs with f32 accumulation on every backend."""
    return t.to(torch.bfloat16).float()


def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last axis in ``lax.top_k``'s order: value,
    then lower index first. A stable sort of the whole row, for the short
    rows of the beam and the rescore."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _smallest_wide(d: torch.Tensor, k: int, margin: int = 8) -> torch.Tensor:
    """Indices of the k smallest of a wide row in ``_smallest``'s order:
    ``torch.topk`` of k + margin, then a stable sort of those by value
    after index, so ties come out lower index first (exact unless more
    than ``margin`` values tie at the cut)."""
    kk = min(k + margin, d.shape[-1])
    vals, idx = torch.topk(d, kk, dim=-1, largest=False, sorted=False)
    by_idx = torch.argsort(idx, dim=-1)
    vals, idx = torch.gather(vals, -1, by_idx), torch.gather(idx, -1, by_idx)
    order = torch.argsort(vals, dim=-1, stable=True)[..., :k]
    return torch.gather(idx, -1, order)


# ------------------------------------------------------------------ build


class _DeviceBase:
    """One layer's vectors on the device: f32 rows, their bf16 rounding
    for the coarse product, and their squared norms."""

    def __init__(self, vectors: np.ndarray, device: torch.device):
        self.n = vectors.shape[0]
        self.device = device
        self.xb = _to_device(vectors.astype(np.float32, copy=False), device)
        self.xb_bf = _bf16(self.xb)
        self.norms2 = torch.sum(torch.square(self.xb), dim=1)


def _knn_all_device(base: _DeviceBase, k: int, metric: str) -> torch.Tensor:
    """Self-excluded kNN ids (n, k) int64 on the device, 1024 query rows
    per product. Above 8192 rows: a bf16 coarse scan keeps the ``kc2``
    nearest, and an exact f32 rescore of those orders the final k; at
    8192 rows or fewer one exact f32 pass."""
    n = base.n
    k = min(k, n - 1)
    exact = n <= _KNN_EXACT_ROWS
    kc2 = min(max(2 * (k + 1), 192), n)
    xb, norms2, dev = base.xb, base.norms2, base.device
    out = torch.empty((n, k), dtype=torch.long, device=dev)
    _count("knn", xb)
    for start in range(0, n, _KNN_QUERY_CHUNK):
        q_ids = torch.arange(start, min(start + _KNN_QUERY_CHUNK, n), device=dev)
        q = xb[q_ids]
        if exact:
            dots = q @ xb.T
            d = -dots if metric == "dot" else (
                torch.sum(torch.square(q), 1, keepdim=True) - 2.0 * dots + norms2[None, :]
            )
            d[torch.arange(len(q_ids), device=dev), q_ids] = float("inf")
            out[q_ids] = _smallest(d, k)[1]
            continue
        dots = _bf16(q) @ base.xb_bf.T
        d = -dots if metric == "dot" else (
            torch.sum(torch.square(q), 1, keepdim=True) - 2.0 * dots + norms2[None, :]
        )
        cand = _smallest_wide(d, kc2)  # (c, kc2), nearest first
        del d, dots
        xc = xb[cand]  # (c, kc2, D)
        if metric == "dot":
            d2 = -torch.einsum("qd,qcd->qc", q, xc)
        else:
            d2 = torch.sum(torch.square(q[:, None, :] - xc), dim=-1)
        d2 = torch.where(cand == q_ids[:, None], float("inf"), d2)  # self
        out[q_ids] = torch.gather(cand, 1, _smallest(d2, k)[1])
    return out


def _prune_all_device(base: _DeviceBase, cand: torch.Tensor, deg: int) -> torch.Tensor:
    """Occlusion (RNG) pruning of candidate edges (n, kc) → (n, deg).

    Walk each node's candidates in distance order and keep one only if it
    is closer to the node than to every neighbour already kept, so edges
    span directions instead of crowding one cluster; pruned slots backfill
    with the nearest unkept candidates. Duplicate pool entries occlude
    themselves (d_cc = 0 against the kept copy); -1 entries are padding.
    The walk is a sequential loop over the kc candidates, over 4096 rows
    at a time. The sorts are stable, as ``jnp.argsort`` is: 2-hop pools
    hold duplicates at equal distance."""
    n_rows, kc = cand.shape
    if kc <= deg:
        return cand[:, :deg]
    xb, dev = base.xb, base.device
    out = torch.empty((n_rows, deg), dtype=cand.dtype, device=dev)
    _count("prune", xb)
    for start in range(0, n_rows, _PRUNE_CHUNK):
        node_ids = torch.arange(start, min(start + _PRUNE_CHUNK, n_rows), device=dev)
        c = len(node_ids)
        cand_ids = cand[node_ids]
        u = xb[node_ids]
        pad = cand_ids < 0
        cv = xb[torch.clamp(cand_ids, min=0)]  # (c, kc, D)
        d_uc = torch.sum(torch.square(u[:, None, :] - cv), dim=-1)
        d_uc = torch.where(pad, float("inf"), d_uc)
        sort = torch.argsort(d_uc, dim=1, stable=True)
        cand_s = torch.gather(cand_ids, 1, sort)
        cv = torch.gather(cv, 1, sort[:, :, None].expand(-1, -1, cv.shape[2]))
        d_uc = torch.gather(d_uc, 1, sort)
        cn2 = torch.sum(torch.square(cv), dim=-1)  # (c, kc)
        # (kc, c, kc): step j reads one contiguous (c, kc) slab
        dots_t = torch.einsum("cid,cjd->icj", cv, cv)
        d_cc_t = torch.clamp(cn2.T[:, :, None] - 2.0 * dots_t + cn2[None, :, :], min=0.0)
        del dots_t, cv
        occl = torch.full((c, kc), float("inf"), device=dev)
        keep = torch.empty((c, kc), dtype=torch.bool, device=dev)
        for j in range(kc):
            ok = d_uc[:, j] <= occl[:, j]
            keep[:, j] = ok
            occl = torch.minimum(occl, torch.where(ok[:, None], d_cc_t[j], float("inf")))
        del d_cc_t
        # kept candidates first (in distance order), then unkept backfill
        key = torch.where(keep, 0, kc) + torch.arange(kc, device=dev)[None, :]
        order = torch.argsort(key, dim=1)[:, :deg]
        sel = torch.gather(cand_s, 1, order)
        # rows with fewer than deg real candidates backfill the nearest
        # neighbour (the adjacency builder dedupes edges)
        out[node_ids] = torch.where(sel < 0, cand_s[:, :1], sel)
    return out


def _hop2_pool_device(cand: torch.Tensor, local: torch.Tensor, n_hop: int = 8) -> torch.Tensor:
    """CAGRA-style 2-hop candidate pool: ``concat(cand,
    local[local[:, :n_hop]])`` with self references masked to -1
    (duplicates stay: the prune occludes them)."""
    n = local.shape[0]
    hop2 = local[local[:, :n_hop]].reshape(n, -1)
    pool = torch.cat([cand, hop2.to(cand.dtype)], dim=1)
    rows = torch.arange(n, device=pool.device, dtype=pool.dtype)[:, None]
    return torch.where(pool == rows, -1, pool)


def _dense_adjacency_device(local: torch.Tensor, n_rows: int, cap_rev: int) -> torch.Tensor:
    """Dense padded adjacency (n_rows, deg + cap_rev) int32 (-1 pads): the
    forward edges and up to ``cap_rev`` reverse edges per row, deduped.

    The reverse edges come one forward column at a time: each source
    writes its id into its target's next free slot. Sources of one column
    that share a target read the same fill count and write the same
    cell; the reference's XLA scatter applies them in order, so the
    largest source id stays. ``scatter_reduce(amax)`` over a flattened
    index keeps that same id on every device (a plain ``index_put_`` with
    duplicate indices is undefined on CUDA), and later slots of that
    target stay holes, as in the reference."""
    dev = local.device
    n, deg = local.shape
    sink = n_rows  # row and fill counter that take the dropped writes
    src_rows = torch.arange(n, device=dev)
    valid_src = src_rows < n_rows
    rev = torch.full(((n_rows + 1) * cap_rev,), -1, dtype=torch.long, device=dev)
    fill = torch.zeros(n_rows + 1, dtype=torch.long, device=dev)
    for col in range(deg):
        dst = local[:, col].long()
        ok = valid_src & (dst >= 0) & (dst < n_rows)
        d = torch.where(ok, dst, sink)
        slot = fill[d]
        d_write = torch.where(slot < cap_rev, d, sink)
        flat = d_write * cap_rev + torch.clamp(slot, max=cap_rev - 1)
        rev.scatter_reduce_(0, flat, src_rows, reduce="amax")
        fill.index_add_(0, d, torch.ones_like(d))
    rev = rev.reshape(n_rows + 1, cap_rev)[:n_rows]
    adj = torch.cat([local[:n_rows].long(), rev], dim=1)
    # mask self edges and pads, then dedupe per row: sort with pads past
    # the end, mark adjacent equals, sort again so real ids lead
    rows = torch.arange(n_rows, device=dev)[:, None]
    adj = torch.where((adj == rows) | (adj < 0), n_rows, adj)
    s = torch.sort(adj, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.sort(torch.where(dup, n_rows, s), dim=1).values
    return torch.where(s >= n_rows, -1, s).to(torch.int32)


def _build_layers(vectors: np.ndarray, m: int, metric: str, seed: int = 0,
                  timings: dict | None = None, device=None):
    """All HNSW layers from per-layer kNN graphs.

    Levels are the standard geometric draw (ml = 1/ln m, numpy seeded as
    the reference's); each layer's edges are its nodes' kNN, pruned for
    diversity, widened by a 2-hop pool and pruned again, then completed
    with reverse edges. Returns ([(global node ids or None for layer 0,
    adjacency (n_lv, deg_tot) int32)], entry, levels)."""
    device = resolve_device(device)
    n = len(vectors)
    m0 = 2 * m
    rng = np.random.default_rng(seed)
    ml = 1.0 / np.log(m)
    levels = (-np.log(rng.uniform(1e-12, 1.0, size=n)) * ml).astype(np.int64)
    entry = int(np.argmax(levels))
    layers = []
    for lv in range(int(levels[entry]) + 1):
        nodes = np.flatnonzero(levels >= lv)
        deg = m0 if lv == 0 else m
        if len(nodes) < 2:
            layers.append((nodes.astype(np.int32), np.zeros((len(nodes), 1), np.int32) - 1))
            continue
        tag = "l0" if lv == 0 else "upper"
        # 2x candidates, then occlusion-prune to deg for edge diversity
        kc = min(2 * deg, len(nodes) - 1)
        t0 = time.time()
        base = _DeviceBase(vectors if lv == 0 else np.ascontiguousarray(vectors[nodes]), device)
        cand = _knn_all_device(base, kc, metric)
        t0 = _stage(timings, f"knn_{tag}", t0, device)
        local = _prune_all_device(base, cand, min(deg, kc))
        t0 = _stage(timings, f"prune_{tag}", t0, device)
        if len(nodes) > 4 * deg:
            # neighbours of neighbours widen the cluster-local kNN pools
            # before the diversity prune picks direction-spanning edges
            pool = _hop2_pool_device(cand, local, n_hop=min(8, local.shape[1]))
            t0 = _stage(timings, f"hop2_pool_{tag}", t0, device)
            local = _prune_all_device(base, pool, min(deg, kc))
            t0 = _stage(timings, f"prune2_{tag}", t0, device)
            del pool
        del cand, base
        adj = _dense_adjacency_device(local, len(nodes), cap_rev=deg).cpu().numpy()
        del local
        layers.append((None if lv == 0 else nodes.astype(np.int32), adj))
        _stage(timings, f"adjacency_{tag}", t0, device)
    return layers, entry, levels


class _Storage:
    """The vectors the graph walk reads: FLAT (f32 rows), SQ (int8 affine
    codes) or PQ (codes and a per-query ADC table)."""

    def __init__(self, kind: str, metric: str):
        self.kind = kind
        self.metric = metric

    @staticmethod
    def build(kind: str, vectors: np.ndarray, metric: str, config, device) -> "_Storage":
        s = _Storage(kind, metric)
        if metric == "cosine":
            vectors = vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-30)
        if kind == "FLAT":
            s.vectors = vectors.astype(np.float32)
        elif kind == "SQ":
            lo, hi = vectors.min(0), vectors.max(0)
            s.scale = np.maximum((hi - lo) / 255.0, 1e-12).astype(np.float32)
            s.offset = lo.astype(np.float32)
            s.codes = np.clip(np.round((vectors - lo) / s.scale), 0, 255).astype(np.uint8)
        elif kind == "PQ":
            nsub = getattr(config, "num_sub_vectors", None) or default_num_sub_vectors(
                vectors.shape[1]
            )
            s.codebooks = pq_train(vectors, nsub, seed=getattr(config, "seed", 0), device=device)
            s.codes = pq_encode(vectors, s.codebooks, device=device)
        else:
            raise InvalidInputError(f"unknown HNSW storage {kind!r}")
        return s

    def num_rows(self) -> int:
        return len(self.vectors) if self.kind == "FLAT" else len(self.codes)

    def query_fn(self, q: np.ndarray):
        """dist_fn(node ids) → distances for one query, on the host (the
        PQ table is made with torch on the CPU)."""
        metric = self.metric
        if metric == "cosine":
            q = q / max(np.linalg.norm(q), 1e-30)
        if self.kind in ("FLAT", "SQ"):
            if self.kind == "FLAT":
                vecs = self.vectors

                def rows(idx):
                    return vecs[idx]
            else:
                codes, scale, offset = self.codes, self.scale, self.offset

                def rows(idx):
                    return codes[idx].astype(np.float32) * scale + offset

            def fn(idx):
                sub = rows(idx)
                if metric == "dot":
                    return -(sub @ q)
                d = sub - q[None, :]
                out = np.einsum("nd,nd->n", d, d)
                return out / 2.0 if metric == "cosine" else out

            return fn
        luts = adc_lut(torch.from_numpy(np.ascontiguousarray(q[None, :], dtype=np.float32)),
                       torch.tensor(self.codebooks)).numpy()[0]
        codes = self.codes
        cols = np.arange(codes.shape[1])

        def fn(idx):
            out = luts[cols[None, :], codes[idx]].sum(axis=1)
            if metric == "dot":
                # l2-trained codes: dot ranks by the l2 table, as in the reference
                return out
            return out / 2.0 if metric == "cosine" else out

        return fn

    def save(self, store, prefix: str):
        if self.kind == "FLAT":
            _save_npy(store, f"{prefix}/vectors.npy", self.vectors)
        elif self.kind == "SQ":
            _save_npy(store, f"{prefix}/codes.npy", self.codes)
            _save_npy(store, f"{prefix}/sq_scale.npy", self.scale)
            _save_npy(store, f"{prefix}/sq_offset.npy", self.offset)
        else:
            _save_npy(store, f"{prefix}/codes.npy", self.codes)
            _save_npy(store, f"{prefix}/codebooks.npy", self.codebooks)

    @staticmethod
    def load(store, prefix: str, kind: str, metric: str) -> "_Storage":
        s = _Storage(kind, metric)
        if kind == "FLAT":
            s.vectors = np.asarray(_load_npy(store, f"{prefix}/vectors.npy"))
        elif kind == "SQ":
            s.codes = np.asarray(_load_npy(store, f"{prefix}/codes.npy"))
            s.scale = np.asarray(_load_npy(store, f"{prefix}/sq_scale.npy"))
            s.offset = np.asarray(_load_npy(store, f"{prefix}/sq_offset.npy"))
        else:
            s.codes = np.asarray(_load_npy(store, f"{prefix}/codes.npy"))
            s.codebooks = np.asarray(_load_npy(store, f"{prefix}/codebooks.npy"))
        return s


def build_hnsw_index(dataset, column: str, config, name: str | None = None,
                     device=None) -> IndexMeta:
    """Build the graph and its storage on ``device`` and persist them in
    the reference's ``dense_v2`` files.

    The edges come from per-layer kNN graphs (``_build_layers``), the
    batched form of the reference's incremental build. ef_construction is
    kept for the API and the metadata; it does not bound this build."""
    device = resolve_device(device)
    t0 = time.time()
    refuse_multivector(dataset.schema, column)
    metric = normalize_metric(config.distance_type)
    kind = _KIND[config.index_type]
    vectors, row_ids, frag_ids = _collect_vectors(dataset, column)
    storage = _Storage.build(kind, vectors, metric, config, device)
    n = storage.num_rows()
    # the graph is built over what the walk reads, so quantization error
    # shapes the edges as it shapes the walk
    if kind == "FLAT":
        graph_vecs = storage.vectors
    elif kind == "SQ":
        graph_vecs = storage.codes.astype(np.float32) * storage.scale + storage.offset
    else:
        graph_vecs = vectors.astype(np.float32)
    if metric == "cosine" and kind != "FLAT":
        graph_vecs = graph_vecs / np.maximum(
            np.linalg.norm(graph_vecs, axis=1, keepdims=True), 1e-30
        )
    timings: dict = {}
    layers, entry, _ = _build_layers(graph_vecs, config.m, metric,
                                     seed=getattr(config, "seed", 0), timings=timings,
                                     device=device)
    uuid = new_uuid()
    store = dataset.store
    prefix = dataset.index_dir(uuid)
    storage.save(store, prefix)
    _save_npy(store, f"{prefix}/row_ids.npy", row_ids.view(np.int64))
    for lv, (nodes, adj) in enumerate(layers):
        _save_npy(store, f"{prefix}/level{lv}_adj.npy", adj)
        if nodes is not None:
            _save_npy(store, f"{prefix}/level{lv}_nodes.npy", nodes)
    meta_doc = {
        "index_type": config.index_type,
        "column": column,
        "graph_format": GRAPH_FORMAT,
        "metric": metric,
        "dim": vectors.shape[1],
        "num_rows": n,
        "m": config.m,
        "ef_construction": config.ef_construction,
        "num_levels": len(layers),
        "entry": int(entry),
        "build_seconds": time.time() - t0,
        "build_timings": timings,
    }
    store.write_bytes(f"{prefix}/meta.json", json.dumps(meta_doc).encode())
    return IndexMeta(
        name=name or f"{column}_idx",
        uuid=uuid,
        columns=[column],
        index_type=config.index_type,
        params=meta_doc,
        fragment_ids=frag_ids,
        num_indexed_rows=n,
        created_at=time.time(),
    )


# ---------------------------------------------------------------- serving


def _hnsw_seed_device(q, up_bf, up_norms2, up_nodes, s: int, metric: str) -> torch.Tensor:
    """Batched entry points: the exact top-``s`` of the upper-layer node
    set by one product, in place of each query's greedy descent."""
    dots = _bf16(q) @ up_bf.T
    d = -dots if metric == "dot" else up_norms2[None, :] - 2.0 * dots
    d = torch.where(up_nodes[None, :] >= 0, d, float("inf"))
    return up_nodes[_smallest(d, s)[1]]


def _hnsw_beam_device(q, seed_ids, adj, vA, vB, vC, norms2, penalty,
                      *, k: int, e_expand: int, iters: int, metric: str,
                      has_mask: bool, kind: str):
    """CAGRA-style batched best-first beam over the layer-0 graph, on the
    device of ``q``.

    Each query keeps a beam of E (id, coarse distance, expanded) entries.
    Each of the ``iters`` steps expands the ``e_expand`` best unexpanded
    entries: their adjacency rows are gathered, every neighbour scored in
    one bf16 gather and product, deduped against the beam and within the
    step, and the best E kept. A final f32 rescore of the best min(4k, E)
    entries gives exact distances. Selections follow ``lax.top_k``'s
    order (value, then lower position), so the beam walks the reference's
    path.

    kind 'FLAT': vA = f32 rows, vB = bf16 rows; kind 'SQ': vA = uint8
    codes, vB = scale (D,), vC = offset (D,)."""
    _count("beam", q)
    b, e_width = seed_ids.shape
    dev = q.device
    qf = q.float()
    qb = _bf16(qf)

    def rows_f32(ids):
        if kind == "FLAT":
            return vA[ids]
        return vA[ids].float() * vB + vC

    def rows_bf(ids):
        return vB[ids].float() if kind == "FLAT" else _bf16(rows_f32(ids))

    def coarse(ids, valid):
        safe = torch.clamp(ids, min=0)
        dots = torch.einsum("bd,bcd->bc", qb, rows_bf(safe))
        d = -dots if metric == "dot" else norms2[safe] - 2.0 * dots
        if has_mask:
            d = d + penalty[safe]
        return torch.where(valid, d, float("inf"))

    ids = seed_ids.long()
    dist = coarse(ids, ids >= 0)
    exp = ids < 0  # pads count as expanded: never selected
    rows_b = torch.arange(b, device=dev)[:, None]
    for _ in range(iters):
        score = torch.where(exp, float("inf"), dist)
        sel = _smallest(score, e_expand)[1]  # (B, e)
        sel_ids = torch.gather(ids, 1, sel)
        exp = exp.scatter(1, sel, True)
        nbr = adj[torch.clamp(sel_ids, min=0)].long()  # (B, e, deg)
        nbr = torch.where(sel_ids[:, :, None] < 0, -1, nbr).reshape(b, -1)
        dup = (nbr[:, :, None] == ids[:, None, :]).any(-1)
        valid = (nbr >= 0) & ~dup
        # dedupe within the step (two expanded nodes often share
        # neighbours): the first copy in position order stays
        order = torch.argsort(nbr, dim=1, stable=True)
        srt = torch.gather(nbr, 1, order)
        adj_dup = torch.zeros_like(srt, dtype=torch.bool)
        adj_dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        dup2 = torch.zeros_like(adj_dup).scatter(1, order, adj_dup)
        nd = coarse(nbr, valid & ~dup2)
        all_ids = torch.cat([ids, nbr], dim=1)
        all_d = torch.cat([dist, nd], dim=1)
        all_e = torch.cat([exp, torch.zeros_like(nbr, dtype=torch.bool)], dim=1)
        pos = _smallest(all_d, e_width)[1]
        ids = all_ids[rows_b, pos]
        dist = all_d[rows_b, pos]
        exp = all_e[rows_b, pos]
    # exact f32 rescore of the best beam entries
    pos = _smallest(dist, min(4 * k, e_width))[1]
    rids = torch.gather(ids, 1, pos)
    vr = rows_f32(torch.clamp(rids, min=0))
    if metric == "dot":
        dr = -torch.einsum("bd,bcd->bc", qf, vr)
    else:
        dr = torch.sum(torch.square(qf[:, None, :] - vr), dim=-1)
        if metric == "cosine":
            dr = dr / 2.0
    if has_mask:
        dr = dr + penalty[torch.clamp(rids, min=0)]
    dr = torch.where(rids >= 0, dr, float("inf"))
    vals, p2 = _smallest(dr, k)
    return vals, torch.gather(rids, 1, p2)


class HnswSearcher:
    """A loaded HNSW index serving queries with VectorSearcher's contract."""

    _DEVICE_BATCH_MIN = 16  # below this the host walk's latency wins
    _DEVICE_EF_MAX = 512  # widest beam bucket; beyond it the host walk
    _SEED_BRUTE_NODES = 4096  # deepest layer worth brute-forcing per query

    def __init__(self, store, prefix: str, meta: IndexMeta | None = None, device=None):
        self.meta = meta
        self.device = resolve_device(device)
        self.params = json.loads(store.read_bytes(f"{prefix}/meta.json"))
        self.metric = self.params["metric"]
        self.index_type = self.params["index_type"]
        self.dim = self.params["dim"]
        fmt = self.params.get("graph_format")
        if fmt is not None and fmt != GRAPH_FORMAT:
            raise InvalidInputError(
                f"HNSW index at {prefix!r} uses graph format {fmt!r}; this build reads "
                f"{GRAPH_FORMAT!r} — rebuild the index (create_index with replace=True)"
            )
        self.storage = _Storage.load(store, prefix, _KIND[self.index_type], self.metric)
        self.row_ids_flat = np.asarray(_load_npy(store, f"{prefix}/row_ids.npy")).view(np.uint64)
        self.num_slots = len(self.row_ids_flat)
        self.entry = self.params["entry"]
        self.levels = []  # [(global node ids or None, adjacency (n_lv, deg_tot))]
        for lv in range(self.params["num_levels"]):
            adj = np.asarray(_load_npy(store, f"{prefix}/level{lv}_adj.npy"))
            nodes = None
            if store.exists(f"{prefix}/level{lv}_nodes.npy"):
                nodes = np.asarray(_load_npy(store, f"{prefix}/level{lv}_nodes.npy"))
            self.levels.append((nodes, adj))
        self._device: dict[str, torch.Tensor] = {}  # the beam's arrays, on first use

    def _adj(self, level: int, node: int) -> np.ndarray:
        """Neighbours of a GLOBAL node id at ``level`` (global ids)."""
        nodes, adj = self.levels[level]
        if nodes is None:
            row = adj[node]
            return row[row >= 0]
        local = int(np.searchsorted(nodes, node))
        if local >= len(nodes) or nodes[local] != node:
            return np.empty(0, dtype=np.int32)
        row = adj[local]
        return nodes[row[row >= 0]]

    def slot_penalty(self, allowed_row_ids, deleted_row_ids, vanished_fragments=None):
        """The per-node additive penalty for prefilter and deletions (host)."""
        no_deleted = deleted_row_ids is None or not len(deleted_row_ids)
        if allowed_row_ids is None and no_deleted and not vanished_fragments:
            return None
        penalty = np.zeros(self.num_slots, dtype=np.float32)
        rid = self.row_ids_flat
        if allowed_row_ids is not None:
            penalty[~np.isin(rid, allowed_row_ids)] = PAD_PENALTY
        if not no_deleted:
            penalty[np.isin(rid, deleted_row_ids)] = PAD_PENALTY
        if vanished_fragments:
            frag_of = (rid >> np.uint64(32)).astype(np.int64)
            penalty[np.isin(frag_of, np.fromiter(vanished_fragments, dtype=np.int64))] = PAD_PENALTY
        return penalty

    # HNSW keeps the host refine, as in the reference: no fused table
    def prepare_device_refine(self, dataset, column: str, precision: str | None = None) -> bool:
        return False

    def will_fuse_refine(self, params: SearchParams) -> bool:
        return False

    def refine(self, dataset, column, queries, dists, row_ids, k):
        """Exact host rerank of candidates (late materialization)."""
        return refine_candidates(dataset, column, queries, row_ids, k, self.metric, self.device)

    # ---- batched device serving (CAGRA-style beam over layer 0) --------
    def _prepare_device(self) -> dict:
        """Upload the rows (or codes), the layer-0 adjacency and the seed
        matrix over the layer-1 nodes once; cached on the searcher."""
        if self._device:
            return self._device
        st, dev = self.storage, self.device
        if st.kind not in ("FLAT", "SQ"):
            raise InvalidInputError("device beam search supports FLAT/SQ storage")
        out: dict[str, torch.Tensor] = {}
        if st.kind == "FLAT":
            recon = st.vectors
            out["vA"] = _to_device(recon, dev)
            out["vB"] = out["vA"].to(torch.bfloat16)
            out["vC"] = out["vB"][:1]  # unused by FLAT
        else:
            recon = st.codes.astype(np.float32) * st.scale + st.offset
            out["vA"] = _to_device(st.codes, dev)
            out["vB"] = _to_device(st.scale, dev)
            out["vC"] = _to_device(st.offset, dev)
        out["norms2"] = _to_device((recon * recon).sum(axis=1).astype(np.float32), dev)
        out["adj"] = _to_device(self.levels[0][1], dev)
        # seed matrix: layer 1's nodes, brute-forced in place of greedy
        # descent; a strided sample when the graph has one layer
        if len(self.levels) > 1 and self.levels[1][0] is not None and len(self.levels[1][0]):
            up_nodes = self.levels[1][0].astype(np.int32)
        else:
            up_nodes = np.arange(0, self.num_slots, max(1, self.num_slots // 1024), dtype=np.int32)
        # at least 64 columns, as the reference's padded seed matrix has
        pad_nodes = np.full(max(64, len(up_nodes)), -1, dtype=np.int32)
        pad_nodes[: len(up_nodes)] = up_nodes
        up_vecs = recon[np.maximum(pad_nodes, 0)]
        out["up_nodes"] = _to_device(pad_nodes.astype(np.int64), dev)
        out["up_bf"] = _bf16(_to_device(up_vecs.astype(np.float32), dev))
        out["up_norms2"] = _to_device((up_vecs * up_vecs).sum(axis=1).astype(np.float32), dev)
        self._device = out
        return out

    @staticmethod
    def _bucket(v: int, buckets) -> int:
        for b in buckets:
            if v <= b:
                return b
        return buckets[-1]

    def search_batched(self, q: np.ndarray, params: SearchParams, slot_penalty=None):
        """The batched device beam: ``search``'s results and conventions,
        ef trading recall for speed. The beam width E is ef rounded up to
        the reference's buckets (16 … 512), which is part of the result."""
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        k = params.k
        ef = max(params.ef or DEFAULT_EF_SEARCH, k)
        blocked = slot_penalty is not None and slot_penalty.max() > 0
        if blocked:
            ef = max(ef, 3 * k)
        if ef > self._DEVICE_EF_MAX:
            return self._search_host(q, params, slot_penalty)
        dev = self._prepare_device()
        e_width = self._bucket(max(ef, 16), (16, 32, 64, 128, 256, 512))
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        pen = _to_device(slot_penalty.astype(np.float32), self.device) if blocked else None
        s = min(16, e_width)
        # e=8 expansions for E/8 steps (at least 6 for far basins): the
        # reference's tuning at 500k
        e_expand, iters = 8, max(e_width // 8, 6)
        d_out, i_out = [], []
        for i in range(0, len(q), _BEAM_QUERY_CHUNK):
            qd = _to_device(q[i : i + _BEAM_QUERY_CHUNK], self.device)
            seeds = _hnsw_seed_device(qd, dev["up_bf"], dev["up_norms2"], dev["up_nodes"], s,
                                      self.metric)
            if e_width > s:
                seeds = torch.cat([seeds, torch.full((len(qd), e_width - s), -1,
                                                     dtype=seeds.dtype, device=seeds.device)], 1)
            d, ids = _hnsw_beam_device(
                qd, seeds[:, :e_width], dev["adj"], dev["vA"], dev["vB"], dev["vC"],
                dev["norms2"], pen, k=k, e_expand=e_expand, iters=iters, metric=self.metric,
                has_mask=blocked, kind=self.storage.kind,
            )
            d_out.append(d.cpu().numpy())
            i_out.append(ids.cpu().numpy())
        d, ids = np.concatenate(d_out), np.concatenate(i_out)
        out_r = np.where((ids >= 0) & (d < PAD_PENALTY / 2),
                         self.row_ids_flat[np.maximum(ids, 0)], _INVALID_ROWID)
        d = np.where(out_r == _INVALID_ROWID, np.inf, d)
        return d.astype(np.float32), out_r.astype(np.uint64)

    def search(self, queries: np.ndarray, params: SearchParams, slot_penalty=None):
        """Returns (distances (Q, k) f32, row ids (Q, k) uint64), +inf and
        2^64-1 past the hits. Batches of 16 or more over FLAT or SQ
        storage with ef ≤ 512 take the device beam, the rest the host
        walk; a failure on the device raises."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if q.shape[1] != self.dim:
            raise InvalidInputError(f"query dim {q.shape[1]} != index dim {self.dim}")
        ef = max(params.ef or DEFAULT_EF_SEARCH, params.k)
        if (
            len(q) >= self._DEVICE_BATCH_MIN
            and self.storage.kind in ("FLAT", "SQ")
            and ef <= self._DEVICE_EF_MAX
        ):
            return self.search_batched(q, params, slot_penalty)
        return self._search_host(q, params, slot_penalty)

    # ---- host walks (the reference's numpy, copied) ---------------------
    def _search_host(self, q: np.ndarray, params: SearchParams, slot_penalty=None):
        """One host graph walk per query (the low-latency path)."""
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        k = params.k
        ef = max(params.ef or DEFAULT_EF_SEARCH, k)
        out_d = np.full((len(q), k), np.inf, dtype=np.float32)
        out_r = np.full((len(q), k), _INVALID_ROWID, dtype=np.uint64)
        blocked = slot_penalty is not None and slot_penalty.max() > 0
        for qi in range(len(q)):
            dist_fn = self.storage.query_fn(q[qi])
            seeds = self._seed_layer0(dist_fn)
            res = self._search_layer(dist_fn, seeds or [self.entry],
                                     max(ef, k * 3 if blocked else ef), slot_penalty, level=0)
            for j, (d, node) in enumerate(res[:k]):
                out_d[qi, j] = d
                out_r[qi, j] = self.row_ids_flat[node]
        return out_d, out_r

    def _seed_layer0(self, dist_fn) -> list[int]:
        """Layer-0 entry points for one query: brute-force the deepest
        layer of at most 4096 nodes, then beam down the layers between
        with ef 8, so several basins reach layer 0."""
        if len(self.levels) <= 1:
            return [self.entry]
        brute_lv = None
        for lv in range(1, len(self.levels)):
            nodes = self.levels[lv][0]
            if nodes is not None and 0 < len(nodes) <= self._SEED_BRUTE_NODES:
                brute_lv = lv
                break
        if brute_lv is None:
            ep = self.entry
            for lv in range(len(self.levels) - 1, 1, -1):
                ep = self._greedy(dist_fn, ep, lv)
            return [n for _, n in self._search_layer(dist_fn, [ep], 8, None, level=1)]
        nodes = self.levels[brute_lv][0]
        d = dist_fn(nodes)
        top = np.argpartition(d, min(8, len(d) - 1))[:8] if len(d) > 8 else range(len(d))
        seeds = [int(nodes[t]) for t in top]
        for lv in range(brute_lv - 1, 0, -1):
            seeds = [n for _, n in self._search_layer(dist_fn, seeds, 8, None, level=lv)]
        return seeds

    def _greedy(self, dist_fn, ep: int, level: int) -> int:
        cur = ep
        cur_d = dist_fn(np.array([cur]))[0]
        improved = True
        while improved:
            improved = False
            neigh = self._adj(level, cur)
            if len(neigh) == 0:
                break
            dists = dist_fn(neigh)
            j = int(np.argmin(dists))
            if dists[j] < cur_d:
                cur, cur_d = int(neigh[j]), dists[j]
                improved = True
        return cur

    def _search_layer(self, dist_fn, eps: list[int], ef: int, penalty, level: int = 0):
        """Beam search over one layer from one or more entry points."""
        eps = list(dict.fromkeys(int(e) for e in eps))
        d0s = dist_fn(np.asarray(eps))
        visited = set(eps)
        candidates = [(float(d), e) for d, e in zip(d0s, eps)]
        heapq.heapify(candidates)
        results = [(-self._pen(float(d), e, penalty), e) for d, e in zip(d0s, eps)]
        heapq.heapify(results)
        while len(results) > ef:
            heapq.heappop(results)
        while candidates:
            d, node = heapq.heappop(candidates)
            if d > -results[0][0] and len(results) >= ef:
                break
            neigh = [n for n in self._adj(level, node) if n not in visited]
            if not neigh:
                continue
            visited.update(neigh)
            dists = dist_fn(np.asarray(neigh))
            for nd, nn in zip(dists, neigh):
                pd = self._pen(nd, nn, penalty)
                if len(results) < ef or pd < -results[0][0]:
                    heapq.heappush(candidates, (nd, int(nn)))
                    heapq.heappush(results, (-pd, int(nn)))
                    if len(results) > ef:
                        heapq.heappop(results)
        out = sorted((-nd, nn) for nd, nn in results)
        return [(d, n) for d, n in out if d < PAD_PENALTY / 2]

    @staticmethod
    def _pen(d, node, penalty):
        return d if penalty is None else d + penalty[node]
