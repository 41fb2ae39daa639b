"""Vector index build + search: FLAT, IVF_FLAT and IVF_PQ, and brute force
for unindexed rows.

Port of those parts of the reference's index/vector.py. The on-disk
layout is the reference's, byte for byte, so either package reads what
the other wrote:

* FLAT keeps ``vectors.npy`` (N, D) f32 (unit rows for cosine) and
  ``row_ids.npy`` (N,) uint64;
* IVF partitions are padded dense blocks (P, pmax); fat k-means
  partitions are split into duplicate-centroid blocks
  (``_balanced_layout``) and ``num_partitions`` in meta.json counts
  blocks; ``row_ids.npy`` is (P, pmax) int64 with -1 on padding;
* IVF_FLAT keeps ``vectors.npy`` (P, pmax, D) f32, pmax a multiple of 8,
  and its storage precision in meta.json;
* IVF_PQ keeps ``codes.npy`` (P, S_pad, pmax) uint8, S padded to 8 and
  pmax to 128, and ``rnorms.npy`` (P, pmax) f32 holding |c_p + r̃|² with
  +3e38 on padding.

IVF_PQ search is d(q, x̃) = |q|² − 2(q·c_p + q·r̃) + |x̃|²: probe
selection, the per-query dot LUT and the ADC scan of ops/adc.py. IVF_FLAT
search is probe selection and the grouped flat scan of ops/flat_scan.py;
both scans run as CUDA kernels on the card. FLAT search is a plain
product over the whole table. Top-k follows, and for IVF_PQ an optional
fused refine against a device-resident copy of the column. Deletes and
filters enter as a per-slot additive penalty.

Not ported: the reference's static-shape machinery (query buckets,
probe-capacity buckets, the runtime probe mask and ``lax.scan``
chunking) exists for XLA and has no use here: nprobes is a plain int and
the probes are scanned directly. HNSW lives in index/hnsw.py; IVF_SQ and
IVF_RQ wait for a later slice (ROADMAP A7).

IVF_PQ builds take the reference's capacity modes at its thresholds:
bf16 residuals above 2e9 bytes of f32 rows in a bf16 build, and above 8e9
bytes no residual buffer at all (``res_free``). OPQ builds learn a
rotation on a residual sample and encode the rotated residuals.
"""

from __future__ import annotations

import io
import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..arrow import fsl_to_numpy, refuse_multivector
from ..errors import InvalidInputError
from ..io.object_store import ObjectStore
from ..ops import prng
from ..ops.adc import PMAX_ALIGN, S_ALIGN, ivf_pq_adc_scan
from ..ops.distance import normalize_metric, pairwise_distance, refine_distances
from ..ops.flat_scan import ivf_flat_grouped_scan
from ..ops.kmeans import ivf_train_assign_device
from ..ops.pq import default_num_sub_vectors, opq_train, pq_build_device, pq_encode_rnorms
from ..ops.topk import topk_smallest
from ..ops.util import lowp, matmul_dtype, resolve_device, round_up
from ..storage.manifest import IndexMeta, new_uuid
from . import default_num_partitions

logger = logging.getLogger("lancedb_tpu_torch.index")

PAD_PENALTY = np.float32(3.0e38)
_PAD = float(PAD_PENALTY)  # the same f32 value, as a scalar for torch ops
_INVALID_ROWID = np.uint64(np.iinfo(np.uint64).max)

# queries per scan: bounds the (Q, nprobes, pmax) distance transient
_Q_CHUNK = 128

# IVF_PQ build capacity modes, at the reference's thresholds (bytes of the
# f32 table, n·d·4): bf16 residuals in a bf16 build above the first; above
# the second (without OPQ) no residual buffer at all, each encode chunk
# forming its residuals from the raw rows
BF16_RESIDUAL_BYTES = 2_000_000_000
RES_FREE_BYTES = 8_000_000_000

# the types VectorSearcher serves; HNSW lives in index/hnsw.py
PORTED_INDEX_TYPES = ("FLAT", "IVF_FLAT", "IVF_PQ")
_NOT_PORTED = {"IVF_SQ": "A7", "IVF_RQ": "A7"}


def _not_ported(index_type: str) -> Exception:
    """The error for an index type this package cannot build or load:
    a later slice's (NotImplementedError naming its ROADMAP item), or
    none the reference knows either (InvalidInputError, as there)."""
    item = _NOT_PORTED.get(index_type)
    if item is None:
        return InvalidInputError(f"unsupported index_type {index_type!r}")
    return NotImplementedError(
        f"{index_type} indexes are not ported to lancedb_tpu_torch yet (ROADMAP {item})"
    )


@dataclass
class SearchParams:
    """Per-query knobs (reference VectorQueryRequest, query.rs:1067-1114)."""

    k: int = 10
    nprobes: int = 20  # minimum_nprobes default (query.rs:1103)
    refine_factor: int | None = None
    ef: int | None = None  # HNSW search width
    precision: str = "default"  # FLAT scans: 'default' (two-pass) | 'float32' | 'bfloat16'
    # reference ApproxMode (lib.rs:299-307): 'accurate' turns the FLAT
    # two-pass into the exact f32 scan
    approx_mode: str = "normal"
    # planner override: True keeps IVF_FLAT on the probed scan where the
    # planner would take the shared full scan (None = the planner decides)
    use_index_for_batch: bool | None = None


# --------------------------------------------------------------- save/load


def _save_npy(store: ObjectStore, path: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.save(buf, arr)
    store.write_bytes(path, buf.getvalue())


def _load_npy(store: ObjectStore, path: str) -> np.ndarray:
    local = store.local_path(path)
    if local is not None:
        return np.load(local, mmap_mode="r")
    return np.load(io.BytesIO(store.read_bytes(path)))


# ------------------------------------------------------------------ build


def _resolve_nsub(config, dim: int) -> int:
    """num_sub_vectors default + the 4-bit even bump (create_index.rs:94-100)."""
    nsub = config.num_sub_vectors or default_num_sub_vectors(dim)
    if (
        config.num_sub_vectors is None
        and config.num_bits == 4
        and nsub % 2
        and dim % (nsub + 1) == 0
    ):
        nsub += 1
    return nsub


def _collect_vectors(dataset, column: str) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Read (vectors, row_ids, fragment_ids) for all live rows."""
    mats, rids, frag_ids = [], [], []
    for meta, tbl in dataset.scan_fragments(columns=[column], with_row_id=True):
        mats.append(fsl_to_numpy(tbl.column(column)))
        rids.append(tbl.column("_rowid").to_numpy().astype(np.uint64))
        frag_ids.append(meta.id)
    if not mats:
        raise InvalidInputError("cannot build a vector index on an empty table")
    return np.concatenate(mats), np.concatenate(rids), frag_ids


def _balanced_layout(
    assign: np.ndarray, centroids: np.ndarray, pad_multiple: int = 8
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split oversized k-means partitions into duplicate-centroid blocks.

    Padded blocks cost memory and scan time in proportion to the LARGEST
    partition, so rows of a partition with count > cap are split across
    ceil(count/cap) blocks sharing its centroid. Probe selection ranks
    blocks, duplicate centroids rank adjacently, so nprobes is
    block-granular and the searcher rescales it. Empty partitions get no
    block. Returns (order, block_centroids, block_counts, pmax)."""
    num_partitions = centroids.shape[0]
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=num_partitions)
    mean = max(1.0, float(len(assign)) / max(1, (counts > 0).sum()))
    # the reference's knob, read under the same name so both packages
    # lay out the same blocks
    cap_factor = float(os.environ.get("LANCEDB_TPU_BLOCK_CAP_FACTOR", "1.25"))
    cap = int(round_up(max(pad_multiple, int(cap_factor * mean)), pad_multiple))
    block_counts, block_pids = [], []
    for pid in range(num_partitions):
        c = int(counts[pid])
        while c > 0:
            take = min(c, cap)
            block_counts.append(take)
            block_pids.append(pid)
            c -= take
    block_counts = np.asarray(block_counts, dtype=np.int64)
    block_pids = np.asarray(block_pids, dtype=np.int32)
    pmax = int(round_up(max(1, block_counts.max()), pad_multiple))
    logger.debug(
        "ivf layout: %d logical -> %d blocks, pmax=%d (cap=%d)",
        num_partitions, len(block_counts), pmax, cap,
    )
    return order, centroids[block_pids], block_counts, pmax


def _scatter_padded(
    values: np.ndarray, order: np.ndarray, counts: np.ndarray, pmax: int, fill=0
) -> np.ndarray:
    """(N, …) sorted-by-partition → (P, pmax, …) padded."""
    p = len(counts)
    out = np.full((p, pmax) + values.shape[1:], fill, dtype=values.dtype)
    sorted_vals = values[order]
    start = 0
    for pid in range(p):
        c = counts[pid]
        if c:
            out[pid, :c] = sorted_vals[start : start + c]
        start += c
    return out


def _to_device(arr: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """Host → device once, cast to ``dtype`` on the host first (the copy
    moves the narrow bytes, and no wide copy sits on the card); large
    copies to the card go through pinned memory."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a read-only memory map of an index file
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.nbytes >= (1 << 24):
        t = t.pin_memory()
    return t.to(device, non_blocking=device.type == "cuda")


def build_vector_index(
    dataset,
    column: str,
    config,
    name: str | None = None,
    device=None,
) -> IndexMeta:
    """Build and persist one FLAT, IVF_FLAT or IVF_PQ index; returns its
    catalog entry.

    FLAT writes the rows as they are. For the IVF types the table uploads
    to the device once; k-means, assignment (and for IVF_PQ residuals and
    PQ training and encoding) run there, and only the small artifacts
    (assignment, codes, rnorms) come back to be laid out and written."""
    device = resolve_device(device)
    t0 = time.time()
    index_type = config.index_type
    if index_type not in PORTED_INDEX_TYPES:
        raise _not_ported(index_type)
    refuse_multivector(dataset.schema, column)
    metric = normalize_metric(config.distance_type)
    vectors, row_ids, frag_ids = _collect_vectors(dataset, column)
    n, dim = vectors.shape
    uuid = new_uuid()
    store: ObjectStore = dataset.store
    prefix = dataset.index_dir(uuid)
    meta_doc: dict = {
        "index_type": index_type,
        "column": column,
        "metric": metric,
        "dim": dim,
        "num_rows": n,
    }
    if metric == "cosine":
        # normalize once at build: cosine == l2²/2 on the unit sphere
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = vectors / np.maximum(norms, 1e-30)

    if index_type == "FLAT":
        _save_npy(store, f"{prefix}/vectors.npy", vectors)
        _save_npy(store, f"{prefix}/row_ids.npy", row_ids)
    else:
        _build_ivf(store, prefix, meta_doc, config, vectors, row_ids, metric, device)
    meta_doc["build_seconds"] = time.time() - t0
    store.write_bytes(f"{prefix}/meta.json", json.dumps(meta_doc).encode())
    return IndexMeta(
        name=name or f"{column}_idx",
        uuid=uuid,
        columns=[column],
        index_type=index_type,
        params=meta_doc,
        fragment_ids=frag_ids,
        num_indexed_rows=n,
        created_at=time.time(),
    )


def _build_ivf(
    store: ObjectStore, prefix: str, meta_doc: dict, config, vectors: np.ndarray,
    row_ids: np.ndarray, metric: str, device: torch.device,
) -> None:
    """The IVF types' files: k-means on the device, the padded block
    layout, then IVF_FLAT's padded vectors or IVF_PQ's codes."""
    index_type = config.index_type
    n, dim = vectors.shape
    nparts = config.num_partitions or default_num_partitions(n)
    if nparts > n:
        raise InvalidInputError(f"num_partitions {nparts} > num_rows {n}")
    is_pq = index_type == "IVF_PQ"
    if is_pq:
        if config.num_bits not in (4, 8):
            raise InvalidInputError("num_bits must be 4 or 8")
        nsub = _resolve_nsub(config, dim)
        if dim % nsub:
            raise InvalidInputError(f"dim {dim} not divisible by num_sub_vectors {nsub}")
    train_metric = "l2" if metric == "cosine" else metric
    # large-D builds: the (chunk, K) distance transient scales with D
    chunk = 1 << 17 if dim <= 256 else 1 << 15
    build_dtype = (
        torch.float32
        if getattr(config, "build_precision", "bfloat16") == "float32" or device.type == "cpu"
        else torch.bfloat16
    )
    opq = is_pq and getattr(config, "opq", False)
    # the reference's capacity modes, at its thresholds, so both packages
    # compute the same thing at the same sizes
    res_free = is_pq and not opq and n * dim * 4 > RES_FREE_BYTES
    res_dtype = (
        "bfloat16"
        if is_pq and build_dtype == torch.bfloat16 and n * dim * 4 > BF16_RESIDUAL_BYTES
        else "float32"
    )
    if is_pq:
        meta_doc["build_mode"] = "res_free" if res_free else f"residuals_{res_dtype}"
    rng = np.random.default_rng(config.seed)
    n_sample = min(n, config.sample_rate * nparts)
    n_pool = min(n_sample, max(32 * nparts, 4 * nparts))
    sel = (
        rng.choice(n, size=n_sample, replace=False) if n_sample < n else np.arange(n)
    ).astype(np.int32)
    pool_sel = (
        rng.choice(n_sample, size=n_pool, replace=False)
        if n_pool < n_sample else np.arange(n_sample)
    ).astype(np.int32)
    reseed = rng.integers(0, n_sample, size=(config.max_iterations, nparts)).astype(np.int32)

    # the reference pads a res_free table to whole chunks for its lax.map;
    # the chunk loops here take a ragged last chunk, so nothing is padded
    xd = _to_device(vectors.astype(np.float32, copy=False), device, build_dtype)
    cents_d, assign_d, residuals_d = ivf_train_assign_device(
        xd, torch.from_numpy(sel), torch.from_numpy(pool_sel), prng.prng_key(config.seed),
        torch.from_numpy(reseed),
        k=nparts, max_iters=config.max_iterations, metric=train_metric,
        chunk=min(chunk, n), with_residuals=is_pq and not res_free, residual_dtype=res_dtype,
    )
    if not res_free:
        del xd
    centroids = cents_d.cpu().numpy()
    assign = assign_d.cpu().numpy()
    # PQ blocks keep the lane alignment the reference's kernel requires
    order, block_centroids, counts, pmax = _balanced_layout(
        assign, centroids, pad_multiple=PMAX_ALIGN if is_pq else 8
    )
    rid_padded = _scatter_padded(row_ids.view(np.int64), order, counts, pmax, fill=-1)
    _save_npy(store, f"{prefix}/centroids.npy", block_centroids)
    _save_npy(store, f"{prefix}/row_ids.npy", rid_padded)
    _save_npy(store, f"{prefix}/counts.npy", counts.astype(np.int32))
    meta_doc.update(num_partitions=len(counts), num_logical_partitions=nparts, pmax=pmax)
    if not is_pq:
        _save_npy(store, f"{prefix}/vectors.npy", _scatter_padded(vectors, order, counts, pmax))
        meta_doc["precision"] = getattr(config, "precision", "float32")
        return

    if opq:
        # OPQ alternates host Procrustes steps with PQ training on a
        # residual sample, then encodes the rotated residuals (the
        # reference's opt-in slow path, with its draws)
        train_rows = min(n, config.sample_rate * 256)
        sel_pq = np.random.default_rng(config.seed + 1).choice(
            n, size=train_rows, replace=False
        ) if train_rows < n else np.arange(n)
        res_sample = residuals_d[torch.from_numpy(sel_pq).to(device)].float().cpu().numpy()
        rotation, codebooks = opq_train(
            res_sample, nsub, num_bits=config.num_bits,
            opq_iters=getattr(config, "opq_iters", 8), max_iters=config.max_iterations,
            sample_rate=config.sample_rate, seed=config.seed, device=device,
        )
        _save_npy(store, f"{prefix}/rotation.npy", rotation)
        meta_doc["opq"] = True
        codes, rnorms = pq_encode_rnorms(residuals_d, cents_d, assign_d, codebooks,
                                         rotation=rotation)
        del residuals_d
    else:
        kcode = 1 << config.num_bits
        rng_pq = np.random.default_rng(config.seed + 1)
        n_train = min(n, config.sample_rate * kcode)
        sel_pq = (
            rng_pq.choice(n, size=n_train, replace=False) if n_train < n else np.arange(n)
        ).astype(np.int32)
        n_pq_pool = min(n_train, 32 * kcode)
        pq_pool_sel = (
            rng_pq.choice(n_train, size=n_pq_pool, replace=False)
            if n_pq_pool < n_train else np.arange(n_train)
        ).astype(np.int32)
        reseed_pq = rng_pq.integers(0, n_train, size=(config.max_iterations, kcode)).astype(
            np.int32
        )
        codebooks_d, codes_d, rnorms_d = pq_build_device(
            xd if res_free else residuals_d, cents_d, assign_d, torch.from_numpy(sel_pq),
            torch.from_numpy(pq_pool_sel), prng.split(prng.prng_key(config.seed), nsub),
            torch.from_numpy(reseed_pq),
            nsub=nsub, kcode=kcode, max_iters=config.max_iterations, chunk=min(chunk, n),
            from_raw=res_free,
        )
        del residuals_d
        if res_free:
            del xd
        codebooks = codebooks_d.cpu().numpy()
        codes = codes_d.cpu().numpy()
        rnorms = rnorms_d.cpu().numpy()
    # codes live as (P, S_pad, pmax): subvectors, then slots
    codes_psp = _scatter_padded(codes, order, counts, pmax).transpose(0, 2, 1)
    s_pad = round_up(nsub, S_ALIGN)
    if s_pad != nsub:
        codes_psp = np.pad(codes_psp, ((0, 0), (0, s_pad - nsub), (0, 0)))
    _save_npy(store, f"{prefix}/codes.npy", np.ascontiguousarray(codes_psp))
    _save_npy(store, f"{prefix}/codebooks.npy", codebooks)
    _save_npy(
        store, f"{prefix}/rnorms.npy",
        _scatter_padded(rnorms, order, counts, pmax, fill=PAD_PENALTY),
    )
    meta_doc.update(num_sub_vectors=nsub, num_bits=config.num_bits)


# ------------------------------------------------------------------ search


def _select_probes(q: torch.Tensor, centroids: torch.Tensor, nprobes: int, metric: str):
    """(Q, P) centroid distances → top-nprobes block ids + q·c dots.
    The product runs in ``matmul_dtype`` (bf16 on the card)."""
    dots = lowp(q) @ lowp(centroids).T  # (Q, P)
    if metric == "dot":
        d = -dots
    else:
        cn2 = torch.sum(torch.square(centroids), dim=-1)
        qn2 = torch.sum(torch.square(q), dim=-1, keepdim=True)
        d = qn2 - 2.0 * dots + cn2[None, :]
    _, probe_ids = topk_smallest(d, nprobes)
    return probe_ids, torch.gather(dots, 1, probe_ids)


def _pq_dlut(q: torch.Tensor, codebooks: torch.Tensor, s_pad: int) -> torch.Tensor:
    """Per-query dot LUT dlut[q, s, c] = q_s · cb[s, c] → (Q, S_pad, K) f32,
    zero rows for padded subvectors (their code-0 entries add 0)."""
    nsub, kcode, dsub = codebooks.shape
    qs = q.float().reshape(q.shape[0], nsub, dsub)
    dlut = torch.einsum("qsd,skd->qsk", qs, codebooks.float())
    if s_pad != nsub:
        dlut = torch.nn.functional.pad(dlut, (0, 0, 0, s_pad - nsub))
    return dlut.contiguous()


def _ivf_pq_search(
    q: torch.Tensor,
    dev: dict[str, torch.Tensor],
    slot_penalty: torch.Tensor | None,
    nprobes: int,
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-PQ ADC scan over the nprobes nearest blocks → (vals, slots)
    (Q, k), global slot = block * pmax + offset. Entries past the live
    candidates carry vals ≥ PAD_PENALTY/2."""
    codes = dev["codes"]
    qb = q.shape[0]
    nparts, s_pad, pmax = codes.shape
    probe_ids, probe_dots = _select_probes(q, dev["centroids"], nprobes, metric)
    rotation = dev.get("rotation")
    # OPQ: codes quantize ROTATED residuals, and q·(Rᵀŷ) = (R·q)·ŷ
    q_lut = q if rotation is None else q @ rotation.T
    dlut = _pq_dlut(q_lut, dev["codebooks"], s_pad)
    qn2 = torch.sum(torch.square(q), dim=-1)
    rnorms = dev["rnorms"]
    if metric == "dot":
        # kernel form qn2 − 2(qc + qdotr) + rn with qn2 = 0 and rn = the
        # padding penalty only; halving then gives −(q·x̃) + penalty
        qn2 = torch.zeros_like(qn2)
        rn = torch.where(rnorms >= _PAD, torch.full_like(rnorms, _PAD), 0.0)
    else:
        rn = rnorms
    if slot_penalty is not None:
        rn = rn + slot_penalty.reshape(nparts, pmax)
    dists = ivf_pq_adc_scan(
        probe_ids.to(torch.int32), dlut, codes, rn.contiguous(),
        probe_dots.contiguous(), qn2.contiguous(),
    )
    vals, slots = _probe_topk(dists, probe_ids, k)
    if metric == "dot":
        vals = torch.where(vals < _PAD / 2, vals * 0.5, vals)
    return vals, slots


def _probe_topk(dists: torch.Tensor, probe_ids: torch.Tensor, k: int):
    """(Q, NP, pmax) probed distances → the k smallest as (vals, global
    slots = block * pmax + offset), padded with +inf past NP·pmax."""
    qb, nprobes, pmax = dists.shape
    k_sel = min(k, nprobes * pmax)
    vals, pos = topk_smallest(dists.reshape(qb, nprobes * pmax), k_sel)
    slots = torch.gather(probe_ids, 1, pos // pmax) * pmax + pos % pmax
    if k_sel < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_sel), value=float("inf"))
        slots = torch.nn.functional.pad(slots, (0, k - k_sel))
    return vals, slots


def _flat_coefs(q: torch.Tensor, norms2: torch.Tensor, pad_pen: torch.Tensor, metric: str):
    """The flat scan's per-query (alpha, gamma) and per-slot additive term
    for ``metric`` (ops/flat_scan.py): l2 adds |x|², which already holds
    +3e38 on padding; cosine and dot add only the padding penalty."""
    qb = q.shape[0]
    if metric == "l2":
        return torch.full((qb,), -2.0, device=q.device), torch.sum(torch.square(q), dim=-1), norms2
    if metric == "cosine":
        qn = torch.clamp(torch.sqrt(torch.sum(torch.square(q), dim=-1)), min=1e-30)
        return -1.0 / qn, torch.ones((qb,), device=q.device), pad_pen
    return torch.full((qb,), -1.0, device=q.device), torch.zeros((qb,), device=q.device), pad_pen


def _ivf_flat_search(
    q: torch.Tensor,
    dev: dict[str, torch.Tensor],
    slot_penalty: torch.Tensor | None,
    nprobes: int,
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF_FLAT probed scan (the reference's _ivf_flat_search_device_rt
    on its fused path): probe selection, then ONE grouped-scan launch over
    every probe of the chunk, then top-k. The distances are the metric's
    own (cosine is 1 − cos, dot is −q·x): nothing to halve afterwards."""
    vectors = dev["vectors"]
    nparts, pmax, _ = vectors.shape
    probe_ids, _ = _select_probes(q, dev["centroids"], nprobes, metric)
    alpha, gamma, norms = _flat_coefs(q, dev["norms2"], dev["pad_pen"], metric)
    if slot_penalty is not None:
        norms = norms + slot_penalty.reshape(nparts, pmax)
    dists = ivf_flat_grouped_scan(
        probe_ids.to(torch.int32), q.contiguous(), vectors, norms.contiguous(),
        alpha.contiguous(), gamma.contiguous(),
    )
    return _probe_topk(dists, probe_ids, k)


def _flat_dists(q: torch.Tensor, src: torch.Tensor, norms2: torch.Tensor, metric: str
                ) -> torch.Tensor:
    """(Q, N) distances of the FLAT scan, before penalties. Against f32
    rows the product is full f32 (TF32 stays off, the PyTorch default);
    against low-precision rows the query is rounded to their dtype too
    and the products accumulate in f32, as the reference's are."""
    if src.dtype == torch.float32:
        dots = q @ src.T
    else:
        dots = q.to(src.dtype).float() @ src.float().T
    if metric == "dot":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(torch.square(q), dim=-1, keepdim=True))
        return 1.0 - dots / torch.clamp(qn, min=1e-30)  # index rows are unit-norm
    qn2 = torch.sum(torch.square(q), dim=-1, keepdim=True)
    return torch.clamp(qn2 - 2.0 * dots + norms2[None, :], min=0.0)


def _flat_search(
    q: torch.Tensor, vectors: torch.Tensor, vectors_lp: torch.Tensor | None,
    norms2: torch.Tensor, penalty: torch.Tensor, k: int, metric: str, mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force scan (the reference's _flat_search_device). vectors
    (N, D) f32; vectors_lp the same rows in ``matmul_dtype``, resident.

    * 'float32': exact f32 product + exact top-k;
    * 'bfloat16': low-precision product + top-k;
    * 'default': two passes, low-precision candidates (8·k, at least 64)
      reranked in exact f32.

    The reference selects in 'bfloat16' and in the first pass with the
    TPU's approximate top-k; here both selections are exact, which can
    only raise recall (ROADMAP A1). These are large plain products, left
    to ``torch.matmul`` as the reference left them to XLA."""
    if mode == "float32":
        return topk_smallest(_flat_dists(q, vectors, norms2, metric) + penalty[None, :], k)
    coarse = _flat_dists(q, vectors_lp, norms2, metric) + penalty[None, :]
    if mode == "bfloat16":
        return topk_smallest(coarse, k)
    kc = min(max(8 * k, 64), vectors.shape[0])
    _, cand = topk_smallest(coarse, kc)
    del coarse
    xc = vectors[cand].float()  # (Q, kc, D)
    if metric == "l2":
        d2 = torch.sum(torch.square(q[:, None, :] - xc), dim=-1)
    else:
        dots = torch.einsum("qd,qcd->qc", q, xc)
        if metric == "dot":
            d2 = -dots
        else:
            qn = torch.sqrt(torch.sum(torch.square(q), dim=-1, keepdim=True))
            d2 = 1.0 - dots / torch.clamp(qn, min=1e-30)
    vals, pos = topk_smallest(d2 + penalty[cand], k)
    return vals, torch.gather(cand, 1, pos)


def _ivf_full_scan(
    q: torch.Tensor, vectors: torch.Tensor, norms2: torch.Tensor,
    slot_penalty: torch.Tensor | None, k: int, metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan an IVF_FLAT index as one flat table (the reference's
    _ivf_full_scan_device, the planner's route for large batches when no
    probed kernel serves the device): the padded blocks flattened and
    scanned in f32 against the stored rows, with exact top-k. Padding
    carries its +3e38 in the penalty for every metric.
    Its (Q, P·pmax) distance matrix and the sort over it are this
    route's largest transients."""
    nslots = vectors.shape[0] * vectors.shape[1]
    flat_vecs = vectors.reshape(nslots, -1)
    flat_norms = norms2.reshape(nslots)
    pen = torch.where(flat_norms >= _PAD, _PAD, 0.0)
    if slot_penalty is not None:
        pen = pen + slot_penalty
    return _flat_search(q, flat_vecs, None, flat_norms, pen, k, metric, "float32")


def _device_refine_step(
    q, vals, slots, slotmap, table, cnorms2, k: int, metric: str,
    centroids=None, pmax: int = 0,
):
    """Fused refine: rerank the scan's k·refine candidates against a
    device-resident copy of the original vectors.

    q (Q, D) f32 (unit-norm for cosine); vals/slots (Q, kc) from the
    scan; slotmap (num_slots,) slot → row of ``table``; table (M, D)
    f32/f16/bf16; cnorms2 (M,) exact f32 squared norms (l2 only).
    Candidates already penalized out keep +inf. When pmax > 0 the table
    holds residuals against each slot's block centroid and
    x̂ = centroids[slot // pmax] + r is rebuilt in f32 first."""
    rows = slotmap[slots]  # (Q, kc)
    cand = table[rows].float()  # (Q, kc, D)
    if pmax:
        cand = cand + centroids[torch.div(slots, pmax, rounding_mode="floor")].float()
    dots = torch.einsum("qd,qcd->qc", q.float(), cand)
    if metric == "dot":
        exact = -dots
    elif metric == "cosine":
        exact = 1.0 - dots  # both sides unit-norm
    else:
        qn2 = torch.sum(torch.square(q.float()), dim=1, keepdim=True)
        exact = torch.clamp(qn2 - 2.0 * dots + cnorms2[rows], min=0.0)
    exact = torch.where(vals >= _PAD / 2, torch.full_like(exact, float("inf")), exact)
    v, pos = topk_smallest(exact, k)
    return v, torch.gather(slots, 1, pos)


# the index files each ported type loads, by file stem
_INDEX_FILES = {
    "FLAT": ("vectors", "row_ids"),
    "IVF_FLAT": ("centroids", "vectors", "row_ids"),
    "IVF_PQ": ("centroids", "codes", "rnorms", "codebooks", "row_ids"),
}


def _planner_batch(nq: int) -> int:
    """The batch size the IVF_FLAT planner rule compares. The reference
    pads each batch of at most 128 queries to 8, 32 or 128 (its XLA
    shape buckets) and applies the rule to the padded size; the port pads
    nothing, but rounds the same way so both packages take the same route
    on the same batch."""
    for bucket in (8, 32):
        if nq <= bucket:
            return bucket
    return _Q_CHUNK


class VectorSearcher:
    """A loaded, device-resident FLAT, IVF_FLAT or IVF_PQ index ready to
    serve queries."""

    def __init__(self, store: ObjectStore, prefix: str, meta: IndexMeta | None = None,
                 device=None):
        params = json.loads(store.read_bytes(f"{prefix}/meta.json"))
        if params["index_type"] not in PORTED_INDEX_TYPES:
            raise _not_ported(params["index_type"])
        names = list(_INDEX_FILES[params["index_type"]])
        if params.get("opq"):
            names.append("rotation")
        arrays = {n: np.asarray(_load_npy(store, f"{prefix}/{n}.npy")) for n in names}
        self._load(params, arrays, device, meta)

    @classmethod
    def from_arrays(cls, meta_doc: dict, arrays: dict, device=None) -> "VectorSearcher":
        """A searcher over the reference's arrays of a FLAT, IVF_FLAT or
        IVF_PQ index (the contents of its .npy files, by file stem)
        without touching disk."""
        if meta_doc["index_type"] not in PORTED_INDEX_TYPES:
            raise _not_ported(meta_doc["index_type"])
        self = cls.__new__(cls)
        self._load(dict(meta_doc), {k: np.asarray(v) for k, v in arrays.items()}, device)
        return self

    def _load(self, params: dict, arrays: dict, device, meta=None) -> None:
        self.meta = meta
        self.params = params
        self.device = resolve_device(device)
        self.metric = params["metric"]
        self.index_type = params["index_type"]
        self.dim = params["dim"]
        self._device: dict[str, torch.Tensor] = {}
        if self.index_type == "FLAT":
            self._load_flat(arrays)
            return
        self.nparts = params["num_partitions"]
        self.pmax = params["pmax"]
        rid = arrays["row_ids"]  # (P, pmax) int64, -1 on padding
        self.row_ids_flat = rid.reshape(-1).view(np.uint64)
        self.row_ids_valid = rid.reshape(-1) >= 0
        self.num_slots = self.nparts * self.pmax
        self._device["centroids"] = _to_device(
            arrays["centroids"].astype(np.float32, copy=False), self.device
        )
        if self.index_type == "IVF_FLAT":
            vecs = arrays["vectors"].astype(np.float32, copy=False)
            norms2 = np.sum(vecs.astype(np.float64) ** 2, axis=2).astype(np.float32)
            norms2[~self.row_ids_valid.reshape(self.nparts, self.pmax)] = PAD_PENALTY
            # storage per build config: f32 ranks exactly; bf16 (on the
            # card) halves memory and scan bytes, and the f32 norms keep
            # the l2 expansion accurate either way
            dtype = (
                matmul_dtype(self.device) if params.get("precision") == "bfloat16"
                else torch.float32
            )
            self._device["vectors"] = _to_device(vecs, self.device, dtype)
            n2 = self._device["norms2"] = _to_device(norms2, self.device)
            self._device["pad_pen"] = torch.where(n2 >= _PAD, _PAD, 0.0)
            return
        self._device["codes"] = _to_device(arrays["codes"], self.device)
        for name in ("rnorms", "codebooks", "rotation"):  # rotation: OPQ indexes only
            if name in arrays:
                self._device[name] = _to_device(
                    arrays[name].astype(np.float32, copy=False), self.device
                )

    def _load_flat(self, arrays: dict) -> None:
        """FLAT: the rows padded to a multiple of 8, padding penalized."""
        vecs = arrays["vectors"].astype(np.float32, copy=False)
        rids = arrays["row_ids"].astype(np.uint64)
        n = vecs.shape[0]
        n_pad = round_up(n, 8)
        penalty = np.zeros(n_pad, np.float32)
        penalty[n:] = PAD_PENALTY
        if n_pad != n:
            vecs = np.pad(vecs, ((0, n_pad - n), (0, 0)))
            rids = np.pad(rids, (0, n_pad - n), constant_values=_INVALID_ROWID)
        self.row_ids_flat = rids
        self.row_ids_valid = np.arange(n_pad) < n
        self.num_slots = n_pad
        norms2 = np.sum(vecs.astype(np.float64) ** 2, axis=1).astype(np.float32)
        self._device["vectors"] = _to_device(vecs, self.device)
        self._device["norms2"] = _to_device(norms2, self.device)
        self._device["penalty"] = _to_device(penalty, self.device)

    def _vectors_lp(self) -> torch.Tensor:
        """The FLAT table in ``matmul_dtype``, resident, made on the first
        low-precision search (+2 bytes per element on the card: the coarse
        pass then reads half the bytes; on the CPU it is the f32 table)."""
        lp = self._device.get("vectors_lp")
        if lp is None:
            lp = self._device["vectors_lp"] = self._device["vectors"].to(matmul_dtype(self.device))
        return lp

    # ---- mask plumbing -------------------------------------------------
    def slot_penalty(
        self,
        allowed_row_ids: np.ndarray | None,
        deleted_row_ids: np.ndarray | None,
        vanished_fragments: set[int] | None = None,
    ) -> np.ndarray | None:
        """The per-slot additive penalty for prefilter/deletions (host).

        allowed_row_ids: sorted uint64 (None = all allowed);
        deleted_row_ids: sorted uint64 (None = none deleted);
        vanished_fragments: fragment ids no longer in the manifest whose
        indexed rows must all be masked."""
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
            dead = np.isin(frag_of, np.fromiter(vanished_fragments, dtype=np.int64))
            penalty[dead] = PAD_PENALTY
        return penalty

    @property
    def device_refine_active(self) -> bool:
        """True once prepare_device_refine has a resident refine table."""
        return "refine_vecs" in self._device

    @staticmethod
    def refine_column_slots(dataset, column: str, metric: str, slot_row_ids):
        """Materialize ``column`` with row ids and map index slots to rows:
        (mat, pos, found) with ``mat`` the rowid-sorted f32 matrix
        (unit-norm for cosine), ``pos[i]`` the row of ``slot_row_ids[i]``
        in ``mat`` and ``found[i]`` whether that row id still exists."""
        tbl = dataset.to_table(columns=[column], with_row_id=True)
        rid = tbl.column("_rowid").to_numpy().astype(np.uint64)
        mat = fsl_to_numpy(tbl.column(column)).astype(np.float32)
        order = np.argsort(rid)
        rid, mat = rid[order], mat[order]
        if metric == "cosine":
            mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-30)
        slot_row_ids = np.asarray(slot_row_ids, dtype=np.uint64)
        pos = np.searchsorted(rid, slot_row_ids)
        pos = np.clip(pos, 0, max(0, len(rid) - 1)).astype(np.int64)
        if len(rid):
            found = rid[pos] == slot_row_ids
        else:
            found = np.zeros_like(pos, bool)
        return mat, pos, found

    def will_fuse_refine(self, params: SearchParams) -> bool:
        """Whether search(params) returns already-refined results: only a
        quantized index fuses, and a precision='float32' request only
        against an f32 table (never silently against a narrower one)."""
        return (
            params.refine_factor is not None
            and self.device_refine_active
            and self.index_type == "IVF_PQ"
            and (params.precision != "float32"
                 or self._device["refine_vecs"].dtype == torch.float32)
        )

    def prepare_device_refine(self, dataset, column: str, precision: str | None = None) -> bool:
        """Upload a device-resident copy of the original vectors for the
        fused refine (``_device_refine_step``).

        The reference's rule, under the reference's environment names:
        off when LANCEDB_TPU_DEVICE_REFINE=0 or when the table exceeds
        LANCEDB_TPU_DEVICE_REFINE_BUDGET bytes (6e9). 'auto' stores f32
        when the table fits LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET (2e9)
        and f16 above it; a sub-f32 table holds residuals against each
        slot's block centroid, rebuilt in f32 inside the refine step.
        Rows deleted after the build map to row 0: their slots are
        penalized before the refine. FLAT and IVF_FLAT indexes scan the
        vectors themselves and keep the host refine (False)."""
        if self.device_refine_active:
            return True
        if getattr(self, "_refine_unavailable", False):
            return False
        if os.environ.get("LANCEDB_TPU_DEVICE_REFINE", "1") == "0":
            return False
        if self.index_type != "IVF_PQ":
            self._refine_unavailable = True
            return False
        n_live = dataset.count_rows() if hasattr(dataset, "count_rows") else None
        budget = float(os.environ.get("LANCEDB_TPU_DEVICE_REFINE_BUDGET", 6e9))
        if precision in (None, "auto"):
            f32_budget = float(os.environ.get("LANCEDB_TPU_DEVICE_REFINE_F32_BUDGET", 2e9))
            n_est = n_live if n_live is not None else len(self.row_ids_flat)
            precision = "float32" if n_est * self.dim * 4 <= f32_budget else "float16"
        dtype = {
            "float32": torch.float32,
            "float16": torch.float16,
            "bfloat16": matmul_dtype(self.device),
        }.get(precision, torch.float16)
        bytes_per = 4 if dtype == torch.float32 else 2
        if n_live is not None and n_live * self.dim * bytes_per > budget:
            self._refine_unavailable = True
            return False
        mat, pos, found = self.refine_column_slots(dataset, column, self.metric, self.row_ids_flat)
        if mat.shape[0] * mat.shape[1] * bytes_per > budget:
            self._refine_unavailable = True
            return False
        slotmap = np.where(found & self.row_ids_valid, pos, 0).astype(np.int64)
        if mat.shape[0] == 0:
            return False
        self._refine_residual = False
        if dtype != torch.float32:
            cents = self._device["centroids"].cpu().numpy()
            part_of_slot = (np.arange(self.num_slots, dtype=np.int64) // self.pmax).astype(np.int32)
            valid = found & self.row_ids_valid
            part_of_row = np.zeros(mat.shape[0], np.int32)
            part_of_row[pos[valid]] = part_of_slot[valid]
            mat = mat - cents[part_of_row]
            self._refine_residual = True
        self._device["refine_slotmap"] = _to_device(slotmap, self.device)
        self._device["refine_vecs"] = _to_device(mat, self.device, dtype)
        if self.metric not in ("dot", "cosine"):
            # exact f32 norms of the ORIGINAL rows
            orig = mat + cents[part_of_row] if self._refine_residual else mat
            self._device["refine_norms2"] = _to_device(
                np.sum(orig.astype(np.float64) ** 2, axis=1).astype(np.float32), self.device
            )
        return True

    # ---- search --------------------------------------------------------
    def _block_nprobes(self, nprobes: int) -> int:
        """The user's per-partition nprobes in blocks: fat logical
        partitions were split into duplicate-centroid blocks at build
        (_balanced_layout), so nprobes is rescaled to block granularity."""
        logical = self.params.get("num_logical_partitions", self.nparts)
        scale = self.nparts / max(1, logical)
        return min(self.nparts, max(1, int(np.ceil(nprobes * scale))))

    def search(
        self,
        queries: np.ndarray,
        params: SearchParams,
        slot_penalty: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (distances (Q, k) f32, row_ids (Q, k) uint64). Slots
        that fell off the index (padding / filtered) come back with
        distance +inf and row id 2^64-1."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if q.shape[1] != self.dim:
            raise InvalidInputError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        k_eff = params.k if params.refine_factor is None else params.k * params.refine_factor
        k_eff = min(k_eff, self.num_slots)
        nprobes = 0 if self.index_type == "FLAT" else self._block_nprobes(params.nprobes)
        pen = None if slot_penalty is None else _to_device(slot_penalty, self.device)
        fused = self.will_fuse_refine(params)
        dev = self._device
        vals_out, slots_out = [], []
        for i in range(0, q.shape[0], _Q_CHUNK):
            qj = _to_device(q[i : i + _Q_CHUNK], self.device)
            vals, slots = self._scan(qj, params, pen, nprobes, k_eff)
            if fused:
                residual = getattr(self, "_refine_residual", False)
                vals, slots = _device_refine_step(
                    qj, vals, slots, dev["refine_slotmap"], dev["refine_vecs"],
                    dev.get("refine_norms2"), k=min(params.k, k_eff), metric=self.metric,
                    centroids=dev["centroids"] if residual else None,
                    pmax=self.pmax if residual else 0,
                )
            vals_out.append(vals)
            slots_out.append(slots)
        vals = torch.cat(vals_out).cpu().numpy()
        slots = torch.cat(slots_out).cpu().numpy()
        rids = self.row_ids_flat[slots]
        invalid = vals >= PAD_PENALTY / 2
        rids = np.where(invalid, _INVALID_ROWID, rids)
        vals = np.where(invalid, np.float32(np.inf), vals)
        if self.metric == "cosine" and not fused and self.index_type == "IVF_PQ":
            # the ADC scan computes l2² on the unit sphere = 2·(1−cos);
            # FLAT and IVF_FLAT give the cosine distance directly
            vals = np.where(np.isfinite(vals), vals / 2.0, vals)
        return vals.astype(np.float32), rids

    def _scan(self, q: torch.Tensor, params: SearchParams, pen: torch.Tensor | None,
              nprobes: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk of queries through this index type's scan → (vals, slots)."""
        dev = self._device
        if self.index_type == "FLAT":
            mode = params.precision
            if mode == "default" and params.approx_mode == "accurate":
                mode = "float32"
            return _flat_search(
                q, dev["vectors"], None if mode == "float32" else self._vectors_lp(),
                dev["norms2"], dev["penalty"] if pen is None else dev["penalty"] + pen,
                k, self.metric, mode,
            )
        if self.index_type == "IVF_PQ":
            return _ivf_pq_search(q, dev, pen, nprobes, k, self.metric)
        # The reference's batched-query planner: without a fused probed
        # kernel, a large batch reads less in one shared full scan than in
        # its probed gathers (qb·nprobes ≥ 2.5·P). The grouped kernel reads
        # each probed block about once per batch, so wherever it serves the
        # device (the card here; the reference's TPU, which also needs
        # D % 128 == 0, a condition the CUDA kernel does not have) the
        # probed scan always runs.
        fused_ok = self.device.type == "cuda"
        if (
            _planner_batch(q.shape[0]) * nprobes >= 2.5 * self.nparts
            and params.use_index_for_batch is not True
            and not fused_ok
        ):
            return _ivf_full_scan(q, dev["vectors"], dev["norms2"], pen, k, self.metric)
        return _ivf_flat_search(q, dev, pen, nprobes, k, self.metric)

    def refine(self, dataset, column, queries, dists, row_ids, k):
        """Exact host rerank of candidates (late materialization)."""
        return refine_candidates(dataset, column, queries, row_ids, k, self.metric, self.device)


def refine_candidates(
    dataset, column: str, queries: np.ndarray, row_ids: np.ndarray, k: int, metric: str,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact rerank that gathers only the candidate rows (k·refine per
    query), never the index. Small reranks run on the host; large ones on
    ``device``."""
    nq, cand = row_ids.shape
    flat_ids = row_ids.reshape(-1)
    valid = flat_ids != _INVALID_ROWID
    uniq, inverse = np.unique(flat_ids[valid], return_inverse=True)
    tbl = dataset.take_rows(uniq, columns=[column])
    mat = fsl_to_numpy(tbl.column(column))
    if metric == "cosine":
        mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-30)
    gathered = np.zeros((nq * cand, mat.shape[1]), dtype=np.float32)
    gathered[valid] = mat[inverse]
    cands = gathered.reshape(nq, cand, -1)
    q = np.asarray(queries, dtype=np.float32)
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    if cands.size <= 64 * 1024 * 1024:
        dots = np.einsum("qd,qkd->qk", q, cands, optimize=True)
        if metric == "dot":
            exact = -dots
        elif metric == "cosine":
            qn = np.linalg.norm(q, axis=-1)[:, None]
            cn = np.linalg.norm(cands, axis=-1)
            exact = 1.0 - dots / np.maximum(qn * cn, 1e-30)
        else:
            qn2 = np.sum(np.square(q), axis=-1)[:, None]
            cn2 = np.sum(np.square(cands), axis=-1)
            exact = np.maximum(qn2 - 2.0 * dots + cn2, 0.0)
        exact = exact.astype(np.float32)
    else:
        dev = resolve_device(device)
        exact = refine_distances(
            _to_device(q, dev), _to_device(cands, dev), metric
        ).cpu().numpy()
    exact = np.where(valid.reshape(nq, cand), exact, np.inf)
    order = np.argsort(exact, axis=1)[:, :k]
    return np.take_along_axis(exact, order, axis=1), np.take_along_axis(row_ids, order, axis=1)


def load_searcher(dataset, meta: IndexMeta, device=None):
    """The searcher of one index: HnswSearcher for the IVF_HNSW types,
    VectorSearcher for the others."""
    if meta.index_type.startswith("IVF_HNSW"):
        from .hnsw import HnswSearcher

        return HnswSearcher(dataset.store, dataset.index_dir(meta.uuid), meta, device)
    if meta.index_type not in PORTED_INDEX_TYPES:
        raise _not_ported(meta.index_type)
    return VectorSearcher(dataset.store, dataset.index_dir(meta.uuid), meta, device)


def brute_force_search(
    vectors: np.ndarray,
    row_ids: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str,
    precision: str = "float32",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Index-free exact search over in-memory vectors (unindexed delta
    fragments and tiny tables)."""
    metric = normalize_metric(metric)
    dev = resolve_device(device)
    k = min(k, len(vectors))
    q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    d = pairwise_distance(
        _to_device(q, dev), _to_device(np.asarray(vectors, dtype=np.float32), dev), metric,
        precision="bfloat16" if precision == "bfloat16" else "float32",
    )
    vals, idx = topk_smallest(d, k)
    return vals.cpu().numpy(), row_ids[idx.cpu().numpy()]
