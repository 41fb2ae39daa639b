"""External (disk-spilling) shuffle under a memory budget.

A copy of the JAX package's data/shuffle.py (host code).

Reference: the permutation Shuffler sorts rows by a random key through
DataFusion's external sort with a default 100 MiB memory budget
(reference rust/lancedb/src/dataloader/permutation/shuffle.rs:32-81,
builder.rs:30). Same contract here, numpy-native:

* every row gets a deterministic pseudo-random uint64 key
  (splitmix64 of the row's global position mixed with the seed; clumped
  rows share their clump's key so clumps move as units),
* the final order is rows sorted by (split, key, position) — a global
  property, so the result is IDENTICAL for every memory budget; the
  budget only bounds the working set,
* execution radix-partitions rows by the key's top bits into
  ~n/budget_rows spill files (keys are uniform, so buckets are even),
  then loads one bucket at a time, sorts it, and yields it.

Working-set bound: one bucket (~budget bytes) + stream chunk.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator

import numpy as np

_ROW_BYTES = 24  # key (8) + row_id (8) + split (4) + pad/sort scratch

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — a deterministic uint64 hash."""
    z = (x + _C1).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * _C2
    z = (z ^ (z >> np.uint64(27))) * _C3
    return z ^ (z >> np.uint64(31))


def external_shuffle(
    row_ids: np.ndarray,
    split_ids: np.ndarray,
    seed: int,
    clump_size: int | None = None,
    memory_budget_bytes: int = 100 << 20,
    tmp_dir: str | None = None,
    _stats: dict | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (row_ids, split_ids) chunks in shuffled order: split-major,
    random (seeded) within split, identical output for any budget."""
    n = len(row_ids)
    row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
    split_ids = np.ascontiguousarray(split_ids, dtype=np.int32)
    # per-SPLIT positions so clump boundaries align with split starts
    order = np.argsort(split_ids, kind="stable")
    row_ids, split_ids = row_ids[order], split_ids[order]
    uniq, starts, counts = np.unique(split_ids, return_index=True, return_counts=True)
    split_start = np.repeat(starts.astype(np.uint64), counts)
    pos_in_split = np.arange(n, dtype=np.uint64) - split_start

    keys = _per_split_keys(pos_in_split, seed, clump_size)

    budget_rows = max(1024, memory_budget_bytes // _ROW_BYTES)
    if n <= budget_rows:
        if _stats is not None:
            _stats["spilled"] = False
        yield from _emit_sorted(row_ids, split_ids, keys)
        return

    n_buckets = int(2 ** np.ceil(np.log2(max(2, -(-n // budget_rows)))))
    shift = np.uint64(64 - int(np.log2(n_buckets)))
    if _stats is not None:
        _stats.update(spilled=True, n_buckets=n_buckets)

    tdir = tempfile.mkdtemp(prefix="lancedb-shuffle-", dir=tmp_dir)
    files = [open(os.path.join(tdir, f"b{b:05d}.bin"), "wb") for b in range(n_buckets)]
    try:
        # pass 1: scatter budget-sized chunks into key-range buckets
        for lo in range(0, n, budget_rows):
            hi = min(n, lo + budget_rows)
            rec = np.empty(
                hi - lo,
                dtype=[("split", np.int32), ("key", np.uint64),
                       ("pos", np.uint64), ("rid", np.uint64)],
            )
            rec["split"] = split_ids[lo:hi]
            rec["key"] = keys[lo:hi]
            rec["pos"] = pos_in_split[lo:hi]
            rec["rid"] = row_ids[lo:hi]
            bucket = (keys[lo:hi] >> shift).astype(np.int64)
            bsort = np.argsort(bucket, kind="stable")
            rec = rec[bsort]
            bucket = bucket[bsort]
            bounds = np.searchsorted(bucket, np.arange(n_buckets + 1))
            for b in range(n_buckets):
                s, e = bounds[b], bounds[b + 1]
                if e > s:
                    files[b].write(rec[s:e].tobytes())
        for f in files:
            f.close()
        # pass 2: per split, walk buckets in key order (keys are uniform,
        # so each bucket holds ~budget rows), sort, emit
        dtype = np.dtype(
            [("split", np.int32), ("key", np.uint64),
             ("pos", np.uint64), ("rid", np.uint64)]
        )
        # splits must come out split-major: collect per-bucket by split.
        # buckets partition the KEY space, so a split's rows span all
        # buckets — emit split-by-split, scanning buckets in order.
        for u in uniq:
            for b in range(n_buckets):
                path = os.path.join(tdir, f"b{b:05d}.bin")
                data = np.fromfile(path, dtype=dtype)
                part = data[data["split"] == u]
                if not len(part):
                    continue
                o = np.lexsort((part["pos"], part["key"]))
                part = part[o]
                yield part["rid"].copy(), part["split"].copy()
    finally:
        for f in files:
            if not f.closed:
                f.close()
        for b in range(n_buckets):
            try:
                os.unlink(os.path.join(tdir, f"b{b:05d}.bin"))
            except OSError:
                pass
        try:
            os.rmdir(tdir)
        except OSError:
            pass


def _per_split_keys(pos_in_split: np.ndarray, seed: int, clump_size: int | None) -> np.ndarray:
    idx = pos_in_split.astype(np.uint64)
    if clump_size and clump_size > 1:
        idx = idx // np.uint64(clump_size)
    seed_mix = _splitmix64(np.asarray([np.uint64(seed & 0xFFFFFFFFFFFFFFFF)]))[0]
    return _splitmix64(idx ^ seed_mix)


def _emit_sorted(row_ids, split_ids, keys) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    o = np.lexsort((np.arange(len(keys)), keys, split_ids))
    yield row_ids[o], split_ids[o]
