"""Scalar indexes: BTree (sorted), Bitmap, LabelList.

Reference: lance scalar indices (SURVEY.md §2.9: BTree with 4096-row
blocks, Bitmap, LabelList) surfaced through lancedb index.rs:31-56.
Purpose here is prefilter acceleration: simple predicates over indexed
columns resolve to row-id sets without scanning fragment data, feeding
the slot-penalty mask of the vector searchers.
"""

from __future__ import annotations

import io
import json
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import InvalidInputError
from ..filters.sql import Between, BinaryOp, Column, Expr, Literal, UnaryOp
from ..storage.manifest import IndexMeta, new_uuid


def _save_npy(store, path, arr):
    """Persist an array. Numeric arrays go out as .npy; object/string
    key arrays (BITMAP/LABEL_LIST uniques, BTREE sorted string values)
    are serialized as Arrow IPC so no index artifact ever needs
    ``allow_pickle`` — a pickled .npy from an untrusted object store
    would be arbitrary code execution on load."""
    arr = np.asarray(arr)
    if arr.dtype == object or arr.dtype.kind in "US":
        tbl = pa.table({"v": pa.array(arr.tolist())})
        sink = io.BytesIO()
        with pa.ipc.new_file(sink, tbl.schema) as w:
            w.write_table(tbl)
        store.write_bytes(path, sink.getvalue())
        return
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    store.write_bytes(path, buf.getvalue())


_NPY_MAGIC = b"\x93NUMPY"


def _load_npy(store, path):
    local = store.local_path(path)
    if local is not None:
        with open(local, "rb") as f:
            magic = f.read(6)
        if magic == _NPY_MAGIC:
            return np.load(local, mmap_mode="r", allow_pickle=False)
        with open(local, "rb") as f:
            data = f.read()
    else:
        data = store.read_bytes(path)
    if data[:6] == _NPY_MAGIC:
        return np.load(io.BytesIO(data), allow_pickle=False)
    tbl = pa.ipc.open_file(pa.BufferReader(data)).read_all()
    return np.asarray(tbl.column("v").to_pylist(), dtype=object)


def build_scalar_index(dataset, column: str, config, name: str | None = None) -> IndexMeta:
    if column not in dataset.schema.names:
        raise InvalidInputError(f"no column {column!r}")
    t0 = time.time()
    uuid = new_uuid()
    store = dataset.store
    prefix = dataset.index_dir(uuid)
    index_type = config.index_type

    values_parts, rid_parts, frag_ids = [], [], []
    for meta, tbl in dataset.scan_fragments(columns=[column], with_row_id=True):
        frag_ids.append(meta.id)
        values_parts.append(tbl.column(column))
        rid_parts.append(tbl.column("_rowid").to_numpy().astype(np.uint64))
    if not values_parts:
        raise InvalidInputError("cannot index an empty table")
    col = pa.concat_arrays([c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c for c in values_parts])
    rids = np.concatenate(rid_parts)
    n = len(rids)

    if index_type == "BTREE":
        vals = col.to_numpy(zero_copy_only=False)
        null_mask = pc.is_null(col).to_numpy(zero_copy_only=False)
        nn_idx = np.flatnonzero(~null_mask)  # nulls excluded from the sorted run
        order = nn_idx[np.argsort(vals[nn_idx], kind="stable")]
        _save_npy(store, f"{prefix}/sorted_values.npy", np.asarray(vals)[order])
        _save_npy(store, f"{prefix}/sorted_rowids.npy", rids[order].view(np.int64))
        _save_npy(store, f"{prefix}/null_rowids.npy", rids[null_mask].view(np.int64))
    elif index_type == "BITMAP":
        vals = col.to_numpy(zero_copy_only=False)
        # nulls get their own posting (np.unique cannot sort str/None
        # mixes, and = NULL must never match anyway — IS NULL reads
        # null_rowids, mirroring the BTREE layout)
        null_mask = pc.is_null(col).to_numpy(zero_copy_only=False)
        nn_idx = np.flatnonzero(~null_mask)
        uniques, inverse = np.unique(
            np.asarray(vals, dtype=object)[nn_idx], return_inverse=True
        )
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse, minlength=len(uniques))
        offsets = np.zeros(len(uniques) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        _save_npy(store, f"{prefix}/keys.npy", uniques)
        _save_npy(store, f"{prefix}/offsets.npy", offsets)
        _save_npy(store, f"{prefix}/rowids.npy", rids[nn_idx][order].view(np.int64))
        _save_npy(store, f"{prefix}/null_rowids.npy", rids[null_mask].view(np.int64))
    elif index_type == "LABEL_LIST":
        if not (pa.types.is_list(col.type) or pa.types.is_large_list(col.type)):
            raise InvalidInputError("LABEL_LIST requires a list column")
        flat = []
        flat_rids = []
        pylist = col.to_pylist()
        for rid, labels in zip(rids, pylist):
            for lab in labels or []:
                flat.append(lab)
                flat_rids.append(rid)
        flat = np.asarray(flat, dtype=object)
        flat_rids = np.asarray(flat_rids, dtype=np.uint64)
        uniques, inverse = np.unique(flat, return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse, minlength=len(uniques))
        offsets = np.zeros(len(uniques) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        _save_npy(store, f"{prefix}/keys.npy", uniques)
        _save_npy(store, f"{prefix}/offsets.npy", offsets)
        _save_npy(store, f"{prefix}/rowids.npy", flat_rids[order].view(np.int64))
    elif index_type == "FM":
        if not (pa.types.is_string(col.type) or pa.types.is_large_string(col.type)):
            raise InvalidInputError("FM requires a string column")
        docs = [(s or "").encode("utf-8") for s in col.to_pylist()]
        # 0x01 separates documents; patterns never contain it, so a
        # suffix-array match can never span two documents
        text = b"\x01".join(docs) + b"\x01"
        tarr = np.frombuffer(text, dtype=np.uint8)
        from ..native import suffix_array_native

        sa = suffix_array_native(text)
        if sa is None:  # no native toolchain: vectorized numpy fallback
            sa = _suffix_array(tarr)
        doc_offsets = np.zeros(len(docs) + 1, dtype=np.int64)
        np.cumsum([len(d) + 1 for d in docs], out=doc_offsets[1:])
        _save_npy(store, f"{prefix}/text.npy", tarr)
        _save_npy(store, f"{prefix}/sa.npy", sa)
        _save_npy(store, f"{prefix}/doc_offsets.npy", doc_offsets)
        _save_npy(store, f"{prefix}/doc_rowids.npy", rids.view(np.int64))
    else:
        raise InvalidInputError(f"unknown scalar index type {index_type!r}")

    params = {"column": column, "num_rows": n, "build_seconds": time.time() - t0}
    store.write_bytes(f"{prefix}/meta.json", json.dumps(params).encode())
    return IndexMeta(
        name=name or f"{column}_idx",
        uuid=uuid,
        columns=[column],
        index_type=index_type,
        params=params,
        fragment_ids=frag_ids,
        num_indexed_rows=n,
        created_at=time.time(),
    )


def _suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (O(n log² n), fully vectorized)."""
    n = len(t)
    rank = t.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    while k < n:
        # key = (rank[i], rank[i+k]); -1 past the end
        rank_k = np.full(n, -1, dtype=np.int64)
        rank_k[: n - k] = rank[k:]
        order = np.lexsort((rank_k, rank))
        key_r = rank[order]
        key_rk = rank_k[order]
        new_rank = np.zeros(n, dtype=np.int64)
        changed = np.ones(n, dtype=bool)
        changed[1:] = (key_r[1:] != key_r[:-1]) | (key_rk[1:] != key_rk[:-1])
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        sa = order
        if rank[order[-1]] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


class ScalarIndexReader:
    """Loaded scalar index answering simple predicates with row-id sets."""

    def __init__(self, store, prefix: str, meta: IndexMeta):
        self.meta = meta
        self.index_type = meta.index_type
        if self.index_type == "BTREE":
            self.sorted_values = np.asarray(_load_npy(store, f"{prefix}/sorted_values.npy"))
            self.sorted_rowids = np.asarray(_load_npy(store, f"{prefix}/sorted_rowids.npy")).view(np.uint64)
            self.null_rowids = np.asarray(_load_npy(store, f"{prefix}/null_rowids.npy")).view(np.uint64)
        elif self.index_type == "FM":
            self.text = np.asarray(_load_npy(store, f"{prefix}/text.npy")).tobytes()
            self.sa = np.asarray(_load_npy(store, f"{prefix}/sa.npy"))
            self.doc_offsets = np.asarray(_load_npy(store, f"{prefix}/doc_offsets.npy"))
            self.doc_rowids = np.asarray(_load_npy(store, f"{prefix}/doc_rowids.npy")).view(np.uint64)
        else:
            self.keys = np.asarray(_load_npy(store, f"{prefix}/keys.npy"))
            self.offsets = np.asarray(_load_npy(store, f"{prefix}/offsets.npy"))
            self.rowids = np.asarray(_load_npy(store, f"{prefix}/rowids.npy")).view(np.uint64)
            if self.index_type == "BITMAP":
                self.null_rowids = np.asarray(
                    _load_npy(store, f"{prefix}/null_rowids.npy")
                ).view(np.uint64)

    # ---- predicate resolution -----------------------------------------
    def lookup_range(self, lo=None, hi=None, lo_incl=True, hi_incl=True) -> np.ndarray:
        if self.index_type != "BTREE":
            raise InvalidInputError("range lookup requires a BTREE index")
        sv = self.sorted_values
        left = 0 if lo is None else np.searchsorted(sv, lo, side="left" if lo_incl else "right")
        right = len(sv) if hi is None else np.searchsorted(sv, hi, side="right" if hi_incl else "left")
        return np.sort(self.sorted_rowids[left:right])

    def lookup_eq(self, value) -> np.ndarray:
        if value is None:  # SQL: = NULL never matches (use IS NULL)
            return np.empty(0, dtype=np.uint64)
        if self.index_type == "BTREE":
            return self.lookup_range(value, value)
        idx = np.searchsorted(self.keys, value)
        if idx >= len(self.keys) or self.keys[idx] != value:
            return np.empty(0, dtype=np.uint64)
        return np.sort(self.rowids[self.offsets[idx] : self.offsets[idx + 1]])

    def lookup_in(self, values) -> np.ndarray:
        parts = [self.lookup_eq(v) for v in values]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.unique(np.concatenate(parts))

    def _sa_bounds(self, pat: bytes) -> tuple[int, int]:
        """[lo, hi) of suffix-array entries whose suffix starts with pat."""
        text, sa, m = self.text, self.sa, len(pat)
        lo, hi = 0, len(sa)
        while lo < hi:  # first suffix >= pat
            mid = (lo + hi) // 2
            p = int(sa[mid])
            if text[p : p + m] < pat:
                lo = mid + 1
            else:
                hi = mid
        left = lo
        hi = len(sa)
        while lo < hi:  # first suffix whose m-prefix > pat
            mid = (lo + hi) // 2
            p = int(sa[mid])
            if text[p : p + m] <= pat:
                lo = mid + 1
            else:
                hi = mid
        return left, lo

    def lookup_like(self, pattern: str) -> np.ndarray | None:
        """Resolve a LIKE pattern of shape [%]needle[%] (no '_', no inner
        '%'); returns sorted row ids, or None if the pattern needs a scan."""
        if self.index_type != "FM":
            raise InvalidInputError("lookup_like requires an FM index")
        if "_" in pattern:
            return None
        leading = pattern.startswith("%")
        trailing = pattern.endswith("%")
        needle = pattern[1 if leading else 0 : len(pattern) - 1 if trailing else None]
        if "%" in needle:
            return None
        if not needle:
            return np.sort(np.unique(self.doc_rowids))
        pat = needle.encode("utf-8")
        left, right = self._sa_bounds(pat)
        if left >= right:
            return np.empty(0, dtype=np.uint64)
        pos = self.sa[left:right]
        doc = np.searchsorted(self.doc_offsets, pos, side="right") - 1
        keep = np.ones(len(pos), dtype=bool)
        if not leading:  # anchored prefix: match starts at doc start
            keep &= pos == self.doc_offsets[doc]
        if not trailing:  # anchored suffix: match ends at doc end
            keep &= pos + len(pat) == self.doc_offsets[doc + 1] - 1
        return np.sort(np.unique(self.doc_rowids[doc[keep]]))

    def lookup_is_null(self) -> np.ndarray:
        if self.index_type in ("BTREE", "BITMAP"):
            return np.sort(self.null_rowids)
        return np.empty(0, dtype=np.uint64)


def try_scalar_prefilter(table, ast: Expr) -> np.ndarray | None:
    """Resolve a predicate to sorted row-ids via scalar indexes when the
    shape allows (col op literal / IN / BETWEEN / AND-OR of those).
    Returns None when the predicate needs a full scan. Only valid when
    index coverage is complete (no delta fragments, no new deletes) —
    the caller checks coverage."""
    ds = table._dataset
    readers: dict[str, ScalarIndexReader] = {}

    def reader_for(col: str) -> ScalarIndexReader | None:
        if col in readers:
            return readers[col]
        for ix in ds.manifest.indices:
            if ix.columns == [col] and ix.index_type in ("BTREE", "BITMAP", "LABEL_LIST", "FM"):
                covered = {f.id for f in ds.manifest.fragments} == set(ix.fragment_ids)
                fresh = all(f.num_deleted == 0 for f in ds.manifest.fragments)
                if covered and fresh:
                    r = ScalarIndexReader(ds.store, ds.index_dir(ix.uuid), ix)
                    readers[col] = r
                    return r
        return None

    def resolve(e: Expr) -> np.ndarray | None:
        if isinstance(e, BinaryOp):
            if e.op in ("and", "or"):
                left = resolve(e.left)
                right = resolve(e.right)
                if left is None or right is None:
                    return None
                if e.op == "and":
                    return np.intersect1d(left, right)
                return np.union1d(left, right)
            if isinstance(e.left, Column) and isinstance(e.right, Literal):
                r = reader_for(e.left.name)
                if r is None:
                    return None
                v = e.right.value
                if e.op == "like" and r.index_type == "FM":
                    return r.lookup_like(str(v))
                if r.index_type == "FM":
                    return None
                if e.op == "eq":
                    return r.lookup_eq(v)
                if e.op == "in":
                    return r.lookup_in(v)
                if r.index_type != "BTREE":
                    return None
                if e.op == "lt":
                    return r.lookup_range(hi=v, hi_incl=False)
                if e.op == "le":
                    return r.lookup_range(hi=v)
                if e.op == "gt":
                    return r.lookup_range(lo=v, lo_incl=False)
                if e.op == "ge":
                    return r.lookup_range(lo=v)
            return None
        if isinstance(e, Between) and isinstance(e.operand, Column) and not e.negated:
            if isinstance(e.low, Literal) and isinstance(e.high, Literal):
                r = reader_for(e.operand.name)
                if r is None or r.index_type != "BTREE":
                    return None
                return r.lookup_range(e.low.value, e.high.value)
            return None
        if isinstance(e, UnaryOp) and e.op == "is_null" and isinstance(e.operand, Column):
            r = reader_for(e.operand.name)
            if r is None or r.index_type not in ("BTREE", "BITMAP"):
                return None  # other index kinds don't track nulls: scan
            return r.lookup_is_null()
        return None

    return resolve(ast)
