"""Fragment data-file IO: immutable Arrow IPC files + deletion bitmaps.

The reference stores fragments in the Lance v2 columnar format (a git
dependency it calls into; SURVEY.md §2.9). We choose Arrow IPC as the
fragment encoding instead: it is already columnar, zero-copy
memory-mappable from local disk, supports per-batch random access, and
pyarrow gives us battle-tested readers — the TPU data plane consumes
numpy/JAX arrays converted zero-copy from these buffers.
"""

from __future__ import annotations

import io

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from ..io.object_store import ObjectStore
from .manifest import DATA_DIR, DELETIONS_DIR, FragmentMeta, new_uuid

# Row-group size inside a fragment file. Batches are the unit of random
# access (take-by-rowid seeks whole batches), so keep them big enough to
# amortize decode but small enough for point lookups.
DEFAULT_BATCH_ROWS = 16384

# Soft cap on rows per fragment file for streaing writes; the optimizer
# compacts small fragments (reference table/optimize.rs semantics).
DEFAULT_FRAGMENT_ROWS = 1 << 20


def write_fragment(
    store: ObjectStore,
    root: str,
    table: pa.Table,
    fragment_id: int,
    batch_rows: int = DEFAULT_BATCH_ROWS,
) -> FragmentMeta:
    """Write one immutable fragment file; returns its metadata."""
    sink = io.BytesIO()
    with ipc.new_file(sink, table.schema) as writer:
        for batch in table.combine_chunks().to_batches(max_chunksize=batch_rows):
            writer.write_batch(batch)
    name = f"{DATA_DIR}/{new_uuid()}.arrow"
    store.write_bytes(f"{root}/{name}", sink.getvalue())
    return FragmentMeta(id=fragment_id, data_file=name, physical_rows=table.num_rows)


class FragmentReader:
    """Random-access reader over one fragment file.

    Uses mmap when the store is local (zero-copy into Arrow buffers);
    falls back to an in-memory buffer otherwise.
    """

    def __init__(self, store: ObjectStore, root: str, meta: FragmentMeta):
        self.meta = meta
        path = f"{root}/{meta.data_file}"
        local = store.local_path(path)
        if local is not None:
            self._source = pa.memory_map(local, "r")
        else:
            self._source = pa.BufferReader(store.read_bytes(path))
        self._reader = ipc.open_file(self._source)
        self._num_batches = self._reader.num_record_batches
        self._batch_offsets: list[int] | None = None
        # LRU of decoded batches as Tables: get_batch re-parses the IPC
        # message each call, which dominates point lookups (take of
        # k≈10 rows decodes k batches). Entries reference the mmap /
        # shared buffer, so the cache costs metadata, not data.
        self._batch_cache: dict[int, pa.Table] = {}
        self._batch_cache_cap = 64

    @property
    def schema(self) -> pa.Schema:
        return self._reader.schema

    @property
    def num_physical_rows(self) -> int:
        return self.meta.physical_rows

    def _offsets(self) -> list[int]:
        if self._batch_offsets is None:
            offs = [0]
            for i in range(self._num_batches):
                offs.append(offs[-1] + self._reader.get_batch(i).num_rows)
            self._batch_offsets = offs
        return self._batch_offsets

    def read_all(self, columns: list[str] | None = None) -> pa.Table:
        t = self._reader.read_all()
        if columns is not None:
            t = t.select(columns)
        return t

    def iter_batches(self, columns: list[str] | None = None):
        for i in range(self._num_batches):
            b = self._reader.get_batch(i)
            if columns is not None:
                b = b.select(columns)
            yield b

    def _batch_table(self, bid: int) -> pa.Table:
        t = self._batch_cache.get(bid)
        if t is None:
            t = pa.Table.from_batches([self._reader.get_batch(bid)])
            # readers are shared across QueryServer request threads;
            # evict defensively so two threads racing at the cap can't
            # pop the same key (pop(k, None) instead of pop(k))
            while len(self._batch_cache) >= self._batch_cache_cap:
                oldest = next(iter(self._batch_cache), None)
                if oldest is None:
                    break
                self._batch_cache.pop(oldest, None)
            self._batch_cache[bid] = t
        return t

    def take(self, offsets: np.ndarray, columns: list[str] | None = None) -> pa.Table:
        """Take rows by physical offset within this fragment.

        Output row order matches ``offsets`` order (the contract the
        dataloader's PermutationReader depends on; reference
        dataloader/permutation/reader.rs:36-47).
        """
        if len(offsets) == 0:
            t = self._reader.read_all()
            if columns is not None:
                t = t.select(columns)
            return t.slice(0, 0)
        offs = np.asarray(offsets, dtype=np.int64)
        boundaries = np.asarray(self._offsets(), dtype=np.int64)
        batch_ids = np.searchsorted(boundaries, offs, side="right") - 1
        out_parts: list[pa.Table] = []
        order = np.argsort(batch_ids, kind="stable")
        inv_positions = np.empty(len(offs), dtype=np.int64)
        pieces = []
        pos = 0
        for bid in np.unique(batch_ids[order]):
            sel = np.nonzero(batch_ids == bid)[0]
            local = offs[sel] - boundaries[bid]
            tbl = self._batch_table(int(bid))
            if columns is not None:
                tbl = tbl.select(columns)
            piece = tbl.take(pa.array(local))
            pieces.append(piece)
            inv_positions[sel] = np.arange(pos, pos + len(sel))
            pos += len(sel)
        combined = pa.concat_tables(pieces) if pieces else None
        assert combined is not None
        # restore the caller's requested order
        restore = np.empty(len(offs), dtype=np.int64)
        restore[:] = inv_positions
        return combined.take(pa.array(restore))


def write_deletion_bitmap(store: ObjectStore, root: str, deleted_offsets: np.ndarray) -> str:
    """Persist a fragment's deletion set as a packed bitmap."""
    buf = io.BytesIO()
    np.savez_compressed(buf, offsets=np.asarray(deleted_offsets, dtype=np.uint32))
    name = f"{DELETIONS_DIR}/{new_uuid()}.npz"
    store.write_bytes(f"{root}/{name}", buf.getvalue())
    return name


def read_deletion_offsets(store: ObjectStore, root: str, deletion_file: str) -> np.ndarray:
    data = store.read_bytes(f"{root}/{deletion_file}")
    with np.load(io.BytesIO(data)) as z:
        return z["offsets"].astype(np.uint32)


def deletion_mask(
    store: ObjectStore, root: str, meta: FragmentMeta
) -> np.ndarray | None:
    """Boolean keep-mask of length physical_rows, or None if no deletions."""
    if meta.deletion_file is None or meta.num_deleted == 0:
        return None
    offs = read_deletion_offsets(store, root, meta.deletion_file)
    mask = np.ones(meta.physical_rows, dtype=bool)
    mask[offs] = False
    return mask
