"""Session: a cross-table cache of loaded index searchers with a byte budget.

Port of the searcher cache of the reference's session.py. Loaded
searchers pin device memory (PQ codes, rnorms, the refine table), so the
budget is in effect the device-memory budget for serving; eviction drops
the device tensors, and a reload from the object store is lazy. The
background read-consistency refresher waits for a later slice
(ROADMAP A4).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

DEFAULT_INDEX_CACHE_BYTES = 8 << 30


def _searcher_nbytes(searcher) -> int:
    """Bytes a searcher holds: its device tensors (torch or numpy, both
    report ``.nbytes``), its host slot → row-id map and, for HNSW, the
    host storage its walks read."""
    total = sum(arr.nbytes for arr in getattr(searcher, "_device", {}).values())
    rids = getattr(searcher, "row_ids_flat", None)
    if rids is not None:
        total += rids.nbytes
    storage = getattr(searcher, "storage", None)
    if storage is not None:
        total += sum(v.nbytes for v in vars(storage).values() if hasattr(v, "nbytes"))
    return max(total, 1)


class Session:
    """Cross-table cache of loaded index searchers with a byte budget."""

    def __init__(self, index_cache_size_bytes: int = DEFAULT_INDEX_CACHE_BYTES):
        self.index_cache_size_bytes = index_cache_size_bytes
        self._lock = threading.Lock()
        self._cache: OrderedDict[str, tuple[object, int]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_load(self, key: str, loader):
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.hits += 1
                return self._cache[key][0]
            self.misses += 1
        obj = loader()
        size = _searcher_nbytes(obj)
        with self._lock:
            self._cache[key] = (obj, size)
            self._bytes += size
            while self._bytes > self.index_cache_size_bytes and len(self._cache) > 1:
                _, (_old, old_size) = self._cache.popitem(last=False)
                self._bytes -= old_size
                self.evictions += 1
        return obj

    def invalidate(self, prefix: str = "") -> None:
        with self._lock:
            for k in [k for k in self._cache if k.startswith(prefix)]:
                _, size = self._cache.pop(k)
                self._bytes -= size

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._cache),
                "bytes": self._bytes,
                "budget_bytes": self.index_cache_size_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
