"""Session: a cross-table cache of loaded index searchers with a byte budget.

Port of the searcher cache of the reference's session.py. Loaded
searchers pin device memory (PQ codes, rnorms, the refine table), so the
budget is in effect the device-memory budget for serving; eviction drops
the device tensors, and a reload from the object store is lazy.
``BackgroundRefresher`` keeps the tables of an eventually consistent
connection fresh (the reference's session.py:99).
"""

from __future__ import annotations

import logging
import threading
import weakref
from collections import OrderedDict

logger = logging.getLogger(__name__)

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


class BackgroundRefresher:
    """A daemon thread that reloads the latest manifest of every table
    registered with it, ahead of the connection's read-consistency
    interval: every max(interval - min(3 s, interval / 4), interval / 2,
    0.05) seconds (reference utils/background_cache.rs). It ends when its
    tables are gone or on stop()."""

    def __init__(self, interval: float):
        self.interval = interval
        refresh_window = min(3.0, interval / 4.0)
        self._period = max(interval - refresh_window, interval * 0.5, 0.05)
        self._tables: list[weakref.ref] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def register(self, table) -> None:
        with self._lock:
            self._tables.append(weakref.ref(table))
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                 name="lancedb-refresh")
                self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            with self._lock:
                refs = list(self._tables)
            live = []
            for ref in refs:
                t = ref()
                if t is None:
                    continue
                live.append(ref)
                try:
                    t._background_refresh()
                except Exception:  # the thread keeps serving; the next period retries
                    logger.exception("background refresh of table %r failed", t.name)
            with self._lock:
                self._tables = live
                if not live:
                    self._thread = None
                    return

    def stop(self, timeout: float | None = 5.0) -> bool:
        """Stop the thread and wait for it; True once it has ended."""
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is None or thread is threading.current_thread():
            return True
        thread.join(timeout)
        return not thread.is_alive()
