"""Dynamic micro-batching for the query server.

A search call pays a fixed host and launch cost whatever its batch, and
the ADC kernel B1 scans up to 128 queries in one launch, so concurrent
single-vector requests coalesce into ONE multi-query execution. Leader–follower
design, no dispatcher thread: the first request of a compatible group
becomes the leader, waits ``window_s`` for followers, runs the fused
batch, and distributes the per-query results.

The upstream server serves per request; the batching is the reference
package's own (its remote/batching.py), kept as it is.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Hashable


class _Group:
    __slots__ = ("items", "event", "results", "error", "closed")

    def __init__(self):
        self.items: list[Any] = []
        self.event = threading.Event()
        self.results: list[Any] | None = None
        self.error: BaseException | None = None
        self.closed = False


class MicroBatcher:
    """Coalesce concurrent compatible requests into one batch call.

    ``submit(key, item, run_batch)`` blocks until the group executes;
    ``run_batch(items) -> list[results]`` runs ONCE per group, on the
    leader's thread. Groups are keyed by request compatibility (same
    table/params); a group closes at ``max_batch`` items or after the
    leader's ``window_s`` collection window.
    """

    def __init__(self, window_s: float = 0.002, max_batch: int = 64):
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._groups: dict[Hashable, _Group] = {}

    def submit(self, key: Hashable, item: Any, run_batch: Callable[[list], list]) -> Any:
        with self._lock:
            g = self._groups.get(key)
            if g is None or g.closed or len(g.items) >= self.max_batch:
                g = _Group()
                self._groups[key] = g
                leader = True
            else:
                leader = False
            idx = len(g.items)
            g.items.append(item)
            if len(g.items) >= self.max_batch:
                g.closed = True

        if leader:
            if self.window_s > 0:
                deadline = time.monotonic() + self.window_s
                while time.monotonic() < deadline:
                    with self._lock:
                        if g.closed:
                            break
                    time.sleep(min(0.0005, self.window_s))
            with self._lock:
                g.closed = True
                if self._groups.get(key) is g:
                    del self._groups[key]
                items = list(g.items)
            try:
                results = run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch returned {len(results)} results for {len(items)} items"
                    )
                g.results = results
            except BaseException as exc:  # propagate to every waiter
                g.error = exc
            g.event.set()
        else:
            g.event.wait(timeout=60.0)
        if g.error is not None:
            raise g.error
        if g.results is None:
            raise TimeoutError("micro-batch leader did not complete")
        return g.results[idx]
