"""Elastic, resumable streaming dataset for training loops.

A copy of the JAX package's data/streaming.py (host code), with the
port's imports. It reads host rows only: the pickled state a DataLoader
worker receives reconnects through the port's ``connect`` with the
table's device, which opens no CUDA context, and TorchBatchFeeder
(data/torch_feed.py) moves the rows to the devices in the main process.

Re-design of the reference StreamingDataset (python streaming.py:48-598):

* A FIXED ``num_splits`` partitions the permuted data independently of
  world size, so the sample→step mapping survives topology changes
  (reference streaming.py:48-63; verified across {1,2,3,4,6,12} ranks
  by test_elastic_dataloader.py — our tests sweep the same way).
* Each (rank, worker) owns a contiguous block of splits; iteration
  yields round-robin one sample per owned split.
* Two-stage pipeline: an IO thread pool prefetches read-batches per
  split (random-access take by row address), a transform stage converts
  Arrow → python/numpy (reference streaming.py:346-380).
* ``state_dict()`` is a per-split consumption count — topology
  independent — and ``load_state_dict()`` resumes exactly
  (reference streaming.py:583-598).
* Instrumentation: bytes_loaded / fetch_time / queue depths
  (reference streaming.py:449-526).

For multi-process training, one StreamingDataset per process (rank =
the process's rank) feeds that process's TorchBatchFeeder.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import pyarrow as pa

from ..errors import InvalidInputError

try:  # torch is optional; duck-typing works without it
    from torch.utils.data import IterableDataset as _TorchIterable
except Exception:  # pragma: no cover
    class _TorchIterable:  # type: ignore[no-redef]
        pass


def _default_transform(batch: pa.Table) -> list[dict]:
    return batch.to_pylist()


class _IdentityReader:
    """Reader-shaped adapter over a bare table: one split covering every
    row in stored order (what `Permutation.identity` views stream as)."""

    def __init__(self, base_table):
        self.base_table = base_table
        self.num_splits = 1

    def split_size(self, split: int) -> int:
        return self.base_table.count_rows()

    def read(self, split, offset, num_rows, columns=None):
        offs = np.arange(offset, offset + num_rows, dtype=np.int64)
        return self.base_table._dataset.take_offsets(offs, columns=columns)


def _as_reader(permutation):
    """Accept a PermutationReader, a dataset-view Permutation, or a bare
    table and return something with split_size/read/num_splits."""
    if hasattr(permutation, "split_size") and hasattr(permutation, "read"):
        return permutation
    from .permutation import Permutation, PermutationReader

    if isinstance(permutation, Permutation):
        if permutation.permutation_table is not None:
            return PermutationReader(
                permutation.permutation_table, permutation.base_table
            )
        return _IdentityReader(permutation.base_table)
    if hasattr(permutation, "_dataset"):  # a Table
        return _IdentityReader(permutation)
    raise InvalidInputError(
        f"cannot stream from {type(permutation).__name__}"
    )


def _view_stream_state(view):
    """Extract the streamable state a dataset-view Permutation carries
    (ADVICE r3: dropping it silently streamed the wrong rows/columns).

    Returns (split, columns, skip, take); raises for state streaming
    cannot honor (repeat, custom formats, renamed/nested selections)."""
    from .permutation import Transforms

    if view.repeat_times != 1:
        raise InvalidInputError(
            "cannot stream a with_repeat() view; loop epochs in the trainer"
        )
    if view.transform_fn not in (None, Transforms.arrow2python):
        raise InvalidInputError(
            "cannot stream a formatted view (with_format); pass transform= "
            "to StreamingDataset instead"
        )
    base_names = set(view.base_table.schema.names)
    sel = view.selection
    if any(k != s for k, s in sel.items()) or not set(sel.values()) <= base_names:
        raise InvalidInputError(
            "cannot stream a view with renamed or nested column selection; "
            "select plain base columns or pass columns= to StreamingDataset"
        )
    columns = list(sel) if set(sel) != base_names else None
    split = view.split if view.permutation_table is not None else None
    return split, columns, view.offset or 0, view.limit


class _WindowedReader:
    """Applies a with_skip/with_take window of one split onto a reader
    (how a windowed Permutation view streams)."""

    def __init__(self, inner, split: int, skip: int, take: int | None):
        self._inner = inner
        self._split = split
        self._skip = int(skip)
        self._take = take
        size = max(0, inner.split_size(split) - self._skip)
        self._size = min(size, take) if take is not None else size
        self.num_splits = inner.num_splits
        self.base_table = getattr(inner, "base_table", None)
        self.perm_table = getattr(inner, "perm_table", None)

    def split_size(self, split: int) -> int:
        return self._size if split == self._split else self._inner.split_size(split)

    def read(self, split, offset, num_rows, columns=None):
        if split == self._split:
            num_rows = max(0, min(num_rows, self._size - offset))
            offset = offset + self._skip
        return self._inner.read(split, offset, num_rows, columns)


class StreamingDataset(_TorchIterable):
    def __init__(
        self,
        permutation,
        *,
        split: int | None = None,
        num_splits: int | None = None,
        rank: int = 0,
        world_size: int = 1,
        read_batch_size: int = 64,
        columns: list[str] | None = None,
        transform: Callable[[pa.Table], Any] | None = None,
        io_threads: int = 4,
        prefetch_batches: int = 2,
        worker_info: Any | None = None,
        connection_factory: Callable[[str], Any] | None = None,
    ):
        """`permutation` — a PermutationReader, a dataset-view
        Permutation, or a bare table. When the permutation has ONE
        split, `num_splits` virtually re-partitions it; when it has many
        (e.g. train/val), pass `split` to pick one and `num_splits` to
        re-partition within it. ``connection_factory(table_name)`` is
        used to reopen the base table after unpickling in a DataLoader
        worker (reference streaming.py:536-581)."""
        from .permutation import Permutation

        self._window = None  # (split, skip, take) — survives pickling
        if isinstance(permutation, Permutation):
            # a dataset view carries split/column/window state — honor
            # it (or refuse loudly) instead of silently streaming the
            # whole table (ADVICE r3 medium)
            view_split, view_cols, skip, take = _view_stream_state(permutation)
            if split is None:
                split = view_split
            if columns is None:
                columns = view_cols
            permutation = _as_reader(permutation)
            if skip or take is not None:
                win_split = split if split is not None else 0
                permutation = _WindowedReader(permutation, win_split, skip, take)
                self._window = (win_split, skip, take)
        else:
            permutation = _as_reader(permutation)
        self._connection_factory = connection_factory
        self._perm = permutation
        self._source_split = split
        if split is not None:
            total = permutation.split_size(split)
        else:
            if permutation.num_splits != 1:
                raise InvalidInputError(
                    "permutation has multiple splits; pass split=<id> to choose one"
                )
            self._source_split = 0
            total = permutation.split_size(0)
        self._total_rows = total
        self._num_splits = num_splits or max(world_size, 1)
        if self._num_splits > total:
            raise InvalidInputError(f"num_splits {self._num_splits} > rows {total}")
        if world_size <= 0 or not (0 <= rank < world_size):
            raise InvalidInputError(f"bad rank/world_size {rank}/{world_size}")
        if self._num_splits % world_size != 0:
            raise InvalidInputError(
                f"num_splits {self._num_splits} must be divisible by world_size {world_size}"
            )
        self._rank = rank
        self._world = world_size
        self._read_batch = read_batch_size
        self._columns = columns
        self._transform = transform or _default_transform
        self._io_threads = io_threads
        self._prefetch = prefetch_batches
        self._worker_info = worker_info
        # virtual split s covers rows [s*len//S, (s+1)*len//S)
        bounds = [(s * total) // self._num_splits for s in range(self._num_splits + 1)]
        self._split_bounds = bounds
        self._consumed = np.zeros(self._num_splits, dtype=np.int64)
        # instrumentation
        self._bytes_loaded = 0
        self._fetch_time = 0.0
        self._transform_time = 0.0
        self._fetch_count = 0
        self._yielded = 0
        self._raw_rows = 0  # rows fetched, transform in flight
        self._lock = threading.Lock()
        # live iteration state (set during __iter__, cleared after) so
        # the queue-depth gauges can observe the running pipeline
        self._live: dict | None = None

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        return {
            "consumed": self._consumed.tolist(),
            "num_splits": self._num_splits,
            "total_rows": self._total_rows,
        }

    def load_state_dict(self, state: dict) -> None:
        if state["num_splits"] != self._num_splits:
            raise InvalidInputError(
                f"checkpoint has num_splits={state['num_splits']}, dataset has {self._num_splits}"
            )
        self._consumed = np.asarray(state["consumed"], dtype=np.int64).copy()

    # --------------------------------------------------- instrumentation
    @property
    def bytes_loaded(self) -> int:
        return self._bytes_loaded

    @property
    def fetch_time(self) -> float:
        return self._fetch_time

    @property
    def average_fetch_time(self) -> float:
        return self._fetch_time / max(self._fetch_count, 1)

    @property
    def transform_time(self) -> float:
        """Cumulative seconds inside the transform callable (measured in
        the stage-2 leg of the IO worker; reference streaming.py:474)."""
        return self._transform_time

    @property
    def raw_queue_depth(self) -> int:
        """Rows fetched from storage whose transform has not finished —
        persistently non-zero means the transform is the bottleneck
        (reference streaming.py:487). 0 when not iterating."""
        return self._raw_rows

    @property
    def prefetch_queue_depth(self) -> int:
        """Rows transformed and ready to hand to the consumer with no
        I/O or CPU wait (reference streaming.py:499). 0 when not
        iterating."""
        live = self._live
        if not live:
            return 0
        ready = sum(
            c for lst in live["pending"].values() for f, c in lst if f.done()
        )
        return ready + sum(len(v) for v in live["cursors"].values())

    @property
    def unscanned_rows(self) -> int:
        """Rows not yet submitted to the I/O stage (reference
        streaming.py:511). 0 when not iterating."""
        live = self._live
        if not live:
            return 0
        return sum(
            self._split_len(s) - live["sched_off"][s] for s in live["splits"]
        )

    @property
    def consumed_rows(self) -> int:
        """Rows already yielded to the caller, cumulative across
        iterations of this instance (reference streaming.py:526)."""
        return self._yielded

    # ---------------------------------------------------------- iteration
    def _my_splits(self) -> list[int]:
        """Rank block ∩ worker sub-block (reference streaming.py:235)."""
        per_rank = self._num_splits // self._world
        start = self._rank * per_rank
        mine = list(range(start, start + per_rank))
        wi = self._worker_info
        if wi is None:
            try:
                import torch.utils.data as tud

                wi = tud.get_worker_info()
            except Exception:
                wi = None
        if wi is not None and getattr(wi, "num_workers", 1) > 1:
            nw, wid = wi.num_workers, wi.id
            mine = [s for i, s in enumerate(mine) if i % nw == wid]
        return mine

    def _split_len(self, s: int) -> int:
        return self._split_bounds[s + 1] - self._split_bounds[s]

    def _fetch_batch(self, s: int, offset: int) -> Any:
        """Read one batch of split s starting at local offset: stage-1
        fetch, then stage-2 transform, each timed separately."""
        t0 = time.perf_counter()
        count = min(self._read_batch, self._split_len(s) - offset)
        tbl = self._perm.read(
            self._source_split,
            self._split_bounds[s] + offset,
            count,
            columns=self._columns,
        )
        t1 = time.perf_counter()
        with self._lock:
            self._fetch_time += t1 - t0
            self._fetch_count += 1
            self._bytes_loaded += tbl.nbytes
            self._raw_rows += count
        try:
            out = self._transform(tbl)
        finally:
            with self._lock:
                self._raw_rows -= count
                self._transform_time += time.perf_counter() - t1
        return out, count

    def __iter__(self) -> Iterator[Any]:
        splits = self._my_splits()
        if not splits:
            return
        pool = ThreadPoolExecutor(max_workers=self._io_threads, thread_name_prefix="ldb-io")
        try:
            # stage-1 IO: per split, a short queue of in-flight batch reads
            pending: dict[int, list] = {s: [] for s in splits}
            sched_off = {s: int(self._consumed[s]) for s in splits}
            cursors: dict[int, list] = {s: [] for s in splits}  # decoded samples
            self._live = {"pending": pending, "sched_off": sched_off,
                          "cursors": cursors, "splits": splits}

            def top_up(s: int) -> None:
                while len(pending[s]) < self._prefetch and sched_off[s] < self._split_len(s):
                    off = sched_off[s]
                    count = min(self._read_batch, self._split_len(s) - off)
                    pending[s].append((pool.submit(self._fetch_batch, s, off), count))
                    sched_off[s] += count

            for s in splits:
                top_up(s)

            active = [s for s in splits if self._consumed[s] < self._split_len(s)]
            while active:
                exhausted = []
                # the round-robin position is fully derivable from the
                # per-split counts: lagging splits are served first, so a
                # resumed stream continues exactly where it stopped
                minc = min(self._consumed[s] for s in active)
                for s in active:
                    if self._consumed[s] > minc and self._consumed[s] < self._split_len(s):
                        continue  # ahead in this pass; catch-up handled next pass
                    if not cursors[s]:
                        if pending[s]:
                            samples, _ = pending[s].pop(0)[0].result()
                            top_up(s)
                            cursors[s] = list(samples) if isinstance(samples, list) else [samples]
                        else:
                            exhausted.append(s)
                            continue
                    # round-robin: ONE sample per split per pass. Count
                    # BEFORE yielding: if the consumer abandons the
                    # iterator mid-epoch, the delivered sample must be in
                    # state_dict (generator suspends at the yield).
                    sample = cursors[s].pop(0)
                    self._consumed[s] += 1
                    self._yielded += 1
                    yield sample
                if exhausted:
                    active = [s for s in active if s not in exhausted]
        finally:
            self._live = None
            pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------- DataLoader-worker pickling
    def __getstate__(self) -> dict:
        """Pickle for multi-worker DataLoader (reference streaming.py:536):
        the live reader (thread lock, dataset handles) is replaced by the
        base table's reopen state + the permutation rows as Arrow data;
        a `connection_factory` keeps credentials out of the pickle."""
        from .permutation import _table_pickle_state

        state = self.__dict__.copy()
        state["_lock"] = None
        state["_live"] = None
        base = self._perm.base_table
        state["_perm"] = None
        state["_base_name"] = base.name
        state["_base_state"] = (
            None if self._connection_factory is not None
            else _table_pickle_state(base)
        )
        perm_tbl = getattr(self._perm, "perm_table", None)
        state["_perm_data"] = (
            None if perm_tbl is None else (
                perm_tbl.to_arrow(),
                dict(perm_tbl.schema.metadata or {}),
            )
        )
        return state

    def __setstate__(self, state: dict) -> None:
        from .permutation import (PermutationReader, _table_from_pickle_state)

        base_name = state.pop("_base_name")
        base_state = state.pop("_base_state")
        perm_data = state.pop("_perm_data")
        self.__dict__.update(state)
        self._lock = threading.Lock()
        if self._connection_factory is not None:
            base = self._connection_factory(base_name)
        else:
            base = _table_from_pickle_state(base_state)
        if perm_data is None:
            self._perm = _IdentityReader(base)
        else:
            import uuid

            from ..db import connect

            data, meta = perm_data
            if meta:
                data = data.replace_schema_metadata(meta)
            db = connect(f"memory://sds-unpickle-{uuid.uuid4().hex}", device=str(base._device))
            self._perm = PermutationReader(
                db.create_table("permutation", data), base
            )
        win = getattr(self, "_window", None)
        if win is not None:
            self._perm = _WindowedReader(self._perm, *win)

    def __len__(self) -> int:
        return sum(self._split_len(s) for s in self._my_splits())
