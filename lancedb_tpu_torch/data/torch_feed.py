"""StreamingDataset → torch batches on a mesh's devices.

Port of the reference's data/jax_feed.py, whose ``JaxBatchFeeder``
assembles each global batch with ``jax.make_array_from_process_local_data``
over a mesh. Here:

* samples stream from the elastic StreamingDataset (fixed virtual splits,
  so checkpoints survive a change of world size);
* each process stacks its rows into numpy columns, then into pinned host
  tensors, copied ``non_blocking`` to its own cells' devices: row block
  i goes to the process's i-th device, the split
  ``NamedSharding(P("data"))`` gives; with one device a column is a plain
  tensor on it. Where the reference assembles one global ``jax.Array``
  from every process's rows, a rank here holds its own blocks: on a mesh
  of several processes (parallel/mesh.py ``make_process_mesh``), rank r's
  ``batch_size // world_size`` rows on rank r's cells;
* a background thread keeps ``prefetch`` placed batches ahead, so the
  host's Arrow → numpy work and the copies overlap the training step.

Resumability: ``state_dict()`` is the dataset's state as of the last batch
the caller received, so a feeder loaded from it yields the next batch of
the uninterrupted run. Under several processes the state is per rank:
each rank saves its own and resumes from it. (The reference passes the
dataset's live state through, which the prefetch thread may have moved
up to prefetch + 1 batches ahead.)
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..errors import InvalidInputError
from ..parallel.distributed import process_count


def _stack_column(values: list) -> np.ndarray:
    first = values[0]
    if isinstance(first, (list, tuple, np.ndarray)):
        # keep the dtype: token-id columns must stay integral (an f32 cast
        # would corrupt ids >= 2^24); floats keep their width
        arr = np.stack([np.asarray(v) for v in values])
        if arr.dtype.kind not in "biufc":
            raise InvalidInputError("ragged or non-numeric nested column in a torch feed")
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)  # device-friendly default
        return arr
    arr = np.asarray(values)
    if arr.dtype.kind not in "biufc":  # strings, objects: no tensor holds them
        raise InvalidInputError(
            "non-numeric column in a torch feed; select numeric/vector columns"
        )
    return arr


class TorchBatchFeeder:
    """Iterate fixed-size batches placed on a mesh's devices.

    dataset:    a StreamingDataset for THIS process (rank/world_size
                already set). Its transform must yield dict rows (the
                default transform does).
    batch_size: rows per GLOBAL batch. Each process contributes
                batch_size // world_size rows (the torch.distributed
                world), split evenly over its own cells' devices.
    mesh:       a parallel.Mesh whose devices this process holds, in grid
                order, take the row blocks (default: every CUDA card,
                make_mesh()).
    columns:    restrict/order the emitted columns.
    prefetch:   placed batches to keep ahead (background thread).
    drop_last:  drop the trailing partial batch (a training step wants
                one shape).

    A batch maps each column to a tensor on the one device, or to a list
    of one tensor per device (row block i on device i)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        mesh=None,
        columns: list[str] | None = None,
        prefetch: int = 2,
        drop_last: bool = True,
        transform: Callable[[dict], dict] | None = None,
    ):
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
        self._ds = dataset
        self._devices = [mesh.devices[c] for c in mesh.cells]  # this process's cells
        self._columns = columns
        self._prefetch = max(1, prefetch)
        self._drop_last = drop_last
        self._transform = transform
        n_proc = process_count()
        if batch_size % n_proc:
            raise InvalidInputError(
                f"batch_size {batch_size} must divide by process_count {n_proc}"
            )
        self._local_rows = batch_size // n_proc
        if self._local_rows % len(self._devices):
            raise InvalidInputError(
                f"batch_size {batch_size} does not shard evenly over the mesh"
            )
        self.batch_size = batch_size
        self._delivered: dict | None = None  # the dataset's state at the last batch out

    # ------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return self._delivered if self._delivered is not None else self._ds.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._ds.load_state_dict(state)
        self._delivered = None

    # ----------------------------------------------------------- iterate
    def _assemble(self, rows: list[dict]) -> dict[str, np.ndarray]:
        if self._transform is not None:
            rows = [self._transform(r) for r in rows]
        keys = self._columns or [k for k in rows[0] if not k.startswith("_")]
        return {k: _stack_column([r[k] for r in rows]) for k in keys}

    def _local_batches(self) -> Iterator[dict[str, np.ndarray]]:
        buf: list[dict] = []
        for row in self._ds:
            buf.append(row)
            if len(buf) == self._local_rows:
                yield self._assemble(buf)
                buf = []
        if buf and not self._drop_last:
            yield self._assemble(buf)

    def _place(self, col: np.ndarray):
        """One column → its row blocks on the devices, through pinned
        memory where a device is a card."""
        t = torch.from_numpy(np.ascontiguousarray(col))
        if any(d.type == "cuda" for d in self._devices):
            t = t.pin_memory()
        blocks = torch.tensor_split(t, len(self._devices))
        placed = [b.to(d, non_blocking=d.type == "cuda") for b, d in zip(blocks, self._devices)]
        return placed[0] if len(placed) == 1 else placed

    def __iter__(self) -> Iterator[dict[str, Any]]:
        if self._delivered is not None:
            # resume at the last batch handed out, not where prefetch stopped
            self._ds.load_state_dict(self._delivered)
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        done = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for local in self._local_batches():
                    # the dataset's generator is suspended just after this
                    # batch's last row: its state ends at this batch
                    state = self._ds.state_dict()
                    batch = {k: self._place(v) for k, v in local.items()}
                    if not _put((batch, state)):
                        return  # the consumer abandoned the iterator
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                # deliver the sentinel: block while the consumer drains,
                # give up if it abandoned the iterator (stop set)
                while True:
                    try:
                        q.put(done, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=produce, daemon=True, name="lancedb-torch-feed")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                batch, self._delivered = item
                yield batch
        finally:
            # early exit (break / islice / GeneratorExit): release the
            # producer so it does not stay parked on a full queue
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)

    def __len__(self) -> int:
        # batches = rows this process will see / local rows per batch
        n = len(self._ds)
        return n // self._local_rows if self._drop_last else -(-n // self._local_rows)
