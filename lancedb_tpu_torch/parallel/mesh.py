"""The device mesh: a (query, shard) grid of ``torch.device``s driven by
one process, or by several under torch.distributed.

Port of the reference's parallel/mesh.py. The reference is a single
controller: one process drives every device of a ``jax.sharding.Mesh``
through ``shard_map``. The counterpart here is a grid of devices that
one process loops over; a device may appear more than once, so
``["cpu"] * 8`` tests the sharding logic on the CPU (as the reference
tests on 8 virtual CPU devices) and ``["cuda:0"] * 4`` runs four shards
on one card. The collectives become host-ordered tensor operations:

* ``all_gather_cat``: each shard's output moved to one device and
  concatenated in shard order (``lax.all_gather(..., tiled=True)``);
* ``psum``: the partials summed on one device in shard order.

A placed array is a grid (a list of rows of tensors) with one tensor per
mesh cell, on that cell's device: ``shard_rows`` gives each cell its
block of rows, ``replicate`` the whole array.

Several processes (``make_process_mesh``, under a torch.distributed
group: parallel/distributed.py) form one global grid, as the reference's
processes see one global device list after ``jax.distributed``: rank 0's
devices first, then rank 1's, and so on. ``Mesh.owner`` says which rank
holds each cell; a rank places tensors only on its own cells and holds
``None`` for the others. ``all_gather_cells`` is the one cross-rank step:
the owned cells' tensors, one gather across ranks, and every cell's
tensor on every rank, so that ``all_gather_cat`` and ``psum`` over a row
then concatenate or add in global shard order on every rank. A sum in
that order, rather than an ``all_reduce``, gives the bits of a
one-process mesh of the same cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidInputError

SHARD_AXIS = "shard"  # database rows / IVF partitions
QUERY_AXIS = "query"  # query batch


class Mesh:
    """A (query, shard) grid of devices.

    ``devices`` is a (query_parallel, shard_n) object array of
    ``torch.device``; ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh``'s does. ``owner`` (same shape) is the rank that
    holds each cell and ``rank`` this process's; a one-process mesh owns
    every cell."""

    def __init__(self, grid, owner=None, rank: int = 0):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.shape = {QUERY_AXIS: len(rows), SHARD_AXIS: len(rows[0])}
        self.owner = (np.zeros(self.devices.shape, np.int64) if owner is None
                      else np.asarray(owner, np.int64).reshape(self.devices.shape))
        self.rank = rank
        self.process_count = int(self.owner.max()) + 1
        self.cells = [(i, j) for i in range(len(rows)) for j in range(len(rows[0]))
                      if self.owner[i, j] == rank]  # this rank's, in global order

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    def first(self, row: int = 0) -> torch.device:
        """The first device of a query row: where its shards' outputs meet.
        On a rank that does not hold that cell, this rank's first device."""
        if self.owner[row, 0] == self.rank:
            return self.devices[row, 0]
        return self.devices[self.cells[0]]

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in row] for row in self.devices]})"


def one_process_only(mesh: Mesh, what: str) -> None:
    """Refuse a mesh of several processes where ``what`` runs from one
    controller, as the reference's sharded IVF_PQ build and serving do:
    a rank must not wait in a collective the others never enter."""
    if mesh.multiprocess:
        raise InvalidInputError(f"{what} on a one-process mesh (make_mesh); this mesh spans "
                                f"{mesh.process_count} processes")


def _check_cuda(devs) -> None:
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError("the mesh names a CUDA device and none is available")


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() without devices spans every CUDA card and none is "
            "available; pass devices=['cpu', ...] to build a mesh on the CPU"
        )
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def make_mesh(num_devices: int | None = None, query_parallel: int = 1,
              devices=None) -> Mesh:
    """Build a (query, shard) mesh. ``devices=None`` means every CUDA card
    (and raises when there is none); a device may be named more than once."""
    if devices is None:
        devs = _cuda_devices()
    else:
        devs = [torch.device(d) for d in devices]
        _check_cuda(devs)
    n = num_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % query_parallel != 0:
        raise ValueError("query_parallel must divide device count")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(query_parallel, n // query_parallel).tolist())


def make_process_mesh(local_devices, query_parallel: int = 1) -> Mesh:
    """A mesh over every process of the torch.distributed group
    (parallel/distributed.py ``initialize``). Each rank names its own
    devices (``["cpu"] * 4``, ``["cuda:0"] * 2``), as many on every rank;
    the global grid lists rank 0's first, then rank 1's, and is cut into
    ``query_parallel`` rows, as ``jax.devices()`` orders a global device
    list. With no group up, the mesh of ``local_devices``."""
    import torch.distributed as dist

    from .distributed import process_count, process_index

    devs = [torch.device(d) for d in local_devices]
    if not devs:
        raise ValueError("a rank names at least one device")
    _check_cuda(devs)
    world = process_count()
    if world == 1:
        return make_mesh(devices=devs, query_parallel=query_parallel)
    names: list = [None] * world
    dist.all_gather_object(names, [str(d) for d in devs])
    counts = [len(n) for n in names]
    if len(set(counts)) != 1:
        raise ValueError(f"every rank names as many devices; the ranks name {counts}")
    flat = [d for n in names for d in n]
    if len(flat) % query_parallel != 0:
        raise ValueError("query_parallel must divide device count")
    sn = len(flat) // query_parallel
    owner = np.repeat(np.arange(world), len(devs)).reshape(query_parallel, sn)
    return Mesh([flat[i * sn:(i + 1) * sn] for i in range(query_parallel)], owner=owner,
                rank=process_index())


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a read-only memory map of an index file
        arr = arr.copy()
    return torch.from_numpy(arr)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; large host copies to the card go through pinned
    memory."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu" and t.nbytes >= (1 << 24):
        t = t.pin_memory()
    return t.to(device, non_blocking=device.type == "cuda")


def _block_of(mesh: Mesh, over):
    """(the number of blocks ``over`` splits an axis into, cell → its block)."""
    qp, sn = mesh.shape[QUERY_AXIS], mesh.shape[SHARD_AXIS]
    axes = (over,) if isinstance(over, str) else tuple(over)
    if axes == (SHARD_AXIS,):
        return sn, lambda i, j: j
    if axes == (QUERY_AXIS,):
        return qp, lambda i, j: i
    if axes == (QUERY_AXIS, SHARD_AXIS):
        return qp * sn, lambda i, j: i * sn + j
    raise ValueError(f"cannot shard over {over!r}")


def _owned_grid(mesh: Mesh, cell) -> list[list]:
    """``cell(i, j)`` on this rank's cells, None on the others'."""
    return [[cell(i, j) if mesh.owner[i, j] == mesh.rank else None
             for j in range(mesh.shape[SHARD_AXIS])] for i in range(mesh.shape[QUERY_AXIS])]


def _place_blocks(mesh: Mesh, arr, axis: int, over, rows: int, first_block: int = 0):
    """Each owned cell's block of ``rows`` along ``axis``, cut from
    ``arr``, which starts at block ``first_block``. Only the blocks this
    rank holds are read (an index file's memory map stays unread
    elsewhere)."""
    _, block = _block_of(mesh, over)
    cut: dict[int, torch.Tensor] = {}

    def cell(i: int, j: int) -> torch.Tensor:
        b = block(i, j) - first_block
        if b not in cut:
            idx = (slice(None),) * axis + (slice(b * rows, (b + 1) * rows),)
            cut[b] = _as_tensor(arr[idx]).contiguous()
        return _to(cut[b], mesh.devices[i, j])

    return _owned_grid(mesh, cell)


def shard_rows(mesh: Mesh, arr, axis: int = 0, over=SHARD_AXIS) -> list[list[torch.Tensor]]:
    """Place ``arr`` split along ``axis`` over the mesh axis ``over``
    (SHARD_AXIS, QUERY_AXIS, or both as (QUERY_AXIS, SHARD_AXIS), row
    major) and replicated over the other: one tensor per cell, on the
    cell's device. The axis must divide evenly, as a NamedSharding's must.
    On a mesh of several processes every rank passes the whole array (as
    the reference's ``device_put`` of one host array) and places its own
    cells' blocks."""
    if not isinstance(arr, (np.ndarray, torch.Tensor)):
        arr = np.asarray(arr)
    parts, _ = _block_of(mesh, over)
    size = arr.shape[axis]
    if size % parts:
        raise ValueError(f"axis {axis} of size {size} does not split over {parts} devices")
    return _place_blocks(mesh, arr, axis, over, size // parts)


def shard_local_rows(mesh: Mesh, local, global_shape, over=SHARD_AXIS) -> list[list[torch.Tensor]]:
    """Place this rank's rows of an array of ``global_shape`` split along
    axis 0 over ``over``, as ``jax.make_array_from_process_local_data``
    does: ``local`` holds exactly the run of blocks this rank's cells take
    (rows ``r·n/R`` to ``(r+1)·n/R`` when each rank holds a share of one
    row of the grid)."""
    global_shape = tuple(global_shape)
    parts, block = _block_of(mesh, over)
    if global_shape[0] % parts:
        raise ValueError(f"axis 0 of size {global_shape[0]} does not split over {parts} devices")
    rows = global_shape[0] // parts
    mine = sorted({block(i, j) for i, j in mesh.cells})
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"rank {mesh.rank}'s cells take blocks {mine}, not one run of rows")
    want = (len(mine) * rows, *global_shape[1:])
    if tuple(local.shape) != want:
        raise ValueError(f"rank {mesh.rank} holds rows of shape {tuple(local.shape)}; its "
                         f"cells of a {global_shape} array take {want}")
    return _place_blocks(mesh, local, 0, over, rows, first_block=mine[0])


def replicate(mesh: Mesh, arr) -> list[list[torch.Tensor]]:
    """Place the whole of ``arr`` on every cell of the mesh (this rank's
    cells on a mesh of several processes)."""
    t = _as_tensor(arr).contiguous()
    return _owned_grid(mesh, lambda i, j: _to(t, mesh.devices[i, j]))


def first_owned(grid) -> torch.Tensor:
    """The tensor of this rank's first cell of a placed grid. Blocks of
    one placement all have one shape, so its shape is every cell's."""
    return next(t for row in grid for t in row if t is not None)


def all_gather_cells(mesh: Mesh, grid) -> list[list[torch.Tensor]]:
    """Every cell's tensor on every rank: the owned cells' tensors (one
    shape and dtype on every cell), one gather across the ranks, then the
    grid in global order. Every rank calls it at the same point. The
    other ranks' tensors arrive on the host under gloo (on this rank's
    first device under NCCL); ``all_gather_cat`` and ``psum`` move them.
    On a one-process mesh the grid itself."""
    if not mesh.multiprocess:
        return grid
    from .distributed import all_gather_stacked

    home = mesh.devices[mesh.cells[0]]
    gathered = all_gather_stacked(torch.stack([_to(grid[i][j], home) for i, j in mesh.cells]))
    full = [list(row) for row in grid]
    for r in range(mesh.process_count):
        if r == mesh.rank:
            continue
        theirs = [(int(i), int(j)) for i, j in np.argwhere(mesh.owner == r)]
        for c, (i, j) in enumerate(theirs):
            full[i][j] = gathered[r, c]
    return full


def all_gather_cat(tensors, dim: int, device: torch.device) -> torch.Tensor:
    """The shards' outputs concatenated along ``dim`` on ``device``, in
    shard order (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat([_to(t, device) for t in tensors], dim=dim)


def psum(tensors, device: torch.device) -> torch.Tensor:
    """The sum of the partials on ``device``, added in shard order."""
    it = iter(tensors)
    total = _to(next(it), device).clone()
    for t in it:
        total += _to(t, device)
    return total


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, value=0):
    size = arr.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return arr, size
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - size)
    return np.pad(arr, widths, constant_values=value), size
