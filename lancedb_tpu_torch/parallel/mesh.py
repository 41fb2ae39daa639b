"""The device mesh: a (query, shard) grid of ``torch.device``s driven by
one process.

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
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_AXIS = "shard"  # database rows / IVF partitions
QUERY_AXIS = "query"  # query batch


class Mesh:
    """A (query, shard) grid of devices.

    ``devices`` is a (query_parallel, shard_n) object array of
    ``torch.device``; ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh``'s does."""

    def __init__(self, grid):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.shape = {QUERY_AXIS: len(rows), SHARD_AXIS: len(rows[0])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def first(self, row: int = 0) -> torch.device:
        """The first device of a query row: where its shards' outputs meet."""
        return self.devices[row, 0]

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in row] for row in self.devices]})"


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
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError("the mesh names a CUDA device and none is available")
    n = num_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % query_parallel != 0:
        raise ValueError("query_parallel must divide device count")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(query_parallel, n // query_parallel).tolist())


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


def shard_rows(mesh: Mesh, arr, axis: int = 0, over=SHARD_AXIS) -> list[list[torch.Tensor]]:
    """Place ``arr`` split along ``axis`` over the mesh axis ``over``
    (SHARD_AXIS, QUERY_AXIS, or both as (QUERY_AXIS, SHARD_AXIS), row
    major) and replicated over the other: one tensor per cell, on the
    cell's device. The axis must divide evenly, as a NamedSharding's must."""
    t = _as_tensor(arr)
    qp, sn = mesh.shape[QUERY_AXIS], mesh.shape[SHARD_AXIS]
    axes = (over,) if isinstance(over, str) else tuple(over)
    parts = {(QUERY_AXIS,): qp, (SHARD_AXIS,): sn, (QUERY_AXIS, SHARD_AXIS): qp * sn}.get(axes)
    if parts is None:
        raise ValueError(f"cannot shard over {over!r}")
    if t.shape[axis] % parts:
        raise ValueError(f"axis {axis} of size {t.shape[axis]} does not split over {parts} devices")
    blocks = torch.tensor_split(t, parts, dim=axis)

    def block(i: int, j: int) -> torch.Tensor:
        if axes == (SHARD_AXIS,):
            return blocks[j]
        if axes == (QUERY_AXIS,):
            return blocks[i]
        return blocks[i * sn + j]

    return [[_to(block(i, j).contiguous(), mesh.devices[i, j]) for j in range(sn)]
            for i in range(qp)]


def replicate(mesh: Mesh, arr) -> list[list[torch.Tensor]]:
    """Place the whole of ``arr`` on every cell of the mesh."""
    t = _as_tensor(arr).contiguous()
    return [[_to(t, dev) for dev in row] for row in mesh.devices]


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
