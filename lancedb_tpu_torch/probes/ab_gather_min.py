"""The shared-memory table gather at the shapes of the reference's
scripts/ab_gather_min.py (S2), on the card: its port.

    python -m lancedb_tpu_torch.probes.ab_gather_min

The script asks which (s, w) f32 shapes Mosaic's in-kernel
take_along_axis accepts on the TPU. On this card the question is whether
the gather from a table staged in shared memory is right at each shape
and what it costs. For each shape it reports OK (the kernel equals
numpy's take_along_axis), the error, and the kernel's and
torch.take_along_dim's times on the same inputs: back to back (``ms``,
the host's launch included), on the card alone (``device_ms``, behind a
spin kernel) and cold (``cold_ms``, L2 flushed), beside the same times of
an empty kernel launched the same way (``launch_floor_*``), which no
launch can beat. ``check_edges`` then holds the kernel to take_along_dim
bit for bit at EDGE_SHAPES. A shape that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_build import max_smem_bytes
from ..ops.probe_kernels import (
    launch_floor,
    smem_gather,
    smem_gather_geometry,
    smem_gather_reference,
)
from .common import cuda_ms, cuda_ms_cold, device_ms, print_records, require_cuda

# ((s, w), axis), in the script's order
SHAPES = tuple(((s, w), 1) for s, w in ((8, 128), (8, 256), (8, 512), (16, 128), (16, 512),
                                        (32, 128))) + (((8, 128), 0), ((256, 128), 0))
# ((s, w), axis, offset): one row or column, widths that are not a multiple
# of 4 or 32, tables at an odd address (a view ``offset`` elements into its
# buffer), several column tiles a row, tables beyond the first design's
# shared memory (staged, then rows and strips that fit no block's shared
# memory) and more strips than a grid dimension holds
EDGE_SHAPES = (
    ((1, 128), 1, 0), ((1, 128), 0, 0), ((256, 1), 1, 0), ((256, 1), 0, 0), ((1, 1), 1, 0),
    ((1, 1), 0, 0), ((8, 129), 1, 0), ((8, 131), 0, 0), ((33, 131), 1, 0), ((100, 129), 0, 0),
    ((8, 128), 1, 1), ((8, 128), 0, 1), ((16, 512), 1, 1), ((65, 96), 0, 3),
    ((4, 5000), 1, 0), ((4, 5001), 1, 0), ((512, 512), 1, 0), ((1024, 256), 0, 0),
    ((2, 65536), 1, 0), ((3, 70001), 1, 1), ((4096, 64), 0, 0), ((1, 2_100_000), 0, 0),
    ((1, 2_100_000), 1, 0),
)


def make_inputs(s: int, w: int, axis: int):
    """The script's inputs for one shape, as numpy: (x (s, w) f32,
    idx (s, w) int32 in range along ``axis``)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((s, w)).astype(np.float32)
    idx = rng.integers(0, (w if axis == 1 else s), (s, w)).astype(np.int32)
    return x, idx


def at_offset(a: np.ndarray, device, offset: int) -> torch.Tensor:
    """``a`` on ``device`` as a contiguous view ``offset`` elements into a
    larger buffer (an address that is not 16-byte aligned when offset % 4
    is not 0)."""
    buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a[:0]).dtype, device=device)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


def run() -> list[dict]:
    """Every script shape on the card; one record per shape."""
    dev = require_cuda()
    limit = max_smem_bytes()
    floor = {"launch_floor_ms": cuda_ms(lambda: launch_floor(dev)),
             "launch_floor_device_ms": device_ms(lambda: launch_floor(dev)),
             "launch_floor_cold_ms": cuda_ms_cold(lambda: launch_floor(dev))}
    records = []
    for (s, w), axis in SHAPES:
        x, idx = make_inputs(s, w, axis)
        x_d, idx_d = torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)
        got = smem_gather(x_d, idx_d, axis).cpu().numpy()
        err = float(np.abs(got - np.take_along_axis(x, idx, axis=axis)).max())
        if err != 0.0:
            raise AssertionError(f"S2 shape=({s},{w}) axis={axis}: err={err}")

        def kernel():
            return smem_gather(x_d, idx_d, axis)

        def library():
            return smem_gather_reference(x_d, idx_d, axis)

        records.append({
            "shape": [s, w], "axis": axis, "ok": True, "err": err,
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel), "cold_ms": cuda_ms_cold(kernel),
            "take_along_dim_ms": cuda_ms(library), "take_along_dim_device_ms": device_ms(library),
            "take_along_dim_cold_ms": cuda_ms_cold(library), **floor,
            "geometry": smem_gather_geometry(s, w, axis, limit),
        })
    return records


def check_edges(device: torch.device) -> int:
    """The kernel against take_along_dim, bit for bit, at EDGE_SHAPES: one
    launch each. Returns the number of shapes; raises on a difference."""
    for (s, w), axis, offset in EDGE_SHAPES:
        x, idx = make_inputs(s, w, axis)
        x_d, idx_d = at_offset(x, device, offset), at_offset(idx, device, offset)
        got = smem_gather(x_d, idx_d, axis)
        if not torch.equal(got, smem_gather_reference(x_d, idx_d, axis)):
            raise AssertionError(f"S2 edge shape=({s},{w}) axis={axis} offset={offset}: the "
                                 "kernel differs from take_along_dim")
    return len(EDGE_SHAPES)


if __name__ == "__main__":
    recs = run()
    recs.append({"edge_cases": check_edges(require_cuda())})
    print_records("ab_gather_min", recs)
