"""The shared-memory table gather at the shapes of the reference's
scripts/ab_gather_min.py (S2), on the card: its port.

    python -m lancedb_tpu_torch.probes.ab_gather_min

The script asks which (s, w) f32 shapes Mosaic's in-kernel
take_along_axis accepts on the TPU. On this card the question is whether
the gather from a table staged in shared memory is right at each shape
and what it costs. For each shape it reports OK (the kernel equals
numpy's take_along_axis), the error, the kernel's time and the time of
torch.take_along_dim on the same inputs. A shape that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.probe_kernels import smem_gather, smem_gather_reference
from .common import cuda_ms, print_records, require_cuda

# ((s, w), axis), in the script's order
SHAPES = tuple(((s, w), 1) for s, w in ((8, 128), (8, 256), (8, 512), (16, 128), (16, 512),
                                        (32, 128))) + (((8, 128), 0), ((256, 128), 0))


def make_inputs(s: int, w: int, axis: int):
    """The script's inputs for one shape, as numpy: (x (s, w) f32,
    idx (s, w) int32 in range along ``axis``)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((s, w)).astype(np.float32)
    idx = rng.integers(0, (w if axis == 1 else s), (s, w)).astype(np.int32)
    return x, idx


def run() -> list[dict]:
    """Every shape on the card; one record per shape."""
    dev = require_cuda()
    records = []
    for (s, w), axis in SHAPES:
        x, idx = make_inputs(s, w, axis)
        x_d, idx_d = torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)
        got = smem_gather(x_d, idx_d, axis).cpu().numpy()
        err = float(np.abs(got - np.take_along_axis(x, idx, axis=axis)).max())
        if err != 0.0:
            raise AssertionError(f"S2 shape=({s},{w}) axis={axis}: err={err}")
        records.append({
            "shape": [s, w], "axis": axis, "ok": True, "err": err,
            "ms": cuda_ms(lambda: smem_gather(x_d, idx_d, axis)),
            "take_along_dim_ms": cuda_ms(lambda: smem_gather_reference(x_d, idx_d, axis)),
        })
    return records


if __name__ == "__main__":
    print_records("ab_gather_min", run())
