"""S2, the shared-memory table gather (``csrc/smem_gather.cu``, the port of
``scripts/ab_gather_min.py``'s Pallas kernel): its launch geometry
(``smem_gather_geometry``, pure Python, the same the kernel computes in
C) at the script's eight shapes and the probe's edge shapes, its plain
version against numpy's take_along_axis, and, on the card, the kernel
against ``torch.take_along_dim`` bit for bit with one launch counted a
call. The function moves floats and adds none, so every comparison is
exact.

This module does not import JAX. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_smem_gather.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from lancedb_tpu_torch.ops import probe_kernels
from lancedb_tpu_torch.ops.probe_kernels import smem_gather_geometry
from lancedb_tpu_torch.probes import ab_gather_min

H100_SMEM = 232_448  # shared memory a block may opt into
ALL_SHAPES = [(sw, axis, 0) for sw, axis in ab_gather_min.SHAPES] + list(ab_gather_min.EDGE_SHAPES)
IDS = [f"{s}x{w}-axis{axis}-off{off}" for (s, w), axis, off in ALL_SHAPES]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("s,w,axis,want", [
    # the script's shapes: a warp a row of 128, 4 warps a row of 512; axis 0
    # in strips of 32 columns and chunks of 64 output rows
    (8, 128, 1, {"threads": 32, "tile": 128, "grid": (8, 1), "tiles": 1, "smem": 512,
                 "staged": True}),
    (16, 512, 1, {"threads": 128, "tile": 512, "grid": (16, 1), "tiles": 1, "smem": 2048,
                  "staged": True}),
    (256, 128, 0, {"threads": 256, "tile": 64, "grid": (4, 4), "tiles": 4, "smem": 32768,
                   "staged": True}),
    # several column tiles a row; a row that fits no block's shared memory
    (4, 5000, 1, {"threads": 256, "tile": 1024, "grid": (4, 5), "tiles": 5, "smem": 20000,
                  "staged": True}),
    (2, 65536, 1, {"threads": 256, "tile": 1024, "grid": (2, 64), "tiles": 64, "smem": 0,
                   "staged": False}),
    # the largest strip that is staged, and the first that is not
    (1816, 64, 0, {"threads": 256, "tile": 64, "grid": (29, 2), "tiles": 2, "smem": 232448,
                   "staged": True}),
    (1817, 64, 0, {"threads": 256, "tile": 64, "grid": (29, 2), "tiles": 2, "smem": 0,
                   "staged": False}),
    # more strips than a grid dimension holds: a block walks two
    (1, 2_100_000, 0, {"threads": 256, "tile": 64, "grid": (1, 65535), "tiles": 65625,
                       "smem": 128, "staged": True}),
], ids=["8x128", "16x512", "256x128-axis0", "tiles", "row-beyond-smem", "strip-at-limit",
        "strip-beyond-smem", "grid-y-walk"])
def test_smem_gather_geometry_values(s, w, axis, want):
    assert smem_gather_geometry(s, w, axis, H100_SMEM) == want


@pytest.mark.parametrize("sw,axis,offset", ALL_SHAPES, ids=IDS)
def test_smem_gather_geometry_covers_each_output_once(sw, axis, offset):
    """Every output is written by exactly one block, each block reads only
    its own row (axis 1) or its strip's 32 columns (axis 0), and what a
    block stages fits the card's shared memory."""
    s, w = sw
    g = smem_gather_geometry(s, w, axis, H100_SMEM)
    gx, gy = g["grid"]
    assert 1 <= gy <= probe_kernels.GRID_Y_MAX and g["threads"] % 32 == 0
    assert g["threads"] <= 32 * max(probe_kernels.SMEM_GATHER_ROW_WARPS,
                                    probe_kernels.SMEM_GATHER_STRIP_WARPS)
    assert g["smem"] <= H100_SMEM and g["staged"] == (g["smem"] > 0)
    # block column y walks tiles y, y + gy, ...: each tile has one owner
    owners = np.zeros(g["tiles"], np.int64)
    for y in range(gy):
        owners[y::gy] += 1
    assert (owners == 1).all()
    if axis == 1:
        # block (i, y) writes row i, columns [c * tile, (c + 1) * tile) of its tiles c
        assert gx == s and g["tile"] == 4 * g["threads"]
        assert (g["tiles"] - 1) * g["tile"] < w <= g["tiles"] * g["tile"]
        assert g["staged"] == (4 * w <= H100_SMEM) and g["smem"] in (0, 4 * w)
    else:
        # block (r, y) writes rows [r * tile, (r + 1) * tile) of its strips'
        # columns [32c, 32c + 32) and stages (or reads) those columns only
        cols = probe_kernels.SMEM_GATHER_STRIP_COLS
        assert g["tile"] == probe_kernels.SMEM_GATHER_STRIP_WARPS * probe_kernels.SMEM_GATHER_WARP_ROWS
        assert g["threads"] == 32 * probe_kernels.SMEM_GATHER_STRIP_WARPS
        assert (gx - 1) * g["tile"] < s <= gx * g["tile"]
        assert (g["tiles"] - 1) * cols < w <= g["tiles"] * cols
        assert g["staged"] == (4 * cols * s <= H100_SMEM) and g["smem"] in (0, 4 * cols * s)


@pytest.mark.parametrize("sw,axis,offset", ALL_SHAPES, ids=IDS)
def test_smem_gather_plain_matches_numpy(sw, axis, offset):
    """The plain version, and the wrapper on CPU tensors at the same odd
    address the card test uses, against numpy's take_along_axis."""
    x, idx = ab_gather_min.make_inputs(*sw, axis)
    want = np.take_along_axis(x, idx, axis=axis)
    x_t, idx_t = ab_gather_min.at_offset(x, "cpu", offset), ab_gather_min.at_offset(idx, "cpu", offset)
    before = dict(probe_kernels.launch_counts)
    np.testing.assert_array_equal(probe_kernels.smem_gather_reference(x_t, idx_t, axis).numpy(), want)
    np.testing.assert_array_equal(probe_kernels.smem_gather(x_t, idx_t, axis).numpy(), want)
    assert probe_kernels.launch_counts == before  # the CPU launches nothing


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_smem_gather_bit_equal_and_counted():
    """The kernel against take_along_dim at every script and edge shape,
    one launch counted a call; its C geometry equal to the Python one."""
    _cuda_or_skip()
    from lancedb_tpu_torch.ops.cuda_build import load, max_smem_bytes

    fn = load("smem_gather").smem_gather_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    limit = max_smem_bytes()
    for (s, w), axis, offset in ALL_SHAPES:
        x, idx = ab_gather_min.make_inputs(s, w, axis)
        x_d = ab_gather_min.at_offset(x, "cuda", offset)
        idx_d = ab_gather_min.at_offset(idx, "cuda", offset)
        before = probe_kernels.launch_counts["smem_gather"]
        got = probe_kernels.smem_gather(x_d, idx_d, axis)
        assert probe_kernels.launch_counts["smem_gather"] == before + 1
        assert torch.equal(got, probe_kernels.smem_gather_reference(x_d, idx_d, axis)), (s, w, axis)
        out = (ctypes.c_int * 7)()
        fn(s, w, axis, limit, out)
        g = smem_gather_geometry(s, w, axis, limit)
        assert list(out) == [g["threads"], g["tile"], *g["grid"], g["tiles"], g["smem"],
                             int(g["staged"])]
    torch.cuda.synchronize()
    probe_kernels.launch_floor(torch.device("cuda"))
    torch.cuda.synchronize()
