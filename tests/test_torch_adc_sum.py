"""S1, the ADC scan's LUT sum (``ops/probe_kernels.py`` ``adc_sum``),
against the reference's own kernel bodies, and the launch geometry of its
CUDA kernel (``csrc/adc_sum_ab.cu``).

``scripts/ab_adc8.py`` asserts a TPU when it is imported, so its
``make_select`` and ``make_gather`` (with the constants they read) are
lifted out of its source with ``ast`` and run through ``pl.pallas_call``
in interpret mode, with the script's BlockSpecs. Tolerance: rtol 1e-5,
atol 1e-5 (XLA sums the select's one-hot products in its own order; the
gather sums in subvector order as the port does).

The kernel itself runs only on the card:
``tests/test_torch_adc_grouped.py::test_cuda_probe_kernels_match_plain_versions``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from lancedb_tpu_torch.ops import probe_kernels
from lancedb_tpu_torch.probes import ab_adc8

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "ab_adc8.py"
H100_SMEM, H100_SMS = 232_448, 132  # shared memory a block may opt into, SMs


def _script_kernels() -> dict:
    """make_select, make_gather and the constants they read (PB, LANES),
    executed from the script's source without running the script."""
    import jax
    import jax.numpy as jnp

    tree = ast.parse(SCRIPT.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in ("make_select", "make_gather"))
            or (isinstance(n, ast.Assign) and {"PB", "LANES"} & {
                e.id for t in n.targets for e in ast.walk(t) if isinstance(e, ast.Name)})]
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"), ns)  # noqa: S102
    return ns


def _script_run(ns: dict, design: str, dlut: np.ndarray, codes: np.ndarray, ncells: int):
    """The script's ``run`` without its timing: its pallas_call (grid,
    BlockSpecs, output shape) in interpret mode → (ncells, pmax). The
    gather takes the script's LUT split into 128-lane tables."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    q, s, k = dlut.shape
    p, _, pmax = codes.shape
    pb, lanes = ns["PB"], ns["LANES"]
    if design == "select":
        kern, lut = ns["make_select"](s, k), dlut
    else:
        nt = max(1, k // lanes)
        lut = np.zeros((q, nt, s, lanes), np.float32)
        for t in range(nt):
            w = min(lanes, k - t * lanes)
            lut[:, t, :, :w] = dlut[:, :, t * lanes : t * lanes + w]
        kern = ns["make_gather"](s, k)
    f = pl.pallas_call(
        kern,
        grid=(ncells, pmax // pb),
        in_specs=[
            pl.BlockSpec((1,) + lut.shape[1:], lambda c, b: (c % q,) + (0,) * (lut.ndim - 1)),
            pl.BlockSpec((1, s, pb), lambda c, b: (c % p, 0, b)),
        ],
        out_specs=pl.BlockSpec((1, 1, pb), lambda c, b: (c, 0, b)),
        out_shape=jax.ShapeDtypeStruct((ncells, 1, pmax), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(lut), jnp.asarray(codes)))[:, 0]


@pytest.mark.parametrize("design", probe_kernels.ADC_SUM_DESIGNS)
@pytest.mark.parametrize("bits,S,K", [(8, 16, 256), (4, 32, 16)], ids=["8bit", "4bit"])
def test_adc_sum_matches_script_kernels(bits, S, K, design):
    """The plain version and the CPU wrapper of both designs against the
    script's kernel of ``design`` (Q 4, P 5, pmax 512, 12 cells: every
    query and partition over more than one cell, two slot blocks)."""
    ns = _script_kernels()
    rng = np.random.default_rng(bits)
    dlut, codes = ab_adc8.make_inputs(rng, S, K, q=4, p=5, pmax=512)
    want = _script_run(ns, design, dlut, codes, 12)
    d_t, c_t = torch.from_numpy(dlut), torch.from_numpy(codes)
    plain = probe_kernels.adc_sum_reference(d_t, c_t, 12)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
    before = dict(probe_kernels.launch_counts)
    for port_design in probe_kernels.ADC_SUM_DESIGNS:
        got = probe_kernels.adc_sum(d_t, c_t, 12, port_design)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert probe_kernels.launch_counts == before  # the CPU launches nothing


UNIT = 16 * 128  # a block's 8 warps x 2 stages x 128 slots, bytes a subvector


@pytest.mark.parametrize("q,S,K,ncells,pmax,want", [
    # the probe's inputs: 4 blocks an SM at 8 bits, 3 at 4 bits (shared
    # memory), each query's 200 units split over 4 or 3 blocks, one wave
    (128, 16, 256, 2560, 1280, {"units": 50, "blocks": 512, "staged": True,
                                "smem": 16 * UNIT + 16 * 256 * 4}),
    (128, 32, 16, 2560, 1280, {"units": 67, "blocks": 384, "staged": True,
                               "smem": 32 * UNIT + 32 * 16 * 4}),
    # ragged pmax, ncells not a multiple of Q: a unit a block
    (5, 16, 48, 23, 1283, {"units": 1, "blocks": 275, "staged": True,
                           "smem": 16 * UNIT + 16 * 48 * 4}),
    (128, 32, 256, 2560, 1280, {"units": 100, "blocks": 256, "staged": True,
                                "smem": 32 * UNIT + 32 * 256 * 4}),
    # many cells a query: query 1's last block has no unit
    (2, 32, 256, 2001, 1283, {"units": 84, "blocks": 264, "staged": True,
                              "smem": 32 * UNIT + 32 * 256 * 4}),
    (128, 16, 256, 50, 1280, {"units": 1, "blocks": 500, "staged": True,
                              "smem": 16 * UNIT + 16 * 256 * 4}),
    # the LUT leaves no room for the stages
    (3, 200, 256, 10, 1280, {"units": 1, "blocks": 120, "staged": False,
                             "smem": 200 * 256 * 4}),
    (3, 227, 256, 10, 255, {"units": 1, "blocks": 24, "staged": False, "smem": 227 * 256 * 4}),
], ids=["8bit", "4bit", "ragged", "K256-S32", "many-cells", "few-cells", "big-lut",
        "no-stage"])
def test_adc_sum_geometry(q, S, K, ncells, pmax, want):
    """The launch geometry the kernel computes (and the wrapper mirrors):
    the stages where they fit; one wave of blocks (at most
    ADC_SUM_BLOCKS_PER_SM an SM, as shared memory allows); each block over
    a run of one query's (cell, 128-slot tile) units, every unit of every
    query in one block."""
    geo = probe_kernels.adc_sum_geometry(q, S, K, ncells, pmax, H100_SMEM, H100_SMS)
    assert geo == want
    assert geo["smem"] <= H100_SMEM
    per_sm = min(probe_kernels.ADC_SUM_BLOCKS_PER_SM,
                 (H100_SMEM + 1024) // (geo["smem"] + 1024))
    queries = min(q, ncells)
    if queries <= per_sm * H100_SMS:
        assert geo["blocks"] <= per_sm * H100_SMS  # one wave
    # block x sums units u of query x % queries, u in [x // queries * units, + units)
    ntiles = -(-pmax // probe_kernels.ADC_SUM_UNIT_SLOTS)
    owner = {}
    for x in range(geo["blocks"]):
        qq, b = x % queries, x // queries
        for u in range(b * geo["units"], (b + 1) * geo["units"]):
            c = qq + q * (u // ntiles)
            if c < ncells:
                assert (c, u % ntiles) not in owner
                owner[(c, u % ntiles)] = x
    assert sorted(owner) == [(c, t) for c in range(ncells) for t in range(ntiles)]
