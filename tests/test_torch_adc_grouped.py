"""The grouped ADC probe scan (B3) and the probe kernels (S1, S2): the
port's plain versions against the reference's Pallas kernel in interpret
mode and against the numpy oracles of the reference's scripts, the
grouped route against the same composition in the reference, and the
CUDA kernels against their plain versions where a card is present.

Tolerance: rtol 1e-5 and atol 1e-4 x max|finite output| (XLA sums the
one-hot product and the gathered LUT entries in its own order); entries
>= 1.5e38 (padding and penalties) must sit at the same positions.

On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_adc_grouped.py``
(this module imports JAX only inside the CPU cases).
"""

import numpy as np
import pytest
import torch

from lancedb_tpu_torch.index.vector import VectorSearcher
from lancedb_tpu_torch.ops import adc, probe_kernels
from lancedb_tpu_torch.probes import ab_adc8, ab_gather_min, probe_adc_grouped, probe_pq_real

PAD = np.float32(3.0e38)


def _case(K, S, P=6, PMAX=256, Q=10, NP=3, repeat=True, seed=0):
    """Seeded B3 inputs with padding slots, penalty slots (some
    overflowing to inf on top of padding) and, with ``repeat``, a
    repeated probe id per query."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, (P, S, PMAX), dtype=np.uint8)
    dlut = rng.standard_normal((Q, S, K)).astype(np.float32)
    rnorms = (rng.random((P, PMAX)) * 50).astype(np.float32)
    rnorms[:, PMAX - 40 :] = PAD
    with np.errstate(over="ignore"):  # padding + penalty overflows to inf, as on the device
        rnorms = rnorms + np.where(rng.random((P, PMAX)) < 0.1, PAD, np.float32(0.0))
    probe_ids = np.stack([rng.choice(P, NP, replace=False) for _ in range(Q)]).astype(np.int32)
    if repeat:
        probe_ids[:, 1] = probe_ids[:, 0]
    qc = rng.standard_normal((Q, NP)).astype(np.float32)
    qn2 = (rng.random(Q) * 100).astype(np.float32)
    return probe_ids, dlut, codes, rnorms.astype(np.float32), qc, qn2


def _assert_adc_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got >= 1.5e38, want >= 1.5e38)
    fin = want < 1.5e38
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-4 * float(np.abs(want[fin]).max()))


@pytest.mark.parametrize("K,S,qpc,shape", [
    (16, 16, 8, {}),                                        # one-hot cell: bf16 LUT
    (256, 8, 8, {}),                                        # gather cell: f32 LUT
    (256, 8, 16, {}),
    (16, 16, 8, {"P": 3, "Q": 8, "NP": 3, "repeat": False}),  # every query shares every partition
], ids=["K16-qpc8", "K256-qpc8", "K256-qpc16", "shared-partitions"])
def test_grouped_matches_pallas_interpret(K, S, qpc, shape):
    import jax.numpy as jnp

    from lancedb_tpu.ops.pallas_adc import ivf_pq_adc_grouped_scan_pallas

    args = _case(K, S, **shape)
    want = np.asarray(ivf_pq_adc_grouped_scan_pallas(*map(jnp.asarray, args), qpc=qpc,
                                                     interpret=True))
    assert np.isinf(want).any() and (want >= 1.5e38).any() and (want < 1.5e38).any()
    _assert_adc_close(adc.ivf_pq_adc_grouped_scan_reference(*map(torch.from_numpy, args)), want)
    # on CPU tensors the wrapper is the plain version, and counts no launch
    before = adc.launch_counts["ivf_pq_adc_grouped_scan"]
    got = adc.ivf_pq_adc_grouped_scan(*map(torch.from_numpy, args), qpc=qpc)
    _assert_adc_close(got.numpy(), want)
    assert adc.launch_counts["ivf_pq_adc_grouped_scan"] == before


def test_grouped_small_codebook_sums_the_bf16_lut():
    """K <= 64: B3 is not B1 grouped. It equals the bf16-LUT formula
    (qn2 − 2·qc) − 2·Σ_s bf16(dlut[s, code]) + rnorms summed in f32, and
    differs from B1; at K = 256 both keep the LUT in f32."""
    probe_ids, dlut, codes, rnorms, qc, qn2 = args = _case(16, 16)
    got = adc.ivf_pq_adc_grouped_scan_reference(*map(torch.from_numpy, args)).numpy()
    lut = torch.from_numpy(dlut).bfloat16().float().numpy()
    acc = np.zeros(probe_ids.shape + (codes.shape[2],), np.float32)
    for s in range(codes.shape[1]):
        cs = codes[probe_ids, s].astype(np.int64)  # (Q, NP, pmax)
        acc = acc + np.take_along_axis(lut[:, s][:, None, :], cs, axis=2)
    with np.errstate(over="ignore"):
        want = ((qn2[:, None] - 2.0 * qc)[..., None] - 2.0 * acc) + rnorms[probe_ids]
    np.testing.assert_array_equal(got, want)
    fin = want < 1.5e38
    b1 = adc.ivf_pq_adc_scan_reference(*map(torch.from_numpy, args)).numpy()
    assert np.abs(b1[fin] - got[fin]).max() > 1e-3
    args8 = _case(256, 8)
    _assert_adc_close(adc.ivf_pq_adc_grouped_scan_reference(*map(torch.from_numpy, args8)),
                      adc.ivf_pq_adc_scan_reference(*map(torch.from_numpy, args8)))


# (K, S, qpc, case shape): qpc 1 / 8 / 16 / 32 at K 16 / 64 / 256; the
# qpc-32 cases put every query on one partition (a group of 32 and more)
EDGE_CASES = [
    (16, 16, 1, {}),
    (16, 32, 32, {"P": 4, "Q": 36, "NP": 3, "hot": True}),
    (64, 8, 8, {}),
    (64, 16, 16, {"P": 4, "Q": 20, "NP": 3, "hot": True}),
    (256, 8, 1, {}),
    (256, 8, 32, {"P": 4, "Q": 36, "NP": 3, "hot": True}),
    (256, 16, 8, {"PMAX": 2176, "Q": 4, "NP": 2}),  # three unequal code tiles on the card
]


def _edge_case(K, S, hot=False, **shape):
    """``_case`` inputs; with ``hot`` every query also probes partition 0
    in column 2, so its groups fill at any qpc."""
    args = _case(K, S, **shape)
    if hot:
        args[0][:, 2] = 0
    return args


@pytest.mark.parametrize("K,S,qpc,shape", EDGE_CASES,
                         ids=[f"K{k}-S{s}-qpc{q}" for k, s, q, _ in EDGE_CASES])
def test_grouped_edges_match_pallas_interpret(K, S, qpc, shape):
    """The plain version against the Pallas kernel in interpret mode at
    the edges the card's kernel handles: qpc 1 to 32, K 16 / 64 (bf16
    LUT) and 256 (f32), partitions probed by more queries than a group
    holds, repeated probes, padding and penalties (inf where they meet)."""
    import jax.numpy as jnp

    from lancedb_tpu.ops.pallas_adc import ivf_pq_adc_grouped_scan_pallas

    args = _edge_case(K, S, **shape)
    want = np.asarray(ivf_pq_adc_grouped_scan_pallas(*map(jnp.asarray, args), qpc=qpc,
                                                     interpret=True))
    assert np.isinf(want).any() and (want >= 1.5e38).any() and (want < 1.5e38).any()
    got = adc.ivf_pq_adc_grouped_scan(*map(torch.from_numpy, args), qpc=qpc)
    _assert_adc_close(got.numpy(), want)


H100_SMEM = 232_448  # shared memory one block may opt into on an H100


@pytest.mark.parametrize("S,K,qpc,pmax,want", [
    (16, 256, 8, 1152, {"ts": 1152, "lpc": 4, "smem": 2 * 16 * 1152 + 4 * 16384}),
    (16, 256, 16, 1152, {"ts": 1152, "lpc": 4, "smem": 2 * 16 * 1152 + 4 * 16384}),
    (32, 16, 8, 1152, {"ts": 576, "lpc": 8, "smem": 2 * 32 * 576 + 8 * 1024}),
    (32, 16, 32, 2176, {"ts": 736, "lpc": 32, "smem": 2 * 32 * 736 + 32 * 1024}),
    (192, 16, 32, 300, {"ts": 160, "lpc": 8, "smem": 2 * 192 * 160 + 8 * 6144}),
    (96, 256, 8, 128, {"ts": 128, "lpc": 2, "smem": 2 * 96 * 128 + 2 * 98304}),
    (8, 256, 8, 8192, {"ts": 4096, "lpc": 6, "smem": 2 * 8 * 4096 + 6 * 8192}),
], ids=["8bit-qpc8", "8bit-qpc16", "4bit-qpc8", "4bit-ragged", "S192-pmax300", "S96-one-block",
        "pmax8192"])
def test_grouped_geometry(S, K, qpc, pmax, want):
    """The launch geometry the wrapper computes: code tiles of a multiple
    of 16 slots that cover pmax in as few equal-sized tiles as fit
    GROUPED_CODE_STAGE, and as many LUTs a pass as leave room for two blocks on an SM (bf16 entries
    for K <= 64), or as one block holds where two do not fit (S 96, K
    256), all within the card's limit."""
    geo = adc.grouped_geometry(S, K, qpc, pmax, H100_SMEM)
    assert geo == want
    ts = geo["ts"]
    ntiles = -(-pmax // ts)
    assert ts % 16 == 0 and (ntiles - 1) * ts < pmax <= ntiles * ts
    assert S * ts <= adc.GROUPED_CODE_STAGE or ts == 16
    assert geo["smem"] + adc.GROUPED_STATIC_SMEM <= H100_SMEM
    with pytest.raises(ValueError, match="one LUT"):
        adc.grouped_geometry(S, K, qpc, pmax, 2 * S * ts + adc.GROUPED_STATIC_SMEM + 100)


@pytest.mark.parametrize("qpc", [1, 8, 16, 32])
def test_plan_puts_padding_groups_last(qpc):
    """What the kernel's walk relies on: in every plan the groups with a
    live pair come first, and each group's live slots first, so a block
    stops at its first group of padding only. Random probes, repeated
    probes and one partition probed by every query."""
    from lancedb_tpu_torch.ops.util import grouped_plan

    probe_ids = _edge_case(16, 8, P=9, Q=40, NP=4, hot=True, seed=qpc)[0]
    gpid, pos, g = grouped_plan(torch.from_numpy(probe_ids), 9, qpc)
    live = pos.numpy().reshape(g, qpc) >= 0
    first = live[:, 0]
    assert not np.any(first[1:] & ~first[:-1])  # live groups are a prefix
    assert np.all(live[:, 1:] <= live[:, :-1])  # live slots are a prefix
    if qpc > 1:
        assert first.sum() < g  # the bound leaves groups of padding only
    assert live.sum() == probe_ids.size


def _ivfpq_arrays(K=16, S=16, seed=2):
    """A small l2 IVF_PQ index as the reference's arrays, padded slots
    included."""
    rng = np.random.default_rng(seed)
    P, PMAX, DSUB = 8, 128, 2
    nsub = S - 2
    arrays = {
        "centroids": rng.standard_normal((P, nsub * DSUB)).astype(np.float32),
        "codes": rng.integers(0, K, (P, S, PMAX), dtype=np.uint8),
        "codebooks": rng.standard_normal((nsub, K, DSUB)).astype(np.float32),
        "rnorms": (rng.random((P, PMAX)) * 30).astype(np.float32),
        "row_ids": np.arange(P * PMAX, dtype=np.int64).reshape(P, PMAX),
    }
    arrays["codes"][:, nsub:] = 0
    arrays["rnorms"][:, 100:] = PAD
    arrays["row_ids"][:, 100:] = -1
    meta = {"index_type": "IVF_PQ", "metric": "l2", "dim": nsub * DSUB, "num_partitions": P,
            "num_logical_partitions": P, "pmax": PMAX, "num_sub_vectors": nsub,
            "num_bits": 4 if K == 16 else 8}
    q = rng.standard_normal((12, nsub * DSUB)).astype(np.float32)
    return meta, arrays, q


def test_grouped_route_matches_reference_composition():
    """probe_pq_real.full_grouped against the reference's route of
    scripts/probe_pq_real.py: _select_probes → _pq_dlut → B3 (interpret)
    → top-k, on the same arrays."""
    import jax.numpy as jnp

    from lancedb_tpu.index.vector import _pq_dlut, _select_probes
    from lancedb_tpu.ops.pallas_adc import ivf_pq_adc_grouped_scan_pallas
    from lancedb_tpu.ops.topk import approx_topk_smallest

    meta, arrays, q = _ivfpq_arrays()
    searcher = VectorSearcher.from_arrays(meta, arrays, device="cpu")
    vals, slots = probe_pq_real.full_grouped(searcher, torch.from_numpy(q), qpc=8, nprobes=3)
    assert searcher._block_nprobes(3) == 3

    qj = jnp.asarray(q)
    probe_ids, probe_dots = _select_probes(qj, jnp.asarray(arrays["centroids"]), 3, "l2")
    dlut = _pq_dlut(qj, jnp.asarray(arrays["codebooks"]), arrays["codes"].shape[1])
    dists = ivf_pq_adc_grouped_scan_pallas(
        probe_ids.astype(jnp.int32), dlut, jnp.asarray(arrays["codes"]),
        jnp.asarray(arrays["rnorms"]), probe_dots, jnp.sum(jnp.square(qj), axis=-1), qpc=8,
        interpret=True,
    )
    jv, pos = approx_topk_smallest(dists.reshape(q.shape[0], -1), 10)
    pos, pmax = np.asarray(pos), meta["pmax"]
    want_slots = np.take_along_axis(np.asarray(probe_ids), pos // pmax, axis=1) * pmax + pos % pmax
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    # the per-pair route (B1) finds nearly the same candidates
    assert probe_pq_real.overlap(probe_pq_real.per_pair(searcher, torch.from_numpy(q),
                                                        nprobes=3)[1], slots) > 0.8
    cos = VectorSearcher.from_arrays({**meta, "metric": "cosine"}, arrays, device="cpu")
    with pytest.raises(ValueError, match="l2 IVF_PQ"):
        probe_pq_real.full_grouped(cos, torch.from_numpy(q))


@pytest.mark.parametrize("K,S", [(256, 16), (16, 32)])
def test_adc_sum_matches_script_oracle(K, S):
    """S1's plain version, and the CPU wrapper of both designs, against
    scripts/ab_adc8.py's numpy check, for every cell."""
    rng = np.random.default_rng(3)
    dlut, codes = ab_adc8.make_inputs(rng, S, K, q=4, p=5, pmax=300)
    ncells = 4 * 3
    want = np.stack([dlut[c % 4][np.arange(S)[:, None], codes[c % 5].astype(int)].sum(0)
                     for c in range(ncells)])
    d_t, c_t = torch.from_numpy(dlut), torch.from_numpy(codes)
    got = probe_kernels.adc_sum_reference(d_t, c_t, ncells, max_chunk_bytes=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ab_adc8.cell_error(got.numpy(), dlut, codes, c0=7) < 1e-5
    before = dict(probe_kernels.launch_counts)
    for design in probe_kernels.ADC_SUM_DESIGNS:
        np.testing.assert_array_equal(probe_kernels.adc_sum(d_t, c_t, ncells, design), got)
    assert probe_kernels.launch_counts == before
    with pytest.raises(ValueError, match="design"):
        probe_kernels.adc_sum(d_t, c_t, ncells, "onehot")


def test_smem_gather_matches_script_oracle():
    """S2's plain version (and CPU wrapper) against numpy's
    take_along_axis at the eight shapes of scripts/ab_gather_min.py."""
    assert len(ab_gather_min.SHAPES) == 8
    for (s, w), axis in ab_gather_min.SHAPES:
        x, idx = ab_gather_min.make_inputs(s, w, axis)
        want = np.take_along_axis(x, idx, axis=axis)
        got = probe_kernels.smem_gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="axis"):
        probe_kernels.smem_gather(torch.from_numpy(x), torch.from_numpy(idx), 2)


def test_onehot_baseline_and_clustered_probes():
    """The probe's one-hot einsum baseline is B1's formula on the
    bf16-rounded LUT; its probes come in groups of 8 queries near one
    center."""
    rng = np.random.default_rng(4)
    args = probe_adc_grouped.make_inputs(rng, 8, 16, "cpu", p=40, pmax=128, q=16, np_=5)
    probe_ids = args[0].numpy()
    for g in range(2):
        rows = probe_ids[g * 8 : (g + 1) * 8]
        assert len(np.unique(rows)) <= 64 and all(len(set(r)) == 5 for r in rows)
    got = probe_adc_grouped.onehot_scan(*args, max_chunk_bytes=1)
    lut_bf16 = args[1].bfloat16().float()
    want = adc.ivf_pq_adc_scan_reference(args[0], lut_bf16, *args[2:])
    _assert_adc_close(got.numpy(), want.numpy())


def test_probes_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes run there")
    for probe in (ab_gather_min, ab_adc8, probe_adc_grouped, probe_pq_real):
        with pytest.raises(RuntimeError, match="CUDA card"):
            probe.run()


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("qpc", [8, 16])
@pytest.mark.parametrize("K,S", [(16, 32), (256, 16)])
def test_cuda_grouped_kernel_matches_plain_version(K, S, qpc):
    _cuda_or_skip()
    args = [torch.from_numpy(a).cuda() for a in _case(K, S, P=64, PMAX=1152, Q=16, NP=20)]
    before = adc.launch_counts["ivf_pq_adc_grouped_scan"]
    got = adc.ivf_pq_adc_grouped_scan(*args, qpc=qpc)
    torch.cuda.synchronize()
    assert adc.launch_counts["ivf_pq_adc_grouped_scan"] == before + 1
    _assert_adc_close(got.cpu().numpy(),
                      adc.ivf_pq_adc_grouped_scan_reference(*args).cpu().numpy())
    with pytest.raises(TypeError):
        adc.ivf_pq_adc_grouped_scan(args[0].long(), *args[1:], qpc=qpc)


@pytest.mark.cuda
@pytest.mark.parametrize("pmax", [300, 2176])
@pytest.mark.parametrize("qpc", [1, 8, 16, 32])
@pytest.mark.parametrize("K,S", [(16, 32), (64, 16), (256, 16)])
def test_cuda_grouped_kernel_at_edges(K, S, qpc, pmax):
    """B3 against its plain version at qpc 1 to 32, K 16 / 64 / 256, pmax
    300 (no 16-byte copies, one float a store) and 2176 (three unequal
    code tiles), a partition probed by all 40 queries (more than a group
    holds, and passes of LUTs at qpc 32), repeated probes, padding and
    penalties, one at inf on a real slot."""
    _cuda_or_skip()
    args = _edge_case(K, S, P=24, PMAX=pmax, Q=40, NP=6, hot=True, seed=qpc)
    args[3][:, 5] = np.inf
    t = [torch.from_numpy(a).cuda() for a in args]
    before = adc.launch_counts["ivf_pq_adc_grouped_scan"]
    got = adc.ivf_pq_adc_grouped_scan(*t, qpc=qpc)
    torch.cuda.synchronize()
    assert adc.launch_counts["ivf_pq_adc_grouped_scan"] == before + 1
    _assert_adc_close(got.cpu().numpy(), adc.ivf_pq_adc_grouped_scan_reference(*t).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,qpc,pmax", [(16, 256, 8, 1152), (16, 256, 16, 1152),
                                          (32, 16, 8, 1152), (192, 16, 32, 300)])
def test_cuda_grouped_geometry_matches_the_library(S, K, qpc, pmax):
    """The wrapper's shared-memory arithmetic is the kernel's: the
    library's count of the dynamic bytes for the same geometry, its static
    bytes, and the card's limit."""
    import ctypes

    from lancedb_tpu_torch.ops.cuda_build import load, max_smem_bytes, static_smem_bytes

    _cuda_or_skip()
    geo = adc.grouped_geometry(S, K, qpc, pmax, max_smem_bytes())
    fn = load("adc_grouped_scan").adc_grouped_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    assert fn(S, K, geo["lpc"], geo["ts"], int(K <= adc.SELECT_MAX_K)) == geo["smem"]
    assert static_smem_bytes("adc_grouped_scan") == adc.GROUPED_STATIC_SMEM
    assert geo["smem"] + adc.GROUPED_STATIC_SMEM <= max_smem_bytes()


@pytest.mark.cuda
def test_cuda_probe_kernels_match_plain_versions():
    _cuda_or_skip()
    rng = np.random.default_rng(5)
    for s, k in ((16, 256), (32, 16)):
        dlut, codes = (torch.from_numpy(a).cuda()
                       for a in ab_adc8.make_inputs(rng, s, k, q=16, p=50, pmax=1280))
        want = probe_kernels.adc_sum_reference(dlut, codes, 100)
        for design in probe_kernels.ADC_SUM_DESIGNS:
            _assert_adc_close(probe_kernels.adc_sum(dlut, codes, 100, design).cpu().numpy(),
                              want.cpu().numpy())
    for (s, w), axis in ab_gather_min.SHAPES:
        x, idx = (torch.from_numpy(a).cuda() for a in ab_gather_min.make_inputs(s, w, axis))
        assert torch.equal(probe_kernels.smem_gather(x, idx, axis),
                           probe_kernels.smem_gather_reference(x, idx, axis))
