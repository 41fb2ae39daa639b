"""The IVF_FLAT probe scans, grouped (B2) and per pair (B4): the port's
plain version against the reference's Pallas kernels in interpret mode,
as tests/test_pallas_kernels.py runs them; the port's pair grouping
(``group_probe_pairs``, ``grouped_plan_reference``) against the
reference's, element for element; and where a card is present the CUDA
kernels against the plain version, and the plan kernel
(``csrc/group_plan.cu``) against ``grouped_plan_reference`` element for
element (an integer layout: no tolerance).

Tolerance: rtol 1e-5 and atol 1e-4 x max|finite output| (the kernels sum
the D products in other orders than the plain product); entries >= 1.5e38
(padding and penalties, inf where two meet) must sit at the same
positions.

On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_flat_scan.py``
(this module imports JAX only inside the CPU cases).
"""

import numpy as np
import pytest
import torch

from lancedb_tpu_torch.ops import flat_scan
from lancedb_tpu_torch.ops.cuda_build import launch_counts
from lancedb_tpu_torch.ops.util import (
    MAX_QPC, group_probe_pairs, grouped_plan, grouped_plan_reference,
)

PAD = np.float32(3.0e38)


def _case(metric="l2", P=6, PMAX=16, D=128, Q=5, NP=3, same_probes=False, seed=11):
    """Seeded scan inputs in ``metric``'s (alpha, gamma, norms) form, with
    padding rows, penalty slots (inf where they meet padding) and a
    repeated probe id per query."""
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((P, PMAX, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    if metric == "cosine":
        vectors /= np.linalg.norm(vectors, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if same_probes:  # every query probes the same partitions: full groups
        probe_ids = np.tile(rng.choice(P, NP, replace=False), (Q, 1)).astype(np.int32)
    else:
        probe_ids = np.stack([rng.choice(P, NP, replace=False) for _ in range(Q)]).astype(np.int32)
        probe_ids[:, 1] = probe_ids[:, 0]
    pad = np.zeros((P, PMAX), np.float32)
    pad[:, PMAX - 3 :] = PAD
    if metric == "l2":
        alpha = np.full(Q, -2.0, np.float32)
        gamma = (q**2).sum(1).astype(np.float32)
        norms = (vectors**2).sum(2).astype(np.float32) + pad
    else:
        alpha = (-1.0 / np.linalg.norm(q, axis=1) if metric == "cosine"
                 else np.full(Q, -1.0)).astype(np.float32)
        gamma = np.full(Q, 1.0 if metric == "cosine" else 0.0, np.float32)
        norms = pad
    with np.errstate(over="ignore"):  # padding + penalty overflows to inf, as on the device
        norms = norms + np.where(rng.random((P, PMAX)) < 0.1, PAD, np.float32(0.0))
    return probe_ids, q, vectors, norms.astype(np.float32), alpha, gamma


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got >= 1.5e38, want >= 1.5e38)
    fin = want < 1.5e38
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-4 * float(np.abs(want[fin]).max()))


def _probes(Q, NP, P, hot=False, seed=0):
    """Seeded (Q, NP) int32 probe ids: distinct per query, with a repeated
    probe in column 1; with ``hot``, every query also probes partition
    P // 2 in column 2, so it holds more than MAX_QPC pairs when Q does."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(P, NP, replace=False) for _ in range(Q)]).astype(np.int32)
    ids[:, 1] = ids[:, 0]
    if hot:
        ids[:, 2] = P // 2
    return ids


def _pallas(kernel, args, bf16=False, **kw):
    import jax.numpy as jnp

    from lancedb_tpu.ops.pallas_group_scan import ivf_flat_grouped_scan_pallas
    from lancedb_tpu.ops.pallas_scan import ivf_flat_scan_pallas

    fn = ivf_flat_grouped_scan_pallas if kernel == "grouped" else ivf_flat_scan_pallas
    probe_ids, q, vectors, norms, alpha, gamma = map(jnp.asarray, args)
    if bf16:
        vectors = vectors.astype(jnp.bfloat16)
    return np.asarray(fn(probe_ids, q, vectors, norms, alpha, gamma, interpret=True, **kw))


def _plain(args, bf16=False):
    t = [torch.from_numpy(a) for a in args]
    if bf16:
        t[2] = t[2].to(torch.bfloat16)
    return flat_scan.ivf_flat_scan_reference(*t).numpy()


@pytest.mark.parametrize("kernel", ["grouped", "pair"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_plain_matches_pallas_interpret(kernel, metric):
    args = _case(metric)
    _assert_close(_plain(args), _pallas(kernel, args))


@pytest.mark.parametrize("kernel", ["grouped", "pair"])
def test_bfloat16_storage_matches_pallas_interpret(kernel):
    """bf16 rows widen to f32 in both: the same values, the same sums."""
    args = _case("l2", seed=3)
    _assert_close(_plain(args, bf16=True), _pallas(kernel, args, bf16=True))


@pytest.mark.parametrize("same_probes", [False, True])
def test_group_padding_does_not_leak(same_probes):
    """qpc=4 with uneven probe runs (and full groups when every query
    probes the same partitions): padded group slots reach no output."""
    args = _case("l2", Q=7, NP=3, same_probes=same_probes, seed=5)
    _assert_close(_plain(args), _pallas("grouped", args, qpc=4))


# (metric, bf16, case shape): pmax 200 and 72 (unequal row tiles on the
# card), every query on one partition twice (a repeated probe in every
# pair), bf16 storage
PAIR_EDGES = [
    ("l2", False, {"PMAX": 200}),
    ("cosine", True, {"PMAX": 200, "NP": 4}),
    ("dot", True, {"PMAX": 72, "Q": 9}),
    ("l2", False, {"PMAX": 72, "Q": 6, "NP": 4, "same_probes": True}),
]


@pytest.mark.parametrize("metric,bf16,shape", PAIR_EDGES,
                         ids=["l2-pmax200", "cosine-bf16", "dot-bf16-pmax72", "l2-repeated"])
def test_pair_edges_match_pallas_interpret(metric, bf16, shape):
    """The plain version (and the wrapper on CPU tensors) against the
    per-pair Pallas kernel in interpret mode at the edges of the card's
    kernel: row tiles that do not divide pmax, bf16 storage, repeated
    probes, padding and penalties (inf where they meet)."""
    args = list(_case(metric, **shape))
    if shape.get("same_probes"):
        args[0][:, 1] = args[0][:, 0]
    args[3][:, 1] = np.inf  # a penalty at inf on a real slot of every block
    want = _pallas("pair", args, bf16=bf16)
    assert np.isinf(want).any() and (want < 1.5e38).any()
    _assert_close(_plain(args, bf16=bf16), want)


@pytest.mark.parametrize("D,esize,want", [
    (128, 4, {"pitch": 512, "lanes": 8, "cpl": 4, "tile_rows": 64, "npb": 2, "smem": 65536}),
    (128, 2, {"pitch": 256, "lanes": 8, "cpl": 4, "tile_rows": 128, "npb": 2, "smem": 65536}),
    (37, 4, {"pitch": 160, "lanes": 8, "cpl": 4, "tile_rows": 192, "npb": 2, "smem": 61440}),
    (480, 4, {"pitch": 1920, "lanes": 32, "cpl": 4, "tile_rows": 16, "npb": 2, "smem": 61440}),
    (1536, 4, {"pitch": 6144, "lanes": 32, "cpl": 16, "tile_rows": 8, "npb": 3, "smem": 98304}),
], ids=["f32-D128", "bf16-D128", "f32-D37", "f32-D480", "f32-D1536"])
def test_pair_geometry(D, esize, want):
    """The per-pair kernel's launch geometry at the IVF_FLAT path's
    shapes (128 queries, 27 probes, pmax 1224, 132 SMs): rows padded to
    16 bytes, lanes x chunks covering a row, stages of about PAIR_STAGE
    bytes in whole passes of the block's warps, and a grid of about
    PAIR_WAVES waves."""
    geo = flat_scan.pair_geometry(128, 27, 1224, D, esize, 132)
    assert geo == want
    assert geo["pitch"] // 16 <= geo["lanes"] * geo["cpl"]
    assert geo["tile_rows"] % (8 * 32 // geo["lanes"]) == 0
    assert geo["smem"] == 2 * geo["tile_rows"] * geo["pitch"]
    # few pairs: one probe a block; a tiny block: one stage covers it
    assert flat_scan.pair_geometry(4, 3, 1224, D, esize, 132)["npb"] == 1
    assert flat_scan.pair_geometry(4, 3, 5, D, esize, 132)["tile_rows"] == 8 * 32 // want["lanes"]
    with pytest.raises(ValueError, match="exceed"):
        flat_scan.pair_geometry(4, 3, 10, 8192 // esize + 1, esize, 132)


@pytest.mark.parametrize("qpc", [4, 8])
@pytest.mark.parametrize("same_probes", [False, True])
def test_group_probe_pairs_matches_reference(qpc, same_probes):
    import jax.numpy as jnp

    from lancedb_tpu.ops.util import group_probe_pairs as ref_group

    probe_ids = _case(Q=9, NP=4, P=7, same_probes=same_probes, seed=qpc)[0]
    got = group_probe_pairs(torch.from_numpy(probe_ids), 7, qpc)
    want = ref_group(jnp.asarray(probe_ids), 7, qpc)
    assert got[4:] == tuple(want[4:])  # g, spad
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("qpc", [1, MAX_QPC])
def test_reference_matches_group_probe_pairs_on_a_hot_partition(qpc):
    import jax.numpy as jnp

    from lancedb_tpu.ops.util import group_probe_pairs as ref_group

    P = 11
    probe_ids = _probes(40, 4, P, hot=True, seed=qpc)
    assert np.sum(probe_ids == P // 2) > MAX_QPC
    ref = ref_group(jnp.asarray(probe_ids), P, qpc)
    gpid, slot, order = np.asarray(ref[0]), np.asarray(ref[2]), np.asarray(ref[3])
    want = np.full(gpid.size * qpc, -1, np.int32)
    want[slot] = order
    for got in (grouped_plan_reference(torch.from_numpy(probe_ids), P, qpc),
                grouped_plan(torch.from_numpy(probe_ids), P, qpc)):  # the CPU takes the reference
        assert got[2] == gpid.size
        np.testing.assert_array_equal(got[0].numpy(), gpid)
        np.testing.assert_array_equal(got[1].numpy(), want)


def test_grouped_plan_is_what_the_kernel_needs():
    """Each (query, probe) pair sits in exactly one slot, of a group whose
    partition is the pair's probe, slots fill each group front first (the
    kernel skips a group whose first slot is padding), and computing the
    groups as the kernel does gives the plain version's output."""
    probe_ids, q, vectors, norms, alpha, gamma = args = _case("l2", Q=7, NP=3, seed=5)
    P, PMAX, _ = vectors.shape
    gpid, pair_of_slot, g = grouped_plan(torch.from_numpy(probe_ids), P, 4)
    gpid, pos = gpid.numpy(), pair_of_slot.numpy().reshape(g, 4)
    real = pos[pos >= 0]
    np.testing.assert_array_equal(np.sort(real), np.arange(probe_ids.size))
    for grp in range(g):
        live = pos[grp] >= 0
        assert not np.any(live[1:] & ~live[:-1])
        assert np.all(probe_ids.reshape(-1)[pos[grp][live]] == gpid[grp])
    out = np.full((probe_ids.size, PMAX), np.nan, np.float32)
    with np.errstate(over="ignore"):
        for grp in range(g):
            for pair in pos[grp][pos[grp] >= 0]:
                qi = pair // probe_ids.shape[1]
                dots = vectors[gpid[grp]] @ q[qi]
                out[pair] = alpha[qi] * dots + norms[gpid[grp]] + gamma[qi]
    _assert_close(out.reshape(probe_ids.shape + (PMAX,)), _plain(args))


# (Q, NP, P, hot, qpc): random probes; a partition probed by every query;
# P far above Q x NP (counters in shared memory above 48 KB, and in global
# scratch); a padded layout too large for shared memory
PLAN_CASES = [
    (33, 9, 40, False, 1), (33, 9, 40, False, 8), (33, 9, 40, False, 32),
    (70, 5, 40, True, 1), (70, 5, 40, True, 32),
    (4, 3, 5_000, False, 8), (8, 4, 20_000, False, 8), (8, 4, 100_000, False, 32),
    (128, 200, 1402, False, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,NP,P,hot,qpc", PLAN_CASES)
def test_cuda_plan_matches_reference(Q, NP, P, hot, qpc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plan kernel has no CPU mode")
    probe_ids = torch.from_numpy(_probes(Q, NP, P, hot=hot, seed=Q + P)).cuda()
    before = launch_counts["group_plan"]
    got = grouped_plan(probe_ids, P, qpc)
    torch.cuda.synchronize()
    assert launch_counts["group_plan"] == before + 1
    want = grouped_plan_reference(probe_ids, P, qpc)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    with pytest.raises(TypeError):
        grouped_plan(probe_ids.long(), P, qpc)


def test_wrappers_on_cpu_use_the_plain_version():
    t = [torch.from_numpy(a) for a in _case("dot")]
    before = dict(launch_counts)
    want = flat_scan.ivf_flat_scan_reference(*t)
    for fn in (flat_scan.ivf_flat_grouped_scan, flat_scan.ivf_flat_scan):
        assert torch.equal(fn(*t), want)
    assert launch_counts == before  # no kernel launched, none counted


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["grouped", "pair"])
def test_cuda_kernel_matches_plain_version(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat scan kernels have no CPU mode")
    t = [torch.from_numpy(a).cuda() for a in _case("l2", P=40, PMAX=200, D=96, Q=33, NP=9)]
    t[2] = t[2].to(dtype)
    name, fn = (("ivf_flat_grouped_scan", flat_scan.ivf_flat_grouped_scan) if kind == "grouped"
                else ("ivf_flat_scan", flat_scan.ivf_flat_scan))
    before = launch_counts[name]
    got = fn(*t)
    torch.cuda.synchronize()
    assert launch_counts[name] == before + 1
    _assert_close(got.cpu().numpy(), flat_scan.ivf_flat_scan_reference(*t).cpu().numpy())
    with pytest.raises(TypeError):
        fn(t[0].long(), *t[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("qpc", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 128, 200, 37])
def test_cuda_grouped_kernel_at_widths_and_group_sizes(D, dtype, qpc):
    """B2 at D 96, 128 and 200 (16-byte copies) and 37 (plain loads), f32
    and bf16 storage, qpc 1, 8 and 32; pmax 300 (a full 256-slot tile and
    a partial one) and one partition probed by all 40 queries, more than
    a group of 32 holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat scan kernels have no CPU mode")
    args = list(_case("l2", P=40, PMAX=300, D=D, Q=40, NP=9, seed=D))
    args[0][:, 2] = 7
    t = [torch.from_numpy(a).cuda() for a in args]
    t[2] = t[2].to(dtype)
    got = flat_scan.ivf_flat_grouped_scan(*t, qpc=qpc)
    _assert_close(got.cpu().numpy(), flat_scan.ivf_flat_scan_reference(*t).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("pmax", [200, 1224])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [37, 96, 128, 200, 480, 1536])
def test_cuda_pair_kernel_at_edges(D, dtype, pmax):
    """B4 against the plain version at D 37 (rows staged by plain loads),
    96, 128, 200, 480 and 1536 (8, 16 and 32 lanes a row, 4 and 16 chunks
    a lane), f32 and bf16 storage, pmax 200 and 1224 (row tiles that do
    not divide it), a partition probed twice by every query, padding and
    penalties, one at inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat scan kernels have no CPU mode")
    args = list(_case("l2", P=12, PMAX=pmax, D=D, Q=11, NP=5, seed=D))
    args[0][:, 3] = args[0][:, 2] = 4
    args[3][:, 1] = np.inf
    t = [torch.from_numpy(a).cuda() for a in args]
    t[2] = t[2].to(dtype)
    before = launch_counts["ivf_flat_scan"]
    got = flat_scan.ivf_flat_scan(*t)
    torch.cuda.synchronize()
    assert launch_counts["ivf_flat_scan"] == before + 1
    _assert_close(got.cpu().numpy(), flat_scan.ivf_flat_scan_reference(*t).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("D,esize", [(128, 4), (128, 2), (37, 4), (1536, 4)])
def test_cuda_pair_geometry_matches_the_library(D, esize):
    import ctypes

    from lancedb_tpu_torch.ops.cuda_build import load, max_smem_bytes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat scan kernels have no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = flat_scan.pair_geometry(128, 27, 1224, D, esize, sms)
    fn = load("ivf_flat_scan").ivf_flat_scan_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    assert fn(geo["tile_rows"], geo["pitch"]) == geo["smem"] <= max_smem_bytes()
