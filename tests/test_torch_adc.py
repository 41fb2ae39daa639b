"""The ADC probe scan (B1): the port's plain version against the
reference's Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py runs it, and the CUDA kernel against the
plain version where a card is present.

Tolerance: rtol 1e-5 and atol 1e-4 x max|finite output| (the kernels sum
the S LUT entries in other orders); entries >= 1.5e38 (padding and
penalties) must sit at the same positions.

On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_adc.py``
(this module imports JAX only inside the CPU cases, and the repository's
conftest.py imports JAX, which the card's machine does not have).
"""

import numpy as np
import pytest
import torch

from lancedb_tpu_torch.index.vector import VectorSearcher, SearchParams
from lancedb_tpu_torch.ops import adc

PAD = np.float32(3.0e38)


def _case(K, S, P=6, PMAX=256, DSUB=2, Q=4, NP=3, seed=0):
    """Seeded inputs with padding slots, penalty slots (some overflowing
    to inf on top of padding) and a repeated probe id per query."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, (P, S, PMAX), dtype=np.uint8)
    codebooks = rng.standard_normal((S - 2, K, DSUB)).astype(np.float32)
    q = rng.standard_normal((Q, (S - 2) * DSUB)).astype(np.float32)
    dlut = adc.build_dlut_padded(q, codebooks, S)  # 2 zero LUT rows of padding
    rnorms = (rng.random((P, PMAX)) * 50).astype(np.float32)
    rnorms[:, PMAX - 40 :] = PAD
    with np.errstate(over="ignore"):  # padding + penalty overflows to inf, as on the device
        rnorms = rnorms + np.where(rng.random((P, PMAX)) < 0.1, PAD, np.float32(0.0))
    probe_ids = np.stack([rng.choice(P, NP, replace=False) for _ in range(Q)]).astype(np.int32)
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


@pytest.mark.parametrize("K,S", [(16, 16), (256, 8)])
def test_reference_matches_pallas_interpret(K, S):
    import jax.numpy as jnp

    from lancedb_tpu.ops.pallas_adc import ivf_pq_adc_scan_pallas

    args = _case(K, S)
    want = ivf_pq_adc_scan_pallas(*map(jnp.asarray, args), interpret=True)
    got = adc.ivf_pq_adc_scan_reference(*map(torch.from_numpy, args))
    _assert_adc_close(got.numpy(), want)
    # on CPU tensors the wrapper is the plain version, and counts no launch
    before = adc.launch_counts["ivf_pq_adc_scan"]
    _assert_adc_close(adc.ivf_pq_adc_scan(*map(torch.from_numpy, args)).numpy(), want)
    assert adc.launch_counts["ivf_pq_adc_scan"] == before


def test_layout_helpers_match_reference():
    from lancedb_tpu.ops import pallas_adc as jadc

    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, (3, 5, 100), dtype=np.uint8)
    np.testing.assert_array_equal(adc.pad_codes_for_pallas(codes), jadc.pad_codes_for_pallas(codes))
    q = rng.standard_normal((2, 10)).astype(np.float32)
    cb = rng.standard_normal((5, 16, 2)).astype(np.float32)
    np.testing.assert_allclose(adc.build_dlut_padded(q, cb, 8), jadc.build_dlut_padded(q, cb, 8),
                               rtol=1e-6)


def _arrays(K, S, metric, seed=2):
    """An IVF_PQ index as the reference's arrays, with one padded block."""
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
    meta = {"index_type": "IVF_PQ", "metric": metric, "dim": nsub * DSUB, "num_partitions": P,
            "num_logical_partitions": P, "pmax": PMAX, "num_sub_vectors": nsub, "num_bits":
            4 if K == 16 else 8}
    q = rng.standard_normal((5, nsub * DSUB)).astype(np.float32)
    penalty = np.where(rng.random(P * PMAX) < 0.2, PAD, np.float32(0.0)).astype(np.float32)
    return meta, arrays, q, penalty


@pytest.mark.parametrize("K,S", [(16, 16), (256, 8)])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_searcher_from_arrays_matches_reference_scan(K, S, metric):
    """VectorSearcher.from_arrays (no disk) scans like the reference's
    _ivf_pq_search_device_rt on the same arrays and penalty."""
    import jax.numpy as jnp

    from lancedb_tpu.index.vector import _ivf_pq_search_device_rt

    meta, arrays, q, penalty = _arrays(K, S, metric)
    s = VectorSearcher.from_arrays(meta, arrays, device="cpu")
    d, r = s.search(q, SearchParams(k=10, nprobes=3), slot_penalty=penalty)
    jv, js = _ivf_pq_search_device_rt(
        jnp.asarray(q), *(jnp.asarray(arrays[n]) for n in ("centroids", "codes", "rnorms",
                                                            "codebooks")),
        jnp.asarray(penalty), jnp.asarray(3, jnp.int32),
        k=10, np_max=8, metric=metric, has_mask=True,
    )
    jv, js = np.asarray(jv), np.asarray(js)
    want_r = np.where(jv >= PAD / 2, np.uint64(2**64 - 1), arrays["row_ids"].reshape(-1)[js]
                      .astype(np.uint64))
    np.testing.assert_array_equal(r, want_r)
    fin = jv < PAD / 2
    np.testing.assert_allclose(d[fin], jv[fin], rtol=1e-5, atol=1e-5 * np.abs(jv[fin]).max())
    assert np.all(np.isinf(d[~fin]))


@pytest.mark.cuda
@pytest.mark.parametrize("K,S", [(16, 32), (256, 16)])
def test_cuda_kernel_matches_plain_version(K, S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ADC kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in _case(K, S, P=64, PMAX=1152, Q=16, NP=20)]
    before = adc.launch_counts["ivf_pq_adc_scan"]
    got = adc.ivf_pq_adc_scan(*args)
    torch.cuda.synchronize()
    assert adc.launch_counts["ivf_pq_adc_scan"] == before + 1
    _assert_adc_close(got.cpu().numpy(), adc.ivf_pq_adc_scan_reference(*args).cpu().numpy())
    with pytest.raises(TypeError):
        adc.ivf_pq_adc_scan(args[0].long(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("PMAX", [1000, 1090])
@pytest.mark.parametrize("K,S", [(256, 16), (16, 32), (256, 8), (16, 48)])
def test_cuda_kernel_matches_plain_version_at_ragged_pmax(K, S, PMAX):
    """pmax a multiple of 4 but not of the kernel's 16-slot loads (1000),
    and of neither (1090); 300 queries of 7 probes, so each query's probes
    split into chunks of 2 with a shorter last one; padding slots, +3e38
    penalties and inf where the two meet."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ADC kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in _case(K, S, P=64, PMAX=PMAX, Q=300, NP=7, seed=S)]
    assert bool(torch.isinf(args[3]).any()) and bool((args[3] == PAD).any())
    got = adc.ivf_pq_adc_scan(*args)
    _assert_adc_close(got.cpu().numpy(), adc.ivf_pq_adc_scan_reference(*args).cpu().numpy())
