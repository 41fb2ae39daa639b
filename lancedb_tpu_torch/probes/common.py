"""What the probes and ``chip_smoke.py`` share: the reference bench's
data generator, the card's identity, CUDA-event timing and the
comparison of a kernel with its plain version."""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

ROUNDS = 3  # timed runs of loop_ms, after one warm-up run
SLEEP_CYCLES = 2_000_000  # device_ms's spin kernel before each call, about 1 ms
FLUSH_BYTES = 128 << 20  # cuda_ms_cold's write before each call, above the card's 50 MB L2


def make_clustered(rng, n, dim, n_coarse=4096, n_parents=65_536, n_queries=256):
    """Hierarchical clustered data + queries near existing parents: the
    generator of the reference's bench.py, so recall means the same."""
    spectrum = (np.arange(dim) + 1.0) ** -0.5
    spectrum = (spectrum / np.linalg.norm(spectrum) * np.sqrt(dim)).astype(np.float32)
    coarse = rng.standard_normal((n_coarse, dim)).astype(np.float32)
    parents = coarse[rng.integers(0, n_coarse, n_parents)] + 0.45 * rng.standard_normal(
        (n_parents, dim)
    ).astype(np.float32)
    pa_ = rng.integers(0, n_parents, n)
    x = (parents[pa_] + 0.18 * rng.standard_normal((n, dim)).astype(np.float32)) * spectrum
    qp = rng.integers(0, n_parents, n_queries)
    q = (parents[qp] + 0.18 * rng.standard_normal((n_queries, dim)).astype(np.float32)) * spectrum
    return x.astype(np.float32), q.astype(np.float32)


def require_cuda() -> torch.device:
    """The card; a probe measures on it or not at all."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time the CUDA card and there is none")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, before=None) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after a warm-up.
    ``before``, if given, runs before each call, outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """``cuda_ms`` with each call behind a spin kernel of SLEEP_CYCLES
    that keeps the card busy while the host enqueues the call: the card's
    time for the call, without the host's launch overhead that
    ``cuda_ms`` includes."""
    return cuda_ms(fn, reps, before=lambda: torch.cuda._sleep(SLEEP_CYCLES))


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """``cuda_ms`` with a write of FLUSH_BYTES before each call, so the
    call finds none of its inputs in L2."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return cuda_ms(fn, reps, before=lambda: flush.fill_(1.0))


def loop_ms(fns) -> float:
    """ms per call of a run of calls (``fns``, each called once in turn),
    timed with CUDA events around the whole run: the best of ROUNDS
    after a warm-up run, as the reference's probes time a scan of
    iterations."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(ROUNDS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for fn in fns:
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / len(fns))
    return best


def compare(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """Entries >= 1.5e38 (padding, penalties, inf) at the same positions,
    the rest within rtol 1e-5 + atol 1e-4 x max|finite|: the kernels may
    sum in another order than the plain versions. Returns max|err|."""
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    big_got, big_want = got >= 1.5e38, want >= 1.5e38
    if not torch.equal(big_got, big_want):
        raise AssertionError(f"{label}: padded/penalized entries differ in position")
    fin = ~big_want
    g, w = got[fin], want[fin]
    max_abs = float((g - w).abs().max()) if g.numel() else 0.0
    atol = 1e-4 * float(w.abs().max()) if w.numel() else 0.0
    if not torch.allclose(g, w, rtol=1e-5, atol=atol):
        raise AssertionError(f"{label}: kernel disagrees with plain version, max|err|={max_abs}")
    return max_abs


def print_records(name: str, records) -> None:
    """One JSON line per record, then the card's line."""
    for rec in records:
        print(f"[{name}] {json.dumps(rec)}", flush=True)
    print(f"card (nvidia-smi name, power.limit): {card_line()}", flush=True)
