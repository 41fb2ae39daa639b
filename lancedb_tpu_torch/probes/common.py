"""What the probes and ``chip_smoke.py`` share: the reference bench's
data generator, the card's identity, CUDA-event timing and the
comparison of a kernel with its plain version."""

from __future__ import annotations

import json
import subprocess
import threading

import numpy as np
import torch

ROUNDS = 3  # timed runs of loop_ms, after one warm-up run
SLEEP_CYCLES = 2_000_000  # device_ms's spin kernel before each call, about 1 ms
FLUSH_BYTES = 128 << 20  # cuda_ms_cold's write before each call, above the card's 50 MB L2


def clustered_hierarchy(rng, dim, n_coarse=4096, n_parents=65_536):
    """make_clustered's first draws: (the per-dimension spectrum, the
    parents, each a coarse centre plus 0.45 x normal noise)."""
    spectrum = (np.arange(dim) + 1.0) ** -0.5
    spectrum = (spectrum / np.linalg.norm(spectrum) * np.sqrt(dim)).astype(np.float32)
    coarse = rng.standard_normal((n_coarse, dim)).astype(np.float32)
    parents = coarse[rng.integers(0, n_coarse, n_parents)] + 0.45 * rng.standard_normal(
        (n_parents, dim)
    ).astype(np.float32)
    return spectrum, parents


def clustered_rows(rng, spectrum, parents, n):
    """n rows near random parents (0.18 x normal noise), scaled by the spectrum."""
    p = rng.integers(0, len(parents), n)
    return (parents[p] + 0.18 * rng.standard_normal((n, len(spectrum))).astype(np.float32)
            ) * spectrum


def make_clustered(rng, n, dim, n_coarse=4096, n_parents=65_536, n_queries=256):
    """Hierarchical clustered data + queries near existing parents: the
    generator of the reference's bench.py, so recall means the same."""
    spectrum, parents = clustered_hierarchy(rng, dim, n_coarse, n_parents)
    x = clustered_rows(rng, spectrum, parents, n)
    q = clustered_rows(rng, spectrum, parents, n_queries)
    return x.astype(np.float32), q.astype(np.float32)


class HostAnonPeak:
    """The peak of this process's anonymous memory, sampled by a thread
    every ``period`` seconds while the ``with`` block runs: ``RssAnon``
    of /proc/self/status where the kernel reports it (resident copies the
    process made, not the pages of the memory-mapped files it reads),
    else ``VmData`` (its private writable mappings, resident or not: an
    upper bound of the same, on kernels such as gVisor's that report
    neither ``RssAnon`` nor file pages apart). ``source`` names the field
    read; ``rss_peak_bytes`` is ``VmRSS``'s peak beside it, which counts
    the mapped files too."""

    FIELDS = ("RssAnon", "VmData")

    def __init__(self, period: float = 0.2):
        self.period = period
        self.peak_bytes = self.rss_peak_bytes = 0
        self.source: str | None = None
        self.stages: dict[str, int] = {}  # the peak between marks, by stage
        self._since = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def status() -> dict[str, int]:
        """The byte counts of /proc/self/status."""
        out = {}
        with open("/proc/self/status") as f:
            for line in f:
                key, _, rest = line.partition(":")
                parts = rest.split()
                if len(parts) == 2 and parts[1] == "kB":
                    out[key] = int(parts[0]) * 1024
        return out

    def _sample(self) -> None:
        st = self.status()
        with self._lock:
            if self.source is None:
                self.source = next((f for f in self.FIELDS if f in st), None)
                if self.source is None:
                    raise RuntimeError(f"/proc/self/status has none of {self.FIELDS}")
            self._since = max(self._since, st[self.source])
            self.peak_bytes = max(self.peak_bytes, st[self.source])
            self.rss_peak_bytes = max(self.rss_peak_bytes, st.get("VmRSS", 0))

    def mark(self, stage: str) -> None:
        """Record the peak since the previous mark (or the start) as
        ``stage``'s."""
        self._sample()
        with self._lock:
            self.stages[stage], self._since = self._since, 0

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self) -> "HostAnonPeak":
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True, name="host-anon")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._sample()


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
