"""Process-global metrics: counters / gauges / histograms with a
pull-based snapshot API.

Reference: metrics_otel.rs:1-50 — a global recorder aggregating into
lock-free cumulative state, snapshotted on demand, histograms exported
Prometheus-style as `le` buckets; python otel.py:35 bridges snapshots
into OpenTelemetry observable instruments.

The engine publishes object-store IO metrics (reference lib.rs:36-40:
request counts/bytes) and query/index counters through this module.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from dataclasses import dataclass, field

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclass
class _Histogram:
    buckets: tuple[float, ...] = _DEFAULT_BUCKETS
    counts: list[int] = field(default_factory=lambda: [0] * (len(_DEFAULT_BUCKETS) + 1))
    total: float = 0.0
    n: int = 0

    def record(self, value: float) -> None:
        self.counts[bisect_right(self.buckets, value)] += 1
        self.total += value
        self.n += 1

    def snapshot(self) -> dict:
        le = {}
        acc = 0
        for bound, c in zip(self.buckets, self.counts):
            acc += c
            le[str(bound)] = acc
        le["+Inf"] = acc + self.counts[-1]
        return {"count": self.n, "sum": self.total, "le": le}


class MetricsRecorder:
    """Cumulative metric state; thread-safe; reset only by process exit
    (matching the reference's cumulative snapshot semantics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._histograms: dict[tuple[str, tuple], _Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def increment_counter(self, name: str, value: float = 1.0, labels: dict | None = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, labels: dict | None = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def record_histogram(self, name: str, value: float, labels: dict | None = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            if k not in self._histograms:
                self._histograms[k] = _Histogram()
            self._histograms[k].record(value)

    # --- pull API (reference register_metrics_recorder / snapshot_metrics)
    def metrics_catalog(self) -> dict[str, str]:
        with self._lock:
            out = {}
            for (name, _), _v in self._counters.items():
                out[name] = "counter"
            for (name, _), _v in self._gauges.items():
                out[name] = "gauge"
            for (name, _), _v in self._histograms.items():
                out[name] = "histogram"
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": [
                    {"name": n, "labels": dict(lbl), "value": v}
                    for (n, lbl), v in sorted(self._counters.items())
                ],
                "gauges": [
                    {"name": n, "labels": dict(lbl), "value": v}
                    for (n, lbl), v in sorted(self._gauges.items())
                ],
                "histograms": [
                    {"name": n, "labels": dict(lbl), **h.snapshot()}
                    for (n, lbl), h in sorted(self._histograms.items())
                ],
            }


_GLOBAL: MetricsRecorder | None = None
_GLOBAL_LOCK = threading.Lock()


def register_metrics_recorder() -> MetricsRecorder:
    """Install (or fetch) the process-global recorder (reference
    metrics_otel.rs `register_metrics_recorder` — idempotent)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRecorder()
        return _GLOBAL


def recorder() -> MetricsRecorder:
    return register_metrics_recorder()


def snapshot_metrics() -> dict:
    return recorder().snapshot()


def metrics_catalog() -> dict[str, str]:
    return recorder().metrics_catalog()


def instrument_lancedb_metrics(meter=None):
    """OpenTelemetry bridge (reference python otel.py:35
    `instrument_lancedb_metrics`): registers observable instruments that
    pull from the global snapshot. No-op when opentelemetry is absent."""
    try:
        from opentelemetry import metrics as otel_metrics
    except ImportError:
        return None
    meter = meter or otel_metrics.get_meter("lancedb_tpu_torch")
    rec = recorder()

    def _counter_cb(options):
        from opentelemetry.metrics import Observation

        return [
            Observation(c["value"], attributes=c["labels"])
            for c in rec.snapshot()["counters"]
        ]

    return meter.create_observable_counter(
        "lancedb.operations", callbacks=[_counter_cb]
    )
