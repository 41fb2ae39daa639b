"""Process-global metrics: counters / gauges / histograms with a
pull-based snapshot API, and the spans that time each layer of a call.

Reference: metrics_otel.rs:1-50 — a global recorder aggregating into
lock-free cumulative state, snapshotted on demand, histograms exported
Prometheus-style as `le` buckets; python otel.py:35 bridges snapshots
into OpenTelemetry observable instruments.

The engine publishes object-store IO metrics (reference lib.rs:36-40:
request counts/bytes) and query/index counters through this module:
``lancedb.queries``, ``lancedb.h2d_bytes`` (each host-to-device copy of
the search and build paths, labelled ``memory`` pinned / pageable),
``lancedb.hydrate.takes`` (the takes a search's hydration makes: one a
call) and ``lancedb.hydrate.fragment_reads`` (the fragment reads of a
hydration that misses the resident copy), ``lancedb.fts.queries`` (one a
full-text query, each leg of a hybrid call too) and
``lancedb.fts.postings`` (the summed df of a full-text query's distinct
terms). ``counter_totals`` reads a counter's total over its labels by name.

``span(name)`` times one layer of a call. A span is kept while recording
is on: inside ``tracing()``, or while a ``torch.profiler`` session runs,
so a profiled window gets the program's spans on the same host clock
(``time.perf_counter_ns``) that the profiler's device events are tied
to. Each record holds its own id, its parent's, its request's (the root
span's id, shared by every span of one call) and its thread; spans nest
through a context variable, so threads stay apart. Records go into a
ring of ``SPAN_CAPACITY`` records (``span_records``); each one it
overwrites counts ``lancedb.spans.dropped``. A collector pause while
recording is a ``gc`` span, kept with the next span to end (a collection
can start anywhere, under any lock, so its callback takes none). Under
an analyze run (``analyze``) a span that names an operator (``op``)
synchronizes the run's device at both ends and adds its time and rows to
the run's per-operator metrics. With recording off and no analyze run, a
span is one shared no-op object.
"""

from __future__ import annotations

import contextvars
import gc
import itertools
import threading
import time
from bisect import bisect_right
from collections import deque
from collections.abc import Mapping
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.autograd import profiler as _torch_profiler

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

    def counter_total(self, name: str) -> float:
        """A counter's total over all its labels (0 for a name not seen)."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def counter_names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _ in self._counters})

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


class _CounterTotals(Mapping):
    """Read-only view: counter name → its total over all labels, 0 for a
    name not yet seen."""

    def __getitem__(self, name: str) -> float:
        return recorder().counter_total(name)

    def __iter__(self):
        return iter(recorder().counter_names())

    def __len__(self) -> int:
        return len(recorder().counter_names())


counter_totals = _CounterTotals()


def count_h2d(nbytes: int, pinned: bool) -> None:
    """One host-to-device copy of ``nbytes`` (``lancedb.h2d_bytes``)."""
    recorder().increment_counter("lancedb.h2d_bytes", float(nbytes),
                                 labels={"memory": "pinned" if pinned else "pageable"})


# ===================================================================== spans

SPAN_CAPACITY = 1 << 20


class SpanRecord(NamedTuple):
    name: str
    t0: int  # time.perf_counter_ns()
    t1: int
    id: int
    parent: int | None
    request: int  # the root span's id
    thread: int
    attrs: dict | None


_records: deque = deque(maxlen=SPAN_CAPACITY)
_records_lock = threading.Lock()
_tracing_depth = 0
_tracing_lock = threading.Lock()
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("lancedb_span", default=None)
_plan: contextvars.ContextVar = contextvars.ContextVar("lancedb_plan", default=None)
_gc_hooked = False
_gc_start: list = []
# collector pauses wait here for the next span to keep them: a collection
# may start inside _keep or the recorder, under their locks
_gc_pending: list = []


def recording() -> bool:
    """Whether spans are kept now: inside ``tracing()`` or a profiler session."""
    return _tracing_depth > 0 or _torch_profiler._is_profiler_enabled


@contextmanager
def tracing():
    """Keep the spans of every thread while the block runs."""
    global _tracing_depth
    with _tracing_lock:
        _tracing_depth += 1
    try:
        yield
    finally:
        with _tracing_lock:
            _tracing_depth -= 1


def span_records(clear: bool = False) -> list[SpanRecord]:
    """The kept span records, oldest first (``clear``: and empty the ring)."""
    _keep(None)
    with _records_lock:
        out = list(_records)
        if clear:
            _records.clear()
    return [SpanRecord(*r[:7], dict(zip(r[7::2], r[8::2])) if len(r) > 7 else None)
            for r in out]


def _keep(rec: tuple | None) -> None:
    """Keep ``rec`` (None: nothing), after the collector pauses pending.
    The ring holds flat tuples of numbers and strings (a record's fields,
    then its attributes' names and values in turn), which the collector
    stops tracking, so a full ring does not slow its passes."""
    recs = () if rec is None else (rec,)
    if _gc_pending:
        pending = _gc_pending[:]
        del _gc_pending[: len(pending)]
        recs = (*pending, *recs)
    with _records_lock:
        dropped = max(0, len(_records) + len(recs) - SPAN_CAPACITY)
        _records.extend(recs)
    if dropped:
        recorder().increment_counter("lancedb.spans.dropped", float(dropped))


def _gc_callback(phase: str, info: dict) -> None:
    if not recording():
        _gc_start.clear()
        return
    if phase == "start":
        _gc_start[:] = [time.perf_counter_ns()]
    elif _gc_start:
        t0 = _gc_start.pop()
        parent = _current.get()
        sid = next(_ids)
        _gc_pending.append(("gc", t0, time.perf_counter_ns(), sid,
                            parent.id if parent is not None else None,
                            parent.request if parent is not None else sid,
                            threading.get_ident(), "generation", info.get("generation"),
                            "collected", info.get("collected")))


def _hook_gc() -> None:
    global _gc_hooked
    if not _gc_hooked:
        _gc_hooked = True
        gc.callbacks.append(_gc_callback)


@dataclass
class Analysis:
    """One analyze run's per-operator metrics: operator name →
    {elapsed_s, invocations, output_rows}; ``elapsed_s`` is the run's."""

    device: object = None  # a torch.device synchronized around each operator
    ops: dict = field(default_factory=dict)
    elapsed_s: float = 0.0


def _synced_clock(device) -> float:
    """The host clock, read once the device's queued work has finished."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@contextmanager
def analyze(device=None):
    """An analyze run (EXPLAIN ANALYZE, ``analyze_plan``): the spans that
    name an operator inside the block add into the yielded ``Analysis``;
    with a CUDA ``device`` their times cover the device work they queued."""
    run = Analysis(device)
    token = _plan.set(run)
    t0 = _synced_clock(device)
    try:
        yield run
    finally:
        run.elapsed_s = _synced_clock(device) - t0
        _plan.reset(token)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_rows(self, n: int) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "op", "attrs", "rows", "id", "parent", "request", "t0", "_token",
                 "_run", "_record", "_p0")

    def __init__(self, name: str, op: str | None, attrs: dict, record: bool, run):
        self.name, self.op, self.attrs, self.rows = name, op, attrs or None, None
        self._record, self._run = record, run

    def set_rows(self, n: int) -> None:
        self.rows = int(n)

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    def __enter__(self):
        if self._run is not None:
            self._p0 = _synced_clock(self._run.device)
        if self._record:
            if not _gc_hooked:
                _hook_gc()
            parent = _current.get()
            self.id = next(_ids)
            self.parent = parent.id if parent is not None else None
            self.request = parent.request if parent is not None else self.id
            self._token = _current.set(self)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._run is not None:
            rec = self._run.ops.setdefault(self.op, {"elapsed_s": 0.0, "invocations": 0})
            rec["elapsed_s"] += _synced_clock(self._run.device) - self._p0
            rec["invocations"] += 1
            if self.rows is not None:
                rec["output_rows"] = rec.get("output_rows", 0) + self.rows
        if self._record:
            t1 = time.perf_counter_ns()
            _current.reset(self._token)
            rec = (self.name, self.t0, t1, self.id, self.parent, self.request,
                   threading.get_ident())
            if self.attrs:
                rec += tuple(itertools.chain.from_iterable(self.attrs.items()))
            if self.rows is not None:
                rec += ("rows", self.rows)
            _keep(rec)
        return False


def span(name: str, op: str | None = None, **attrs):
    """A context manager that times one layer of a call as ``name``, with
    small ``attrs`` (``set_rows`` and ``set`` add more). ``op``: the
    operator it is in an analyze run's metrics."""
    record = _tracing_depth > 0 or _torch_profiler._is_profiler_enabled
    run = _plan.get() if op is not None else None
    if not record and run is None:
        return _NO_SPAN
    return _Span(name, op, attrs, record, run)
