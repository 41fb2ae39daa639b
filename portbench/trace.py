"""The traced run's instruments, all from outside the program: spans that
wrap the port's functions by patching their attributes for the run, the
port's counters read at the window's ends, and ``torch.profiler`` over the
window (device activity only).

A metric's reader declares what it reads: ``SPANS`` (span name →
``Span``), ``COUNTERS`` (name → (module, attribute, key)). A span with
``sync`` ends on ``torch.cuda.synchronize()``, so that it covers the
device work the call queued."""

from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass(frozen=True)
class Span:
    target: str  # "package.module:Attr.path"
    sync: bool = False
    # called as record(args, kwargs, result) after the call; its value is
    # kept with the span (e.g. a launch's bound)
    record: Callable | None = None


@dataclass
class SpanRecord:
    name: str
    t0: int  # perf_counter_ns
    t1: int
    call: int
    depth: int
    extra: object = None


def _resolve(target: str):
    mod_name, _, path = target.partition(":")
    obj = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


class Tracer:
    """Installs the spans while the ``with`` block runs and keeps their
    records; ``call`` is the window's current call, set by the driver."""

    def __init__(self, spans: dict[str, Span], counters: dict[str, tuple], device):
        self.spans, self.counters = spans, counters
        self.cuda = torch.device(device).type == "cuda"
        self.records: list[SpanRecord] = []
        self.call = -1
        self._depth = 0
        self._open: dict[str, int] = {}
        self._saved: list[tuple] = []
        self._counts0: dict[str, float] = {}

    def _wrap(self, name: str, span: Span, fn):
        tracer = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            outer = tracer._open.get(name, 0) == 0  # a span inside its own name is not kept
            t0 = time.perf_counter_ns()
            tracer._depth += 1
            tracer._open[name] = tracer._open.get(name, 0) + 1
            try:
                result = fn(*args, **kwargs)
                if span.sync and tracer.cuda:
                    torch.cuda.synchronize()
            finally:
                tracer._depth -= 1
                tracer._open[name] -= 1
            t1 = time.perf_counter_ns()
            if not outer:
                return result
            extra = span.record(args, kwargs, result) if span.record is not None else None
            tracer.records.append(SpanRecord(name, t0, t1, tracer.call, tracer._depth, extra))
            return result

        return wrapper

    def __enter__(self):
        for name, span in self.spans.items():
            owner, attr = _resolve(span.target)
            original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            self._saved.append((owner, attr, original))
            setattr(owner, attr, self._wrap(name, span, getattr(owner, attr)))
        return self

    def __exit__(self, *exc):
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()

    def _count(self, name: str) -> float:
        mod, attr, key = self.counters[name]
        return float(getattr(importlib.import_module(mod), attr)[key])

    def start_counters(self) -> None:
        self._counts0 = {n: self._count(n) for n in self.counters}

    def counter_deltas(self) -> dict[str, float]:
        return {n: self._count(n) - v for n, v in self._counts0.items()}


@dataclass
class DeviceEvent:
    name: str
    t0: int  # ns, on the host's perf_counter clock
    t1: int


def device_events(prof, marker_host_ns: int, window: tuple[int, int]) -> list[DeviceEvent]:
    """The profiler's device activity (kernels, copies, fills) on the
    host's clock. The device clock is tied to the host's by the marker
    kernel (``torch.cuda._sleep``) that the window starts with."""
    raw = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        raw.append((e.name(), int(start), int(start + dur)))
    markers = [r for r in raw if "spin_kernel" in r[0]]
    if markers:
        offset = marker_host_ns - min(markers, key=lambda r: r[1])[1]
    else:
        offset = window[0] - min((r[1] for r in raw), default=window[0])
    out = [DeviceEvent(n, a + offset, b + offset) for n, a, b in raw if "spin_kernel" not in n]
    return sorted(out, key=lambda e: e.t0)


def busy_intervals(events: list[DeviceEvent], window: tuple[int, int]) -> list[tuple[int, int]]:
    """The union of the events' intervals, clipped to the window."""
    out: list[list[int]] = []
    for e in sorted(events, key=lambda e: e.t0):
        a, b = max(e.t0, window[0]), min(e.t1, window[1])
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """What the traced run's layer metrics read."""

    window: tuple[int, int]  # perf_counter_ns at the window's ends
    calls: int
    builds: int
    queries: int = 0
    latencies: list[float] = field(default_factory=list)  # seconds a search call
    records: list[SpanRecord] = field(default_factory=list)
    events: list[DeviceEvent] = field(default_factory=list)
    counters: dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def span_s(self, name: str) -> float:
        """Seconds inside the spans of ``name``."""
        return sum(r.t1 - r.t0 for r in self.records if r.name == name) / 1e9

    def spans(self, name: str) -> list[SpanRecord]:
        return [r for r in self.records if r.name == name]

    def busy_s(self) -> float:
        return sum(b - a for a, b in busy_intervals(self.events, self.window)) / 1e9

    def kernel_s(self, contains: str, excludes: str | None = None) -> float:
        return sum(e.t1 - e.t0 for e in self.events if contains in e.name and
                   (excludes is None or excludes not in e.name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device named by the innermost host span open at each
        gap's middle (the deepest, then the shortest; "window" where none is)."""
        by_name: dict[str, int] = {}
        for e in self.events:
            a, b = max(e.t0, self.window[0]), min(e.t1, self.window[1])
            if b > a:
                by_name[e.name] = by_name.get(e.name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = busy_intervals(self.events, self.window)
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            open_spans = [r for r in self.records if r.t0 <= mid <= r.t1]
            inner = max(open_spans, key=lambda r: (r.depth, r.t0 - r.t1)) if open_spans else None
            name = inner.name if inner is not None else "window"
            named.append([name, (b - a) / 1e9])
        return {"device_ops": [[n, v / 1e9] for n, v in ops], "idle_gaps": named}
