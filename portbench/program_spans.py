"""What the per-layer metrics that read the program's own instruments
share: the span records ``lancedb_tpu_torch.metrics`` keeps while the
traced window's profiler runs, clipped to the window, their arithmetic,
and the program's counters (``metrics.counter_totals``) as the tracer's
``COUNTERS`` read them at the window's ends.

A reading is None where the program keeps no spans (a port without
``metrics.span_records``), where it kept none of the names read, or
where its ring dropped records during the window (``SPANS_DROPPED``,
which every reader here declares); a counter reading is None where the
program has no counter view."""

from __future__ import annotations

import math
from collections.abc import Mapping

from portbench.trace import busy_intervals


class _ProgramCounters(Mapping):
    """The program's counter totals by name, NaN where the program has no
    counter view (so a window's delta is NaN, and its reading None)."""

    def __getitem__(self, name: str) -> float:
        from lancedb_tpu_torch import metrics

        view = getattr(metrics, "counter_totals", None)
        return math.nan if view is None else float(view[name])

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0


TOTALS = _ProgramCounters()


def _counter(name: str) -> tuple:
    return ("portbench.program_spans", "TOTALS", name)


SPANS_DROPPED = {"spans_dropped": _counter("lancedb.spans.dropped")}
H2D_BYTES = {"h2d_bytes": _counter("lancedb.h2d_bytes"), **SPANS_DROPPED}
FRAGMENT_READS = {"fragment_reads": _counter("lancedb.hydrate.fragment_reads"),
                  **SPANS_DROPPED}


def _program_records() -> list | None:
    try:
        from lancedb_tpu_torch import metrics
    except ImportError:
        return None
    read = getattr(metrics, "span_records", None)
    return None if read is None else read()


def window_records(t) -> list | None:
    """The program's span records that overlap the traced window; None
    where there are none or the ring dropped some during the window."""
    dropped = t.counters.get("spans_dropped")
    if dropped is None or not dropped == 0:  # NaN: the program has no such counter
        return None
    a, b = t.window
    recs = [r for r in _program_records() or () if r.t1 > a and r.t0 < b]
    return recs or None


def is_root(r) -> bool:
    """A call's root span: no parent (a collector pause is never a root)."""
    return r.parent is None and r.name != "gc"


def total_s(recs: list, *names: str) -> float:
    """Seconds inside the spans of ``names``."""
    return sum(r.t1 - r.t0 for r in recs if r.name in names) / 1e9


def self_s(recs: list, name: str) -> float:
    """Seconds inside the spans of ``name`` that none of their children covers."""
    ids = {r.id for r in recs if r.name == name}
    child = sum(r.t1 - r.t0 for r in recs if r.parent in ids)
    return (sum(r.t1 - r.t0 for r in recs if r.id in ids) - child) / 1e9


def ms_per_call(t, recs: list | None, name: str) -> float | None:
    """Milliseconds inside the spans of ``name`` a window's call."""
    if not recs or not t.calls or not any(r.name == name for r in recs):
        return None
    return total_s(recs, name) * 1e3 / t.calls


def counter_per_call(t, name: str) -> float | None:
    """A program counter's window delta a call (None: no counter view)."""
    v = t.counters.get(name)
    return v / t.calls if v is not None and not math.isnan(v) and t.calls else None


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(t) -> list[tuple[int, int]]:
    """The device's idle intervals in the window (no kernel, copy or fill)."""
    busy = busy_intervals(t.events, t.window)
    edges = [t.window[0]] + [x for iv in busy for x in iv] + [t.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _overlap(xs: list[tuple[int, int]], ys: list[tuple[int, int]]) -> int:
    """Total overlap of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unnamed_pct(t, recs: list | None) -> float | None:
    """The device-idle time of the window while no program span, or only
    a root, is open, in % of the window."""
    if not recs or not t.events or t.window_s <= 0:
        return None
    gaps = idle_gaps(t)
    named = _union((max(r.t0, t.window[0]), min(r.t1, t.window[1]))
                   for r in recs if not is_root(r))
    unnamed = sum(b - a for a, b in gaps) - _overlap(gaps, named)
    return 100.0 * unnamed / (t.window[1] - t.window[0])


def idle_by_innermost(recs: list, gaps: list[tuple[int, int]]) -> dict[str, int]:
    """Nanoseconds of the idle ``gaps`` (sorted, disjoint) under each
    innermost open program span, the latest started ("harness" where none
    is open), swept once over the spans' ends."""
    edges = sorted([(r.t0, 1, i) for i, r in enumerate(recs)]
                   + [(r.t1, 0, i) for i, r in enumerate(recs)])
    end = gaps[-1][1] if gaps else 0
    out: dict[str, int] = {}
    stack: list[int] = []
    g, prev = 0, gaps[0][0] if gaps else 0
    for at, kind, i in edges + [(end, 2, -1)]:
        at = max(at, prev)
        name = recs[stack[-1]].name if stack else "harness"
        while g < len(gaps) and gaps[g][1] <= prev:
            g += 1
        k = g
        while k < len(gaps) and gaps[k][0] < at:
            a, b = max(gaps[k][0], prev), min(gaps[k][1], at)
            if b > a:
                out[name] = out.get(name, 0) + (b - a)
            k += 1
        prev = at
        if kind == 1:
            stack.append(i)
        elif kind == 0 and i in stack:
            stack.remove(i)
    return out


def named_gaps(t, recs: list, top: int = 10) -> list[list]:
    """The ``top`` longest idle gaps, each [name, seconds]: the innermost
    program span that is open for most of the gap ("harness" where none
    is)."""
    out = []
    for a, b in sorted(idle_gaps(t), key=lambda g: g[0] - g[1])[:top]:
        under = idle_by_innermost([r for r in recs if r.t1 > a and r.t0 < b], [(a, b)])
        out.append([max(under, key=under.get), (b - a) / 1e9])
    return out
