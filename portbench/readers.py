"""What several per-layer metrics read alike: the spans they declare and
their arithmetic over a traced window (``trace.Trace``). Each metric's
file under ``layer_metrics/`` names its spans and its reading from here;
a reading that finds nothing to read is None."""

from __future__ import annotations

import numpy as np
import torch

from portbench import bounds
from portbench.trace import Span

TAKE_ROWS = {"take_rows": Span("lancedb_tpu_torch.storage.dataset:Dataset.take_rows")}
SEARCHER = {"searcher": Span("lancedb_tpu_torch.index.vector:VectorSearcher.search", sync=True)}
PREFILTER = {
    "allowed_rowids": Span("lancedb_tpu_torch.query:compute_allowed_rowids"),
    "slot_penalty": Span("lancedb_tpu_torch.index.vector:VectorSearcher.slot_penalty", sync=True),
}
KMEANS = {"kmeans": Span("lancedb_tpu_torch.index.vector:ivf_train_assign_device", sync=True)}
PQ = {"pq": Span("lancedb_tpu_torch.index.vector:pq_build_device", sync=True)}
B1_LAUNCHES = {"b1_launches": ("lancedb_tpu_torch.ops.cuda_build", "launch_counts",
                               "ivf_pq_adc_scan")}
B1_KERNEL = "adc_scan_kernel"


def _b1_bound(args, kwargs, result):
    """The least time of B1's function on one launch's shapes and probed
    partitions (``bounds.adc_bound``), in seconds."""
    probe_ids, dlut, codes = args[0], args[1], args[2]
    q, np_ = probe_ids.shape
    _, s, pmax = codes.shape
    probed = int(torch.unique(probe_ids).numel())
    return bounds.adc_bound(q, np_, s, dlut.shape[2], pmax, probed)["seconds"]


B1 = {"b1": Span("lancedb_tpu_torch.index.vector:ivf_pq_adc_scan", record=_b1_bound)}


def ms_per_call(t, *names: str) -> float | None:
    """Milliseconds inside the spans ``names``, summed, a window's call."""
    if not t.calls or not t.spans(names[0]):
        return None
    return sum(t.span_s(n) for n in names) * 1e3 / t.calls


def s_per_build(t, name: str) -> float | None:
    return t.span_s(name) / t.builds if t.builds and t.spans(name) else None


def queries_per_s(t) -> float | None:
    return t.queries / t.window_s if t.calls and t.window_s > 0 else None


def call_p95_ms(t) -> float | None:
    return float(np.percentile(t.latencies, 95)) * 1e3 if t.latencies else None


def launches_per_call(t, counter: str) -> float | None:
    return t.counters[counter] / t.calls if t.calls else None


def idle_pct(t) -> float | None:
    """1 - the union of the device's kernel, copy and fill intervals over
    the traced window, in %."""
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.events and t.window_s > 0 else None


def b1_roofline(t) -> float | None:
    """The sum of the launches' bounds over the sum of the B1 kernel's
    device time in the trace, in % (the grouped scan, B3, is not B1)."""
    launches = t.spans("b1")
    kernel_s = t.kernel_s(B1_KERNEL, excludes="grouped")
    if not launches or kernel_s <= 0:
        return None
    return 100.0 * sum(r.extra for r in launches) / kernel_s
