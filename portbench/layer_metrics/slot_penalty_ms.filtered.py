"""Milliseconds a search call spends in the program's
``searcher.slot_penalty`` span (the host's per-slot penalty of the
prefilter's allowed rows and the deletions), mean over the window: the
half of ``prefilter_ms`` that is not the allowed-row scan; moves
batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "searcher.slot_penalty")
