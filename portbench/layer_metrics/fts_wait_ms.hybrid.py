"""Milliseconds a hybrid call's own thread waits for its full-text legs
once its vector leg has returned: the program's ``hybrid.fts_wait`` spans,
mean over the window, in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "hybrid.fts_wait")
