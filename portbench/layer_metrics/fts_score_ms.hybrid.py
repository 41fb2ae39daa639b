"""Thread-milliseconds a hybrid call's full-text legs spend in their BM25
scorers (the program's ``fts.score`` spans: the native top-k or the
index's evaluation), summed over the legs, mean over the window,
in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "fts.score")
