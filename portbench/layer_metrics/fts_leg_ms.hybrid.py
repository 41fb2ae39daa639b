"""Thread-milliseconds a hybrid call's full-text legs take, summed over
its legs (each leg's ``hybrid.fts_leg`` span: the BM25 scorer, the take of
its hits and their Arrow table, on the legs' threads), mean over the
window, in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "hybrid.fts_leg")
