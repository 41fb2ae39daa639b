"""Milliseconds a hybrid call spends in its vector leg: the program's
``query.vector`` spans (the 256 vectors' one searcher call, refine and
hydration, a child of ``query.hybrid``), mean over the window,
in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "query.vector")
