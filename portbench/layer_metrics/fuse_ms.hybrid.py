"""Milliseconds a hybrid call spends fusing its pairs (the program's
``hybrid.fuse`` spans: each pair's vector rows split out, the RRF of its
two legs, the concatenation), mean over the window, in
dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "hybrid.fuse")
