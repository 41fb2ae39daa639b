"""Postings a hybrid call's full-text legs may visit: the program's
``lancedb.fts.postings`` counter (each query's summed df of its distinct
terms) over the window, per call; None where the program counts none;
in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED, counter_per_call

COUNTERS = {"fts_postings": ("portbench.program_spans", "TOTALS", "lancedb.fts.postings"),
            **SPANS_DROPPED}


def read(t):
    return counter_per_call(t, "fts_postings") or None
