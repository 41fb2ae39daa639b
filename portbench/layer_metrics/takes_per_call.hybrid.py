"""Takes a hybrid call makes: the program's ``dataset.take_rows`` spans in
the window, per call (the vector leg's one hydration take and each
full-text leg's take of its hits), in
dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import window_records


def read(t):
    recs = window_records(t)
    if not recs or not t.calls:
        return None
    n = sum(1 for r in recs if r.name == "dataset.take_rows")
    return n / t.calls if n else None
