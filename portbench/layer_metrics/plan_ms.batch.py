"""Milliseconds a search call spends in the program's ``query.plan`` spans
(the request's checks, the queries stacked, the index and its searcher
resolved, the rows deleted since the build, the device-refine check),
mean over the window; moves setup_s only: no bounded end-to-end speed
metric in sift1m_ivfpq.batch256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import ms_per_call, window_records


def read(t):
    return ms_per_call(t, window_records(t), "query.plan")
