"""Milliseconds a search call spends finishing its result on the host: the
program's ``query.finish`` spans (postfilter, offset, ordering) and the
time of ``query.hydrate`` outside its ``dataset.take_rows`` spans (the
distance range and the Arrow assembly), mean over the window; moves
setup_s only: no bounded end-to-end speed metric in sift1m_ivfpq.batch256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import self_s, total_s, window_records


def read(t):
    recs = window_records(t)
    if not recs or not t.calls or not any(r.name == "query.hydrate" for r in recs):
        return None
    return (total_s(recs, "query.finish") + self_s(recs, "query.hydrate")) * 1e3 / t.calls
