"""Seconds a build spends outside the device stages: the program's
``index.build`` span less its ``build.kmeans`` and ``build.pq`` spans
(the column upload, the samples, the layout, the index writes, the
commit), mean over the window's builds; moves index_build_s."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import total_s, window_records


def read(t):
    recs = window_records(t)
    if not recs or not t.builds or not any(r.name == "index.build" for r in recs):
        return None
    return (total_s(recs, "index.build") - total_s(recs, "build.kmeans", "build.pq")) / t.builds
