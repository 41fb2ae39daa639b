"""Milliseconds a search call spends in ``VectorSearcher.search`` (probes,
LUTs, B1, top-k, the fused refine, the copy back), each span ended on a
device synchronize, mean over the window; moves setup_s only: no bounded end-to-end speed metric in sift1m_ivfpq.batch256."""

from portbench.readers import SEARCHER as SPANS, ms_per_call  # noqa: F401


def read(t):
    return ms_per_call(t, "searcher")
