"""Milliseconds a search call spends in ``VectorSearcher.search`` (probes,
LUTs, B1, top-k, the fused refine, the copy back), each span ended on a
device synchronize, mean over the window; moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import SEARCHER as SPANS, ms_per_call  # noqa: F401


def read(t):
    return ms_per_call(t, "searcher")
