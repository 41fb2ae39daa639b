"""Milliseconds a search call spends on its prefilter: the allowed row set
(``query.compute_allowed_rowids``) and the slot penalty
(``VectorSearcher.slot_penalty``), summed a call, mean over the window;
moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import PREFILTER as SPANS, ms_per_call  # noqa: F401


def read(t):
    return ms_per_call(t, "allowed_rowids", "slot_penalty")
