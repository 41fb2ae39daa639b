"""Host milliseconds a search call spends in ``Dataset.take_rows`` (the
hydration of the result rows), summed a call, mean over the window;
moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import TAKE_ROWS as SPANS, ms_per_call  # noqa: F401


def read(t):
    return ms_per_call(t, "take_rows")
