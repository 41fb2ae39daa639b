"""The device's idle share of the traced search window: 1 - the union of
its kernel, copy and fill intervals (torch.profiler) over the window, in %;
moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import idle_pct


def read(t):
    return idle_pct(t)
