"""The device's idle share of the traced search window: 1 - the union of
its kernel, copy and fill intervals (torch.profiler) over the window, in %;
moves setup_s only: no bounded end-to-end speed metric in sift1m_ivfpq.batch256."""

from portbench.readers import idle_pct


def read(t):
    return idle_pct(t)
