"""The device's idle share of the traced build window: 1 - the union of
its kernel, copy and fill intervals (torch.profiler) over the window, in %."""

from portbench.readers import idle_pct


def read(t):
    return idle_pct(t)
