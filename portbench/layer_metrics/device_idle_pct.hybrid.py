"""The device's idle share of the traced hybrid window: 1 - the union of
its kernel, copy and fill intervals (torch.profiler) over the window, in %,
in dbpedia1536_hybrid.hybrid256."""

from portbench.readers import idle_pct


def read(t):
    return idle_pct(t)
