"""The device's idle time in the traced hybrid window while no program
span, or only a call's root (``query.hybrid``), is open, in % of the
window: the idle time that no layer of the program can be charged with,
in dbpedia1536_hybrid.hybrid256."""

from portbench.program_spans import SPANS_DROPPED as COUNTERS  # noqa: F401
from portbench.program_spans import idle_unnamed_pct, window_records


def read(t):
    return idle_unnamed_pct(t, window_records(t))
