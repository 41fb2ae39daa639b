"""Fragment reads a search call's hydration makes where it misses the
resident copy: the program's ``lancedb.hydrate.fragment_reads`` counter
over the window, per call; moves batch_p95_ms in
openai1536_ivfpq.filtered256."""

from portbench.program_spans import FRAGMENT_READS as COUNTERS  # noqa: F401
from portbench.program_spans import counter_per_call


def read(t):
    return counter_per_call(t, "fragment_reads")
