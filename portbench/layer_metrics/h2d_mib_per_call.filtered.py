"""MiB a search call copies from the host to the device: the program's
``lancedb.h2d_bytes`` counter (pinned and pageable) over the window, per
call; moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.program_spans import H2D_BYTES as COUNTERS  # noqa: F401
from portbench.program_spans import counter_per_call


def read(t):
    v = counter_per_call(t, "h2d_bytes")
    return None if v is None else v / 2**20
