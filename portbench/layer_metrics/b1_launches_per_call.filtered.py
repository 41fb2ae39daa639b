"""B1 launches a search call: the port's launch counter
(``ops/cuda_build.py`` ``launch_counts``) over the window, per call;
moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import B1_LAUNCHES as COUNTERS, launches_per_call  # noqa: F401


def read(t):
    return launches_per_call(t, "b1_launches")
