"""B1 launches a search call: the port's launch counter
(``ops/cuda_build.py`` ``launch_counts``) over the window, per call;
moves setup_s only: no bounded end-to-end speed metric in sift1m_ivfpq.batch256."""

from portbench.readers import B1_LAUNCHES as COUNTERS, launches_per_call  # noqa: F401


def read(t):
    return launches_per_call(t, "b1_launches")
