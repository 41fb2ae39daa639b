"""Seconds a build spends in the PQ stage (``pq_build_device``: codebook
training, encoding, rnorms), each span ended on a device synchronize,
mean over the window's builds."""

from portbench.readers import PQ as SPANS, s_per_build  # noqa: F401


def read(t):
    return s_per_build(t, "pq")
