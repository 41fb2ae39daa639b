"""B1's (the IVF_PQ ADC scan's) share of its roofline at 4-bit x 192
sub-vectors in dbpedia1536_hybrid.hybrid256's vector legs: the sum over
the window's launches of the least time of its function on each launch's
shapes and probed partitions (``bounds.adc_bound``), over the sum of the
B1 kernel's device time in the profiler's trace, in %."""

from portbench.readers import B1 as SPANS, b1_roofline  # noqa: F401


def read(t):
    return b1_roofline(t)
