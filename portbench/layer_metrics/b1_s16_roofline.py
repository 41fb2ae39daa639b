"""B1's (the IVF_PQ ADC scan's) share of its roofline at 8-bit x 16
sub-vectors in sift1m_ivfpq.batch256: the sum over the window's launches
of the least time of its function on each launch's shapes and probed
partitions (``bounds.adc_bound``), over the sum of the B1 kernel's device
time in the profiler's trace, in %; moves setup_s only: no bounded
end-to-end speed metric there."""

from portbench.readers import B1 as SPANS, b1_roofline  # noqa: F401


def read(t):
    return b1_roofline(t)
