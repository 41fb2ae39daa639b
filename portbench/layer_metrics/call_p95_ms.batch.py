"""The 95th percentile of the traced window's search calls, call to return
on the host clock, tracked beside the bounded metrics because the
untraced tail spreads by 14-18 % from run to run on one H100's shared
host; moves setup_s only: no bounded end-to-end speed metric in
sift1m_ivfpq.batch256."""

from portbench.readers import call_p95_ms


def read(t):
    return call_p95_ms(t)
