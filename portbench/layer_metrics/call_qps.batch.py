"""Queries answered per second of the traced search window (host clock),
tracked beside the bounded metrics because the untraced rate spreads by
8-19 % from run to run on one H100's shared host; moves setup_s only: no bounded end-to-end speed metric in sift1m_ivfpq.batch256."""

from portbench.readers import queries_per_s


def read(t):
    return queries_per_s(t)
