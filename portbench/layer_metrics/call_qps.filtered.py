"""Queries answered per second of the traced search window (host clock),
tracked beside the bounded metrics because the untraced rate spreads by
8-19 % from run to run on one H100's shared host; moves batch_p95_ms in openai1536_ivfpq.filtered256."""

from portbench.readers import queries_per_s


def read(t):
    return queries_per_s(t)
