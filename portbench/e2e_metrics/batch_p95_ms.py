"""The 95th percentile of the window's search calls, call to return (host clock)."""

import numpy as np


def read(w):
    return float(np.percentile(w.latencies, 95)) * 1e3 if w.latencies else None
