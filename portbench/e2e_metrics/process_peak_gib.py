"""``torch.cuda.max_memory_allocated()`` over the whole run up to the
window's end, set-up included (the draws, the table, the index build, the
warm calls), in GiB: what one card must hold to load, index and serve the
table. Used where the window's own peak steps with the seed: in
sift1m_ivfpq.batch256 a seed whose largest k-means partition passes 1152
rows lays the index out in blocks of 1280 slots, which widens the
search's transients by 1 % (3 of 22 seeds)."""


def read(w):
    return w.process_peak_bytes / 2**30 if w.process_peak_bytes else None
