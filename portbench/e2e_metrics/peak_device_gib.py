"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start, in GiB."""


def read(w):
    return w.peak_bytes / 2**30 if w.peak_bytes else None
