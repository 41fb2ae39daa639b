"""Seconds from the process's start to the window's start."""


def read(w):
    return w.setup_s
