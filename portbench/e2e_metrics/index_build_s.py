"""The window's seconds per completed build; the window ends with the first
build that finishes after ``--seconds``."""


def read(w):
    return w.seconds / w.builds if w.builds else None
