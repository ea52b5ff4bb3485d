"""Sequences completed by the entry in the window, over the window's time."""


def read(r):
    return r.seqs / r.window_s
