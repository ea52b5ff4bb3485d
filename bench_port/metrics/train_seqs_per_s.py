"""Training sequences consumed in the window, over the window's time."""


def read(r):
    return r.seqs / r.window_s
