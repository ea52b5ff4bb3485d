"""The CNF's function evaluations a decode, mean over the window's calls."""


def read(r):
    nfe = [info["nfe"][1] for info in r.infos if "nfe" in info]
    return sum(nfe) / len(nfe) if nfe else None
