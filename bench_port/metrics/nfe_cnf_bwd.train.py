"""The CNF adjoint's backward function evaluations a step, mean over the
window's steps."""


def read(r):
    nfe = [info["nfe_bwd"][1] for info in r.infos if "nfe_bwd" in info]
    return sum(nfe) / len(nfe) if nfe else None
