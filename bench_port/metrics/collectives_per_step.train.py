"""Collective calls a training step on rank 0, as the program counts them
(``caspr_tpu_torch.parallel.mesh.collectives``, every kind), over the traced
steps: most are the solvers' error-norm all-reduces, each a synchronisation
of every rank.  None where the program counted no collective."""


def read(r):
    counted = r.counters.get("collectives")
    if not counted or r.trace is None or r.trace.calls == 0:
        return None
    return sum(c["calls"] for c in counted.values()) / r.trace.calls
