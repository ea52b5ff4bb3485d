"""Megabytes a training step that rank 0 hands to the program's collectives
(``caspr_tpu_torch.parallel.mesh.collectives``, every kind: almost all
all-reduces, the gradient's and the adjoint's VJPs the bulk), over the
traced steps.  None where the program counted no collective."""


def read(r):
    counted = r.counters.get("collectives")
    if not counted or r.trace is None or r.trace.calls == 0:
        return None
    return sum(c["bytes"] for c in counted.values()) / 1e6 / r.trace.calls
