"""Device-to-host reads a training step: the program's ``caspr::host_read``
spans in the traced steps over the steps.  Each is a synchronisation: an
error norm of a solver step, three for each solve's initial step, a tensor
of request times, the logged scalars."""

from harness import spans


def read(r):
    if not spans.recorded(r.trace):
        return None
    return len(spans.named(r.trace, "caspr::host_read")) / r.trace.calls
