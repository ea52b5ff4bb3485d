"""Device idle inside the solver's steps, in ms a training step: the gaps of
the union of device operations that lie inside the union of
``caspr::ode.step`` spans, over the traced steps."""

from harness import spans


def read(r):
    return spans.solver_idle_ms(r.trace)
