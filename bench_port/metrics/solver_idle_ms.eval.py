"""Device idle inside the solver's steps, in ms a call: the gaps of the
union of device operations that lie inside the union of ``caspr::ode.step``
spans, over the traced calls."""

from harness import spans


def read(r):
    return spans.solver_idle_ms(r.trace)
