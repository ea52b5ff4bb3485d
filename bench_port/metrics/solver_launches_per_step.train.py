"""The solver's own kernel launches a training step: launches that start
inside a ``caspr::ode.step`` span and outside every ``caspr::ode.func`` span
(the stage sums, the error norms, the dense output; not the dynamics), in
the traced steps over the steps."""

from harness import intervals, spans


def read(r):
    if not spans.recorded(r.trace):
        return None
    steps = intervals.union(spans.named(r.trace, "caspr::ode.step"))
    funcs = intervals.union(spans.named(r.trace, "caspr::ode.func"))
    own = [t for t in spans.launch_starts(r.trace)
           if spans.covers(steps, t) and not spans.covers(funcs, t)]
    return len(own) / r.trace.calls
