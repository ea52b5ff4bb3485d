"""The solver's dense output in kernel launches a call: launch events that
start inside a ``caspr::ode.dense`` span (one a step that reaches request
times: the midpoint, the quartic's coefficients, theta, the Horner form), in
the traced calls over the calls.  Nothing where the trace holds no such
span."""

from harness import intervals, spans


def read(r):
    if not spans.recorded(r.trace):
        return None
    dense = intervals.union(spans.named(r.trace, "caspr::ode.dense"))
    if not dense:
        return None
    return sum(spans.covers(dense, t) for t in spans.launch_starts(r.trace)) / r.trace.calls
