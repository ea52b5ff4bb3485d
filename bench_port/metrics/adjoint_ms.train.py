"""Milliseconds a training step in the continuous adjoint's backward: the
union of ``caspr::adjoint`` spans over the traced steps, on the trace's host
clock (each solver step synchronises, so this is wall time)."""

from harness import intervals, spans


def read(r):
    if not spans.recorded(r.trace):
        return None
    merged = intervals.union(spans.named(r.trace, "caspr::adjoint"))
    return 1000.0 * sum(e - s for s, e in merged) / r.trace.calls
