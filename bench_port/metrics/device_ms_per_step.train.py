"""Device milliseconds a training step: the union of the device operations'
intervals in the traced steps over the steps.  Steadier than the host's
rate, which the step's host-driven launches make spread."""


def read(r):
    if r.trace is None or r.trace.calls == 0:
        return None
    return 1000.0 * r.trace.busy_s() / r.trace.calls
