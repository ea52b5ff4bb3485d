"""The program's spans in a traced window, for the per-layer metrics that
read them.  caspr_tpu_torch records each span (``caspr::<boundary>``,
``caspr_tpu_torch/utils/profiling.py::annotate``) as a host event on the
clock of the device trace, so the spans sit in ``Trace.host`` beside the
runtime's kernel launches and line up with ``Trace.device_ops``.  A program
that records no span (an older commit) gives the readers nothing."""

from __future__ import annotations

import bisect

from . import intervals

PREFIX = "caspr::"
# kernel launches through the CUDA runtime (cuda*) and its lower-level API
# (cu*), as the trace names them
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def recorded(trace) -> bool:
    """Whether the traced window holds a span of the program."""
    return trace is not None and trace.calls > 0 and any(
        name.startswith(PREFIX) for name, _, _ in trace.host)


def named(trace, name: str):
    """(start, end) of the spans called ``name``."""
    return [(s, e) for n, s, e in trace.host if n == name]


def launch_starts(trace):
    """Start times of the kernel launches (a versioned name, such as
    ``cudaLaunchKernel_v7000``, counts as its base name)."""
    return [s for n, s, _ in trace.host if n.split("_v")[0] in LAUNCHES]


def covers(merged, t) -> bool:
    """Whether ``t`` lies in one of ``merged``, sorted disjoint intervals
    (``intervals.union``)."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def overlap(a, b) -> float:
    """Time that both interval lists cover (each list's overlaps once)."""
    a, b = intervals.union(a), intervals.union(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle(trace):
    """The window's stretches with no device operation."""
    return intervals.gaps([(s, e) for _, s, e, _ in trace.device_ops], 0.0, trace.window_s)


def solver_idle_ms(trace):
    """Milliseconds a call of device idle inside the solver's steps."""
    if not recorded(trace):
        return None
    idle = overlap(device_idle(trace), named(trace, "caspr::ode.step"))
    return 1000.0 * idle / trace.calls
