"""Interval arithmetic for device traces: the union of kernel intervals
(kernels that overlap count once), the gaps between them, and the host
activity under each gap."""

from __future__ import annotations

import bisect


def union(intervals):
    """Sorted, disjoint (start, end) pairs covering the same time."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def busy(intervals, lo, hi):
    """Time within [lo, hi] that at least one interval covers."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in union(intervals) if e > lo and s < hi)


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def label_gaps(gap_list, host_events):
    """{host label: idle time}: each gap's time under the innermost host
    event (name, start, end) covering its midpoint, or, where none does,
    under "python between operators"."""
    events = sorted(host_events, key=lambda ev: ev[1])
    starts = [ev[1] for ev in events]
    totals = {}
    for s, e in gap_list:
        mid = (s + e) / 2
        name = "python between operators"
        # the innermost covering event starts latest: scan back a bounded way
        i = bisect.bisect_right(starts, mid)
        for ev in reversed(events[max(0, i - 4000):i]):
            if ev[2] >= mid:
                name = ev[0]
                break
        totals[name] = totals.get(name, 0) + (e - s)
    return totals
