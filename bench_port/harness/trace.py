"""A traced window: torch.profiler (CUPTI) over a few calls of the cell's
entry, reduced in memory to device-operation intervals and host events.
Nothing is written to disk."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import intervals

# the CNF wrappers' weight preparation (caspr_tpu_torch/csrc/cnf_tc.cuh),
# launched by each call just before its main kernel
PREP = ("split_weights_kernel", "tile_weights_kernel")


@dataclass
class Trace:
    """Times in seconds from the start of the traced window."""

    window_s: float
    calls: int
    device_ops: list = field(default_factory=list)  # (name, start, end, kind)
    host: list = field(default_factory=list)  # (name, start, end)
    results: list = field(default_factory=list)  # the traced calls' results

    def kernels(self, names=None):
        """(name, start, end) of the kernels, those whose name holds one of
        ``names`` when given."""
        return [op[:3] for op in self.device_ops if op[3] == "kernel"
                and (names is None or any(n in op[0] for n in names))]

    def wrapper_kernels(self, names, prep=PREP):
        """The kernels whose name holds one of ``names``, each with the run
        of ``prep`` kernels (its wrapper's weight preparation) launched just
        before it: all of a wrapper call's device work."""
        out, pending = [], []
        for k in sorted(self.kernels(), key=lambda k: k[1]):
            if any(n in k[0] for n in prep):
                pending.append(k)
            elif any(n in k[0] for n in names):
                out += pending + [k]
                pending = []
            else:
                pending = []
        return out

    def busy_s(self):
        return intervals.busy([(s, e) for _, s, e, _ in self.device_ops], 0.0, self.window_s)

    def top_ops(self, count=10):
        totals = {}
        for name, s, e, _ in self.device_ops:
            totals[name] = totals.get(name, 0.0) + (e - s)
        return sorted(totals.items(), key=lambda kv: -kv[1])[:count]

    def idle_by_host(self, count=10):
        idle = intervals.gaps([(s, e) for _, s, e, _ in self.device_ops], 0.0, self.window_s)
        totals = intervals.label_gaps(idle, self.host)
        return sorted(totals.items(), key=lambda kv: -kv[1])[:count]


def _kind(event) -> str:
    """"kernel", "memcpy", "memset" or "other" from a Kineto activity type."""
    name = str(event.activity_type()).lower() if hasattr(event, "activity_type") else "kernel"
    for kind in ("memcpy", "memset", "annotation"):
        if kind in name:
            return kind
    return "kernel" if "kernel" in name else "other"


def _span_ns(event):
    if hasattr(event, "start_ns"):
        return event.start_ns(), event.start_ns() + event.duration_ns()
    return event.start_us() * 1000, (event.start_us() + event.duration_us()) * 1000


def record(torch, call, calls: int) -> Trace:
    """Run ``call(i)`` for i in range(calls) under the profiler (each call
    synchronises) and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    results = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            info = call(i)
            info.pop("outputs", None)
            results.append(info)
        torch.cuda.synchronize()
    device, host = [], []
    for event in prof.profiler.kineto_results.events():
        start, end = _span_ns(event)
        if str(event.device_type()).endswith("CUDA"):
            kind = _kind(event)
            if kind != "annotation":
                device.append((event.name(), start, end, kind))
        else:
            host.append((event.name(), start, end))
    # the traced window: from the first recorded event to the last
    first = min([s for _, s, _, _ in device] + [s for _, s, _ in host])
    last = max([e for _, _, e, _ in device] + [e for _, _, e in host])
    scale = 1e-9
    trace = Trace(window_s=(last - first) * scale, calls=calls, results=results)
    trace.device_ops = [(n, (s - first) * scale, (e - first) * scale, k) for n, s, e, k in device]
    trace.host = [(n, (s - first) * scale, (e - first) * scale) for n, s, e in host]
    return trace
