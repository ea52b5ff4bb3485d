"""The per-layer metrics that read the program's spans
(``harness/spans.py``): on a trace built by hand, whose spans, launches and
device operations overlap by known amounts, and on the spans of a real
solve of caspr_tpu_torch profiled on the CPU."""

import types

import numpy as np
import pytest
import torch

from harness import core, spans
from harness.trace import Trace

BENCH = core.Path(__file__).resolve().parents[1]
READERS = ("host_reads_per_step.train", "solver_launches_per_step.train",
           "solver_idle_ms.train", "solver_idle_ms.eval", "adjoint_ms.train")


def reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "test_metric_" + name.replace(".", "_"))


def readings(trace):
    return types.SimpleNamespace(trace=trace)


# device: busy [0, 1], [2, 3.5] (two kernels overlapping), [5, 6] (a copy),
# [8, 9]; idle [1, 2], [3.5, 5], [6, 8], [9, 10]
DEVICE = [("k", 0.0, 1.0, "kernel"), ("k", 2.0, 3.0, "kernel"), ("k", 2.5, 3.5, "kernel"),
          ("copy", 5.0, 6.0, "memcpy"), ("k", 8.0, 9.0, "kernel")]
HOST = [
    ("caspr::train_step", 0.0, 4.9), ("caspr::train_step", 5.0, 10.0),
    # steps: [0.5, 2.5], [3, 4] with a step nested in it, [7, 9.5]
    ("caspr::ode.step", 0.5, 2.5), ("caspr::ode.step", 3.0, 4.0), ("caspr::ode.step", 3.2, 3.8),
    ("caspr::ode.step", 7.0, 9.5),
    ("caspr::ode.func", 0.6, 1.2), ("caspr::ode.func", 7.5, 8.5),
    ("cudaLaunchKernel", 0.55, 0.56),  # in a step, outside the evaluations: the solver's
    ("cudaLaunchKernel", 0.7, 0.71),  # inside an evaluation
    ("cudaLaunchKernelExC", 3.1, 3.11),  # the solver's
    ("cuLaunchKernel", 4.5, 4.51),  # outside every step
    ("cudaLaunchKernel_v7000", 9.2, 9.21),  # the solver's
    ("cudaMemcpyAsync", 3.3, 3.31), ("aten::mul", 1.5, 1.6),  # no launches
    ("caspr::host_read", 1.9, 2.0), ("caspr::host_read", 3.9, 4.0), ("caspr::host_read", 9.4, 9.5),
    # adjoints: [1, 1.5] and two that overlap over [6, 9]
    ("caspr::adjoint", 1.0, 1.5), ("caspr::adjoint", 6.0, 8.0), ("caspr::adjoint", 7.0, 9.0),
]


def hand_trace(host=HOST, calls=2):
    return Trace(window_s=10.0, calls=calls, device_ops=list(DEVICE), host=list(host))


@pytest.mark.parametrize("name,expected", [
    ("host_reads_per_step.train", 3 / 2),
    ("solver_launches_per_step.train", 3 / 2),
    # idle in steps: [1, 2] 1.0, [3.5, 4] 0.5, [7, 8] 1.0, [9, 9.5] 0.5
    ("solver_idle_ms.train", 1000.0 * 3.0 / 2),
    ("solver_idle_ms.eval", 1000.0 * 3.0 / 2),
    ("adjoint_ms.train", 1000.0 * 3.5 / 2),
])
def test_readers_give_the_hand_counted_values(name, expected):
    assert reader(name).read(readings(hand_trace())) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_program_spans(name):
    plain = [h for h in HOST if not h[0].startswith("caspr::")]
    assert reader(name).read(readings(None)) is None
    assert reader(name).read(readings(hand_trace(plain))) is None
    assert reader(name).read(readings(hand_trace(calls=0))) is None


def test_interval_helpers():
    merged = [(0.0, 1.0), (2.0, 3.0)]
    assert [spans.covers(merged, t) for t in (-0.1, 0.0, 0.5, 1.5, 3.0, 3.1)] == [
        False, True, True, False, True, False]
    assert spans.overlap([(0, 4), (1, 2)], [(3, 5), (-1, 0.5)]) == pytest.approx(1.5)
    assert spans.overlap([], [(0, 1)]) == 0.0


def test_readers_see_the_spans_of_a_real_solve():
    """A solve of caspr_tpu_torch profiled on the CPU (no device activity:
    the whole window is idle), reduced as harness/trace.py reduces a trace."""
    from torch.profiler import ProfilerActivity, profile

    from caspr_tpu_torch.ops.odeint import odeint

    y0 = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    ts = torch.tensor([0.0, 0.5, 1.0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, nfe = odeint(lambda t, y: torch.sin(3.0 * y) - 0.5 * y, y0, ts, rtol=1e-5, atol=1e-6)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    first = min(s for _, s, _ in events)
    host = [(n, (s - first) * 1e-9, (e - first) * 1e-9) for n, s, e in events]
    trace = Trace(window_s=max(e for _, _, e in host), calls=1, host=host)
    steps = (nfe - 2) / 6
    assert reader("host_reads_per_step.train").read(readings(trace)) == steps + 4
    assert reader("solver_launches_per_step.train").read(readings(trace)) == 0
    step_time = sum(e - s for s, e in spans.named(trace, "caspr::ode.step"))
    assert reader("solver_idle_ms.eval").read(readings(trace)) == pytest.approx(
        1000.0 * step_time, rel=1e-9)
    assert reader("adjoint_ms.train").read(readings(trace)) == 0.0
    assert np.isfinite(step_time) and step_time > 0
