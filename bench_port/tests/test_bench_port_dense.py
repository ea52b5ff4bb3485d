"""``dense_launches_per_call.eval``, the launches of the solver's dense
output a call: on a trace built by hand, and nothing (not 0) on a trace
without a ``caspr::ode.dense`` span, as a program that records none gives."""

import types

import pytest

from harness import core
from harness.trace import Trace

BENCH = core.Path(__file__).resolve().parents[1]
NAME = "dense_launches_per_call.eval"

HOST = [
    ("caspr::ode.solve", 0.0, 10.0),
    ("caspr::ode.step", 0.5, 2.5), ("caspr::ode.step", 3.0, 6.0), ("caspr::ode.step", 7.0, 9.5),
    # dense outputs: [1.5, 2.4] and two that overlap over [4, 5.5]
    ("caspr::ode.dense", 1.5, 2.4), ("caspr::ode.dense", 4.0, 5.0), ("caspr::ode.dense", 4.5, 5.5),
    ("caspr::ode.func", 0.6, 1.2),
    ("cudaLaunchKernel", 0.7, 0.71),  # in an evaluation
    ("cudaLaunchKernel", 1.6, 1.61), ("cudaLaunchKernel_v7000", 2.3, 2.31),  # dense
    ("cudaLaunchKernelExC", 4.2, 4.21), ("cuLaunchKernel", 4.7, 4.71),  # dense, overlap
    ("cudaLaunchKernel", 5.4, 5.41),  # dense
    ("cudaLaunchKernel", 5.7, 5.71),  # in a step, after its dense output
    ("cudaMemcpyAsync", 1.8, 1.81), ("aten::mul", 1.9, 1.95),  # no launches
    ("cudaLaunchKernel", 9.7, 9.71),  # outside every step
]


def read(host, calls=2):
    module = core.load_module(BENCH / "metrics" / f"{NAME}.py", "test_metric_dense")
    trace = Trace(window_s=10.0, calls=calls, device_ops=[("k", 0.0, 1.0, "kernel")],
                  host=list(host))
    return module.read(types.SimpleNamespace(trace=trace))


def test_the_hand_counted_launches_a_call():
    assert read(HOST) == pytest.approx(5 / 2, rel=1e-12)
    assert read(HOST, calls=5) == pytest.approx(5 / 5, rel=1e-12)


@pytest.mark.parametrize("case", ["no_dense_span", "no_program_span", "no_calls"])
def test_nothing_without_a_dense_span(case):
    host = {"no_dense_span": [h for h in HOST if h[0] != "caspr::ode.dense"],
            "no_program_span": [h for h in HOST if not h[0].startswith("caspr::")],
            "no_calls": HOST}[case]
    assert read(host, calls=0 if case == "no_calls" else 2) is None
