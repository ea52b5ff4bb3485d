"""The program's spans (``caspr_tpu_torch/utils/profiling.py::annotate``) on
the CPU: off, ``annotate`` records nothing and the program makes no
RecordFunction; under torch.profiler each span is a host event and not a
user annotation (which the profiler would also lay over the device
timeline), each dopri5 solve, adjoint and train step records the spans its
NFE predicts, nested as its calls are, and the results are bit-identical
with the profiler on and off.

Span counts of a solve of NFE 2 + 6 s (``ops/odeint.py``): s
``caspr::ode.step``, 2 + 6 s ``caspr::ode.func``, s + 3
``caspr::host_read`` (one a norm: three for the initial step, one a step),
+ 1 where ts is a tensor.  An adjoint's backward of K request intervals
reads ts once and solves K augmented problems, each of NFE 2 + 6 s_i, and
evaluates the dynamics K + 1 times beside them: its NFE is 1 + sum(3 +
6 s_i), its host reads 1 + sum(s_i + 3).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
from caspr_tpu_torch.ops.odeint import NFESink, flatten_tree, odeint, odeint_adjoint
from caspr_tpu_torch.train.loop import make_optimizer, make_train_step
from caspr_tpu_torch.utils import profiling

RTOL, ATOL = 1e-5, 1e-6

TINY = dict(radii_list=(0.1, 0.2, 0.3, 0.4, 0.6, 0.8), local_feat_size=32, latent_feat_size=48,
            ode_hidden_size=32, motion_feat_size=16, global_feat_size=32,
            cnf_dims=(32, 32, 32), sa_points=(32, 16, 8, 4, 3), ball_samples=(4, 8))
B, T, N = 2, 3, 32


def _spans(prof):
    """[(name, start_ns, end_ns)] of the program's spans in a profile."""
    out = []
    for event in prof.profiler.kineto_results.events():
        if event.name().startswith("caspr::"):
            out.append((event.name(), event.start_ns(), event.start_ns() + event.duration_ns()))
    return out


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(span, outer):
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


def _field(t, y):
    """A nonlinear field, so that the solver's steps vary."""
    return torch.sin(3.0 * y) * (1.0 + float(t)) - 0.5 * y


def _state():
    gen = torch.Generator().manual_seed(3)
    return torch.randn(4, 6, generator=gen)


def _request_times(kind):
    times = np.array([0.0, 0.3, 0.7, 1.2], np.float32)
    return torch.from_numpy(times) if kind == "tensor" else times


def _solve(state_kind, ts_kind):
    y0 = _state()
    if state_kind == "tuple":
        ys, nfe = odeint(lambda t, y: (_field(t, y[0]), -y[1]), (y0, y0[:, :2].clone()),
                         _request_times(ts_kind), rtol=RTOL, atol=ATOL)
        return ys, nfe
    ys, nfe = odeint(_field, y0, _request_times(ts_kind), rtol=RTOL, atol=ATOL)
    return (ys,), nfe


def test_annotate_off_enters_no_record_function(monkeypatch):
    entered = []
    fast = torch._C._profiler._RecordFunctionFast

    def counting(*args):
        entered.append(args)
        return fast(*args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.annotate("caspr::a") is profiling.annotate("caspr::b")
    _solve("tensor", "tensor")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("caspr::on"):
            pass
    assert entered == [("caspr::on",)]


@pytest.mark.parametrize("api", ["torch.profiler", "torch.autograd.profiler"])
def test_annotate_on_records_a_span(api):
    if api == "torch.profiler":
        recorder = profile(activities=[ProfilerActivity.CPU])
    else:
        recorder = torch.autograd.profiler.profile()
    with recorder as prof:
        with profiling.annotate("caspr::probe"):
            torch.ones(8) * 2
    assert any(e.key == "caspr::probe" for e in prof.key_averages())
    assert profiling.annotate("caspr::probe") is profiling.annotate("caspr::other")
    results = prof.profiler.kineto_results if api == "torch.profiler" else prof.kineto_results
    (span,) = [e for e in results.events() if e.name() == "caspr::probe"]
    assert not span.is_user_annotation()


@pytest.mark.parametrize("ts_kind", ["numpy", "tensor"])
@pytest.mark.parametrize("state_kind", ["tensor", "tuple"])
def test_a_solve_records_the_spans_its_nfe_gives(state_kind, ts_kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, nfe = _solve(state_kind, ts_kind)
    spans = _spans(prof)
    steps = (nfe - 2) / 6
    assert steps == int(steps) and steps > 3
    assert len(_named(spans, "caspr::ode.solve")) == 1
    assert len(_named(spans, "caspr::ode.func")) == nfe
    assert len(_named(spans, "caspr::ode.step")) == steps
    assert len(_named(spans, "caspr::host_read")) == steps + 3 + (ts_kind == "tensor")


def test_evaluations_lie_in_a_step_or_the_solve():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve("tensor", "tensor")
    spans = _spans(prof)
    solve, steps = _named(spans, "caspr::ode.solve"), _named(spans, "caspr::ode.step")
    funcs = _named(spans, "caspr::ode.func")
    assert all(_inside(s, solve) for s in steps + funcs + _named(spans, "caspr::host_read"))
    outside = [f for f in funcs if not _inside(f, steps)]
    assert len(outside) == 2  # f0 and the initial step's probe
    assert all(f[2] <= steps[0][1] for f in outside)
    assert sum(_inside(f, steps) for f in funcs) == 6 * len(steps)


def _adjoint_run(intervals):
    """An adjoint solve of ``intervals`` request intervals and its backward:
    (outputs, forward NFE, backward NFE, gradients)."""
    y0 = _state().requires_grad_()
    scale = torch.tensor([1.0, 0.5], requires_grad=True)
    ts = torch.linspace(0.0, 1.0, intervals + 1)
    sink = NFESink()
    ys, nfe = odeint_adjoint(lambda t, y, a: _field(t, y) * a[0][0] - a[0][1] * y, y0, ts,
                             (scale,), rtol=RTOL, atol=ATOL, nfe_sink=sink)
    grads = torch.autograd.grad((ys * torch.cos(ys)).sum(), (y0, scale))
    return ys.detach(), nfe, sink.value, grads


@pytest.mark.parametrize("intervals", [1, 3])
def test_an_adjoint_records_its_intervals_and_reads(intervals):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, nfe, nfe_bwd, _ = _adjoint_run(intervals)
    spans = _spans(prof)
    (adjoint,) = _named(spans, "caspr::adjoint")
    pieces = _named(spans, "caspr::adjoint.interval")
    assert len(pieces) == intervals and all(_inside(p, [adjoint]) for p in pieces)
    solves = _named(spans, "caspr::ode.solve")
    assert len(solves) == 1 + intervals
    assert sum(_inside(s, pieces) for s in solves) == intervals
    # the backward's steps from its NFE: 1 + sum over intervals of (3 + 6 s_i)
    steps_bwd = (nfe_bwd - 1 - 3 * intervals) / 6
    steps_fwd = (nfe - 2) / 6
    assert steps_bwd == int(steps_bwd) and steps_fwd == int(steps_fwd)
    assert len(_named(spans, "caspr::ode.step")) == steps_fwd + steps_bwd
    # plain evaluations: one at each request interval's top and one at ts[0]
    funcs_bwd = [f for f in _named(spans, "caspr::ode.func") if _inside(f, [adjoint])]
    assert len(funcs_bwd) == nfe_bwd
    reads = _named(spans, "caspr::host_read")
    assert len(reads) == (steps_fwd + 3 + 1) + (1 + steps_bwd + 3 * intervals)


@pytest.mark.parametrize("run", ["solve", "adjoint"])
def test_results_are_bit_identical_with_the_profiler_on(run):
    def once():
        if run == "solve":
            ys, nfe = _solve("tuple", "tensor")
            return list(ys), (nfe,)
        ys, nfe, nfe_bwd, grads = _adjoint_run(3)
        return [ys, *grads], (nfe, nfe_bwd)

    off = once()
    with profile(activities=[ProfilerActivity.CPU]):
        on = once()
    assert off[1] == on[1]
    assert all(torch.equal(a, b) for a, b in zip(off[0], on[0]))


def _train_case(ode_backward, accum_steps):
    """A tiny train step's pieces, the same on every call: (step, params,
    optimizer, state, x, target, noise)."""
    torch.manual_seed(0)
    cfg = CaSPRConfig(**TINY)
    model = CaSPRModel(cfg, device="cpu")
    params, state = caspr_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    gen = torch.Generator().manual_seed(7)
    target = torch.rand(B, T, N, 4, generator=gen) * 0.3
    target[..., 3] = torch.linspace(0.0, 1.0, T)[None, :, None]
    x = target.clone()
    x[..., 3] *= 5.0
    noise = torch.randn(B * T, N, 3, generator=gen)
    tx = make_optimizer(1e-3)
    step = make_train_step(model, tx, 0.01, 100.0, accum_steps=accum_steps,
                           ode_backward=ode_backward)
    return step, params, tx.init(params), state, x, target, noise


TRAIN_CASES = [("adjoint", 1), ("adjoint", 2), ("discrete", 1)]


@pytest.mark.parametrize("ode_backward,accum_steps", TRAIN_CASES)
def test_a_train_step_records_its_stages_and_the_adjoint_inside_its_backward(
        ode_backward, accum_steps):
    step, params, opt, state, x, target, noise = _train_case(ode_backward, accum_steps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, _, metrics = step(params, opt, state, x, target, e=noise)
    spans = _spans(prof)
    (whole,) = _named(spans, "caspr::train_step")
    forward = _named(spans, "caspr::train_step.forward")
    backward = _named(spans, "caspr::train_step.backward")
    (update,) = _named(spans, "caspr::train_step.update")
    assert len(forward) == len(backward) == accum_steps
    assert all(_inside(s, [whole]) for s in forward + backward + [update])
    for name in ("caspr::encode", "caspr::latent", "caspr::likelihood"):
        layer = _named(spans, name)
        assert len(layer) == accum_steps and all(_inside(s, forward) for s in layer)
    adjoints = _named(spans, "caspr::adjoint")
    pieces = _named(spans, "caspr::adjoint.interval")
    if ode_backward == "discrete":
        assert adjoints == [] and pieces == []
        return
    # per microbatch the latent ODE's adjoint and the CNF's
    assert len(adjoints) == 2 * accum_steps
    assert all(_inside(a, backward) for a in adjoints)
    assert all(_inside(p, adjoints) for p in pieces)
    rows = B // accum_steps
    # the latent ODE's request times are the rows' T times, sorted and
    # flattened; the CNF's one interval runs from 0 to its end time
    assert len(pieces) == accum_steps * ((rows * T - 1) + 1)
    # host reads: each forward solve's steps + 3 + its tensor ts; each
    # backward's 1 + steps + 3 an interval; the four logged scalars and the
    # two T-NOCS errors of each microbatch
    nfe_fwd, nfe_all = sum(metrics["nfe_forward"]), sum(metrics["nfe"])
    intervals = len(pieces)
    solves_fwd = 2 * accum_steps
    steps_fwd = (nfe_fwd - 2 * solves_fwd) / 6
    steps_bwd = (nfe_all - nfe_fwd - len(adjoints) - 3 * intervals) / 6
    reads = _named(spans, "caspr::host_read")
    assert len(reads) == (steps_fwd + 4 * solves_fwd + len(adjoints) + steps_bwd
                          + 3 * intervals + 6 * accum_steps)
    assert len(_named(spans, "caspr::ode.step")) == steps_fwd + steps_bwd


def test_a_train_step_is_bit_identical_with_the_profiler_on():
    def once():
        step, params, opt, state, x, target, noise = _train_case("adjoint", 1)
        for _ in range(2):
            params, opt, state, metrics = step(params, opt, state, x, target, e=noise)
        return params, metrics

    off_params, off = once()
    with profile(activities=[ProfilerActivity.CPU]):
        on_params, on = once()
    assert off == on
    leaves_off, _ = flatten_tree(off_params)
    leaves_on, _ = flatten_tree(on_params)
    assert all(torch.equal(a, b) for a, b in zip(leaves_off, leaves_on))
