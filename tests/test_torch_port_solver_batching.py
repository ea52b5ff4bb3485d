"""The dopri5 solver's batched arithmetic (``caspr_tpu_torch/ops/odeint.py``):
each step's stage sums, error ratio and initial step issued once over every
leaf (``torch._foreach_*``), and one dense output for every request time a
step reaches.  ``_plain_solve`` below is the solver as it was before,
leaf by leaf and time by time; the batched one must give the same bits and
the same NFE:

  - one leaf at 160 sorted request times, with repeats, times equal to
    ts[0] and times inside the slack past the last one, ts on the host and
    as a tensor;
  - a 10-leaf augmented state of mixed shapes (the latent adjoint's: z, its
    adjoint, 8 parameter leaves) and a 2-leaf likelihood state;
  - ``odeint_discrete`` with ts requiring grad: outputs bit-equal, the
    gradients of y0 and ts within 1e-6 relative (autograd sums a repeated
    output's cotangents in another order).

Under torch.profiler on the CPU the dispatched operations that launch work
(views and allocations aside) inside ``caspr::ode.step`` and outside
``caspr::ode.func`` grow by at most 3 a step per added leaf (10 leaves
against 1), a lone leaf issues no multi-tensor operation, and every
``caspr::ode.dense`` span holds the same number at 10 and at 160 request
times.

On a card (skipping without one): bit-equal and NFE-equal at the recon
latent shape (16 x 64, 160 request times on the card) and at the latent
adjoint's 10 leaves, and multi-tensor kernels launched inside the steps.
Run there with ``python -m pytest --noconftest -q
tests/test_torch_port_solver_batching.py``.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ode = importlib.import_module("caspr_tpu_torch.ops.odeint")
F32 = np.float32
RTOL, ATOL = 1e-5, 1e-6


# ---- the solver leaf by leaf and time by time, frozen -----------------------

def _plain_weighted_sum(coeffs, ks):
    out = [float(coeffs[0]) * k for k in ks[0]]
    for c, k in zip(coeffs[1:], ks[1:]):
        out = [o + float(c) * leaf for o, leaf in zip(out, k)]
    return out


def _plain_axpy(y, h, d):
    return tuple(a + float(h) * b for a, b in zip(y, d))


def _plain_norm(leaves):
    rms = [torch.sqrt(torch.mean(torch.square(leaf))) for leaf in leaves]
    value = rms[0] if len(rms) == 1 else torch.stack(rms).max()
    return F32(value.item())


def _plain_error_ratio(err, y0, y1, rtol, atol):
    return _plain_norm([e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
                        for e, a, b in zip(err, y0, y1)])


def _plain_initial_step(func, t0, y0, f0, rtol, atol):
    scale = [atol + rtol * y.abs() for y in y0]
    d0 = _plain_norm([y / s for y, s in zip(y0, scale)])
    d1 = _plain_norm([f / s for f, s in zip(f0, scale)])
    h0 = F32(1e-6) if d0 < F32(1e-5) or d1 < F32(1e-5) else F32(0.01) * d0 / d1
    f1 = func(t0 + h0, _plain_axpy(y0, h0, f0))
    d2 = _plain_norm([(a - b) / s for a, b, s in zip(f1, f0, scale)]) / h0
    dmax = max(d1, d2)
    h1 = max(F32(1e-6), h0 * F32(1e-3)) if dmax <= F32(1e-15) else (F32(0.01) / dmax) ** F32(0.2)
    return min(F32(100.0) * h0, h1)


def _plain_dense_output(y0, y1, y_mid, f0, f1, h, theta):
    hf0 = float(h) * f0
    hf1 = float(h) * f1
    a = y1 - y0 - hf0
    b = y_mid - y0 - 0.5 * hf0
    c = hf1 - hf0
    c4 = -8.0 * a + 16.0 * b + 2.0 * c
    c3 = 14.0 * a - 32.0 * b - 3.0 * c
    c2 = -5.0 * a + 16.0 * b + c
    th = theta if isinstance(theta, torch.Tensor) else float(theta)
    return y0 + th * (hf0 + th * (c2 + th * (c3 + th * c4)))


def _plain_solve(func, y0, ts, rtol, atol, max_steps):
    single = isinstance(y0, torch.Tensor)
    y0 = (y0,) if single else tuple(y0)
    state_func = func

    def func(t, y):
        return (state_func(t, y[0]),) if single else state_func(t, y)

    ts_grad = None
    if isinstance(ts, torch.Tensor):
        if ts.requires_grad and torch.is_grad_enabled():
            ts_grad = ts
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=F32)
    t, t_final = ts[0], ts[-1]
    f = func(t, y0)
    with torch.no_grad():
        h = _plain_initial_step(func, t, y0, f, rtol, atol)
    y = y0
    filled = ts <= t
    outs = [y0 if done else None for done in filled]
    nfe, steps = 2.0, 0
    while not filled.all() and steps < max_steps and t < t_final:
        ks = [f]
        for i in range(6):
            ks.append(func(t + ode._C[i + 1] * h, _plain_axpy(y, h, _plain_weighted_sum(ode._A[i], ks))))
        y1 = _plain_axpy(y, h, _plain_weighted_sum(ode._B, ks))
        with torch.no_grad():
            err = [float(h) * d for d in _plain_weighted_sum(ode._B_ERR, ks)]
            ratio = _plain_error_ratio(err, y, y1, rtol, atol)
        accept = bool(ratio <= F32(1.0))
        t1 = t + h
        if accept:
            slack = F32(1e-6) * max(F32(1.0), abs(t1))
            newly = ~filled & (ts <= t1 + slack)
            if newly.any():
                y_mid = _plain_axpy(y, h, _plain_weighted_sum(ode._C_MID, ks))
                h_div = max(h, F32(1e-30))
                thetas = np.clip((ts - t) / h_div, F32(0.0), F32(1.0))
                for i in np.flatnonzero(newly):
                    theta = (thetas[i] if ts_grad is None else
                             torch.clamp((ts_grad[i] - float(t)) / float(h_div), 0.0, 1.0))
                    outs[i] = tuple(_plain_dense_output(*leaves, h, theta)
                                    for leaves in zip(y, y1, y_mid, f, ks[6]))
                filled = filled | newly
            t, y, f = t1, y1, ks[6]
        h = ode._optimal_step(h, ratio, accept)
        nfe += 6.0
        steps += 1
    outs = [y if o is None else o for o in outs]
    stacked = tuple(torch.stack([o[leaf] for o in outs]) for leaf in range(len(y0)))
    return (stacked[0] if single else stacked), nfe, bool(filled.all())


# ---- problems ----------------------------------------------------------------

def _field(t, y):
    """A nonlinear field, so that the solver's steps vary."""
    return torch.sin(3.0 * y) * (1.0 + float(t)) - 0.5 * y


def _request_times(count, seed=0, end=2.0):
    """``count`` sorted times in [0, end]: three at ts[0], repeats, the end
    time twice and once more inside the slack past it."""
    rng = np.random.default_rng(seed)
    inner = np.round(rng.uniform(0.0, end, count - 6), 2)  # rounded: repeats
    tail = [end, end, end + 2.5e-7 * max(1.0, end)]
    return np.sort(np.concatenate([[0.0, 0.0, 0.0], inner, tail])).astype(F32)


def _leaves(shapes, device="cpu", seed=1):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=gen).to(device) for s in shapes)


# the latent adjoint's augmented state: z and its adjoint (B, H), then the
# adjoints of the latent ODE's 4 linear layers' weights and biases
AUGMENTED = [(5, 8), (5, 8), (8, 16), (16,), (16, 16), (16,), (16, 16), (16,), (16, 8), (8,)]
LIKELIHOOD = [(3, 24), (3, 8)]


def _tree_field(t, y):
    return tuple(_field(t, leaf) * (1.0 + 0.1 * i) for i, leaf in enumerate(y))


def _both(func, y0, ts, max_steps=50_000):
    batched = ode._solve(func, y0, ts, RTOL, ATOL, max_steps)
    plain = _plain_solve(func, y0, ts, RTOL, ATOL, max_steps)
    return batched, plain


def _equal(a, b):
    a = (a,) if isinstance(a, torch.Tensor) else a
    b = (b,) if isinstance(b, torch.Tensor) else b
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ---- the batched solver against the plain one --------------------------------

@pytest.mark.parametrize("ts_kind", ["numpy", "tensor"])
def test_one_leaf_at_160_request_times(ts_kind):
    ts = _request_times(160)
    assert len(ts) == 160 and len(np.unique(ts)) < 160
    (ys, nfe, reached), (ys_p, nfe_p, reached_p) = _both(
        _field, _leaves([(16, 12)])[0], torch.from_numpy(ts) if ts_kind == "tensor" else ts)
    assert nfe == nfe_p and nfe > 20 and reached and reached_p
    assert ys.shape == (160, 16, 12) and _equal(ys, ys_p)


@pytest.mark.parametrize("ts_kind", ["numpy", "tensor"])
@pytest.mark.parametrize("shapes", [AUGMENTED, LIKELIHOOD], ids=["augmented10", "likelihood2"])
def test_many_leaves(shapes, ts_kind):
    ts = np.array([0.0, 0.4, 1.3], F32)
    (ys, nfe, _), (ys_p, nfe_p, _) = _both(
        _tree_field, _leaves(shapes), torch.from_numpy(ts) if ts_kind == "tensor" else ts)
    assert nfe == nfe_p and nfe > 20
    assert [tuple(y.shape) for y in ys] == [(3, *s) for s in shapes] and _equal(ys, ys_p)


def test_step_bound_and_mixed_dtypes():
    """Unreached request times take the final state; leaves of two dtypes
    take the dense output one by one."""
    y0 = (_leaves([(4, 6)])[0], _leaves([(3,)], seed=2)[0].double())
    ts = _request_times(20)
    (ys, nfe, reached), (ys_p, nfe_p, reached_p) = _both(_tree_field, y0, ts, max_steps=3)
    assert nfe == nfe_p == 20.0 and not reached and not reached_p
    assert _equal(ys, ys_p) and torch.equal(ys[0][-1], ys[0][-2])


def test_decreasing_request_times_are_refused():
    with pytest.raises(ValueError, match="non-decreasing"):
        ode.odeint(_field, torch.ones(2), np.array([0.0, 1.0, 0.5], F32), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shapes", [[(4, 6)], LIKELIHOOD], ids=["one_leaf", "likelihood2"])
def test_discrete_with_differentiable_request_times(shapes):
    def run(solve):
        y0 = _leaves(shapes)
        y0 = tuple(leaf.requires_grad_() for leaf in y0)
        ts = torch.tensor([0.0, 0.3, 0.3, 0.9, 1.7], requires_grad=True)
        ys, nfe, _ = solve(_tree_field, y0, ts, RTOL, ATOL, ode.DISCRETE_STEPS)
        weights = _leaves([tuple(y.shape) for y in ys], seed=4)
        loss = sum((y * w).sum() for y, w in zip(ys, weights))
        return [y.detach() for y in ys], nfe, torch.autograd.grad(loss, (*y0, ts))

    ys, nfe, grads = run(ode._solve)
    ys_p, nfe_p, grads_p = run(_plain_solve)
    assert nfe == nfe_p and _equal(ys, ys_p)
    for g, g_p in zip(grads, grads_p):
        assert torch.allclose(g, g_p, rtol=1e-6, atol=1e-6 * g_p.abs().max().item())


def _refused_lists(monkeypatch):
    """The foreach calls of ``ode`` whose lists CUDA's multi-tensor path
    refuses (it then runs tensor by tensor): mixed dtypes, a tensor whose
    elements do not fill one block of memory, unequal strides between the
    lists."""
    refused, real = [], torch

    def fills_block(t):
        size = 1
        for stride, n in sorted((st, n) for st, n in zip(t.stride(), t.shape) if n != 1):
            if stride != size:
                return False
            size *= n
        return True

    def same_layout(u, v):
        return u.shape == v.shape and all(a == b for a, b, n in zip(u.stride(), v.stride(), u.shape)
                                          if n != 1)

    class Recording(type(torch)):
        def __getattr__(self, name):
            fn = getattr(real, name)
            if not name.startswith("_foreach_"):
                return fn

            def call(*args):
                lists = [a for a in args if isinstance(a, (list, tuple))]
                flat = [t for lst in lists for t in lst]
                if (len({t.dtype for t in flat}) > 1 or not all(map(fills_block, flat))
                        or not all(same_layout(u, v) for lst in lists[1:] for u, v in zip(lists[0], lst))):
                    refused.append(name)
                return fn(*args)
            return call

    monkeypatch.setattr(ode, "torch", Recording("recording_torch"))
    return refused


def test_sliced_leaves_keep_every_list_on_the_multi_tensor_path(monkeypatch):
    """A state and a field whose leaves are column slices of one buffer, as
    the CNF's are: the solver lays them out whole, bit-equal."""
    def field(t, y):
        out = torch.cat([_field(t, y[0]), -0.3 * y[1], torch.zeros(4, 1)], dim=1)
        return out[:, :6], out[:, 6:8]

    buffer = _leaves([(4, 9)])[0]
    y0 = (buffer[:, :6], buffer[:, 6:8])
    ts = torch.tensor([0.0, 0.5, 1.0])
    plain = _plain_solve(field, y0, ts, RTOL, ATOL, 50_000)
    refused = _refused_lists(monkeypatch)
    ys, nfe, _ = ode._solve(field, y0, ts, RTOL, ATOL, 50_000)
    assert refused == [] and nfe == plain[1] and _equal(ys, plain[0])


def _adjoint_like_field(t, y):
    """Like an adjoint's augmented dynamics: the second leaf, integrated but
    not read, comes back transposed in memory, as autograd returns the
    adjoint of a weight used as ``W.T``."""
    dz = _field(t, y[0])
    return dz, (dz[:, :4].T @ y[0][:, :5]).T.contiguous().T


def test_leaves_returned_in_another_layout(monkeypatch):
    """Bit-equal; the state takes the dynamics' layout after a step, so
    later steps' lists agree: the refused multi-tensor calls do not grow
    with the number of steps."""
    y0 = (_leaves([(6, 5)])[0], torch.zeros(4, 5))
    ts = np.array([0.0, 0.6, 1.5], F32)
    ys, nfe, _ = ode._solve(_adjoint_like_field, y0, ts, RTOL, ATOL, 50_000)
    ys_p, nfe_p, _ = _plain_solve(_adjoint_like_field, y0, ts, RTOL, ATOL, 50_000)
    assert nfe == nfe_p and _equal(ys, ys_p)
    refused = _refused_lists(monkeypatch)
    counts = []
    for end in (0.3, 1.5):
        refused.clear()
        _, nfe, _ = ode._solve(_adjoint_like_field, y0, np.array([0.0, end], F32), RTOL, ATOL,
                               50_000)
        counts.append((nfe, len(refused)))
    assert counts[0][0] < counts[1][0] and counts[0][1] == counts[1][1], counts


# ---- launches: what a step costs per leaf, what a dense output costs ----------

# dispatched operations that launch no work
NO_LAUNCH = {"aten::view", "aten::reshape", "aten::_reshape_alias", "aten::slice", "aten::select",
             "aten::expand", "aten::unsqueeze", "aten::as_strided", "aten::alias", "aten::detach",
             "aten::detach_", "aten::lift_fresh", "aten::_unsafe_view", "aten::to", "aten::empty",
             "aten::empty_like", "aten::empty_strided", "aten::resize_"}


def _ops_per_span(prof, span):
    """[the launching operations dispatched inside each ``span``] (outside
    the dynamics' evaluations): outermost ones only, a foreach op counting
    once, from the nesting of the trace's host events in time."""
    events = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CPU),
                    key=lambda e: (e[0], -e[1]))
    counts, open_, launching = {}, [], {}
    for start, end, name in events:
        while open_ and open_[-1][1] <= start:
            open_.pop()
        names = [o[2] for o in open_]
        if span in names and "caspr::ode.func" not in names:
            outer = next((o for o in open_ if o[2].startswith("aten::")), None)
            if outer is None and name.startswith("aten::"):
                key = next(o for o in reversed(open_) if o[2] == span)[:2]
                counts.setdefault(key, []).append((start, end))
                launching[(start, end)] = name not in NO_LAUNCH
            elif outer is not None and name not in NO_LAUNCH:
                launching[outer[:2]] = True
        if span == name:
            counts.setdefault((start, end), [])
        open_.append((start, end, name))
    return [sum(launching[op] for op in ops) for _, ops in sorted(counts.items())]


def _profiled(func, y0, ts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, nfe = ode.odeint(func, y0, ts, rtol=RTOL, atol=ATOL)
    return prof, nfe


def _alike_field(t, y):
    """``_field`` on every leaf alike, one multi-tensor op at a time (a
    short trace): identical leaves take the steps of one."""
    out = torch._foreach_sin(torch._foreach_mul(y, 3.0))
    torch._foreach_mul_(out, 1.0 + float(t))
    return tuple(torch._foreach_sub(out, torch._foreach_mul(y, 0.5)))


def test_a_step_grows_by_at_most_three_operations_a_leaf():
    leaf = _leaves([(6, 5)])[0]
    counts = {}
    for n in (1, 10):
        prof, nfe = _profiled(_alike_field, tuple(leaf.clone() for _ in range(n)),
                              np.array([0.0, 0.25], F32))
        steps = _ops_per_span(prof, "caspr::ode.step")
        assert len(steps) == (nfe - 2) / 6 > 3
        counts[n] = (nfe, sum(steps) / len(steps))
    assert counts[1][0] == counts[10][0] and counts[1][1] > 60
    assert (counts[10][1] - counts[1][1]) / 9 <= 3.0, counts


@pytest.mark.parametrize("leaves", [1, 2])
def test_a_lone_leaf_takes_the_plain_ops(leaves):
    """One leaf issues the tensor's own ops, as the leaf-by-leaf solver did;
    two or more, multi-tensor ones."""
    prof, _ = _profiled(_tree_field, _leaves([(6, 5)] * leaves), np.array([0.0, 0.25], F32))
    foreach = [e.name for e in prof.events() if e.name.startswith("aten::_foreach_")]
    assert (len(foreach) > 0) == (leaves > 1), sorted(set(foreach))


def test_a_dense_output_costs_the_same_at_10_and_160_request_times():
    per_span = {}
    for count in (10, 160):
        prof, _ = _profiled(_field, _leaves([(6, 5)])[0],
                            torch.from_numpy(_request_times(count, seed=3, end=0.7)))
        dense = _ops_per_span(prof, "caspr::ode.dense")
        assert len(dense) >= 2
        per_span[count] = set(dense)
    assert len(per_span[10]) == 1 and per_span[10] == per_span[160], per_span


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mlp_field(device, width, hidden=128, seed=5):
    """A latent-ODE-like field: tanh MLP, width -> hidden -> width."""
    gen = torch.Generator().manual_seed(seed)
    w1 = (torch.randn(width, hidden, generator=gen) / width ** 0.5).to(device)
    w2 = (torch.randn(hidden, width, generator=gen) / hidden ** 0.5).to(device)
    return lambda t, z: torch.tanh(z @ w1) @ w2


def test_card_recon_latent_shape_is_bit_equal(cuda):
    ts = torch.from_numpy(_request_times(160)).to(cuda)
    field = _mlp_field(cuda, 64)
    (ys, nfe, _), (ys_p, nfe_p, _) = _both(field, _leaves([(16, 64)], cuda)[0], ts)
    assert nfe == nfe_p and ys.shape == (160, 16, 64) and _equal(ys, ys_p)


@pytest.mark.parametrize("ts_kind", ["numpy", "tensor"])
def test_card_augmented_leaves_are_bit_equal(cuda, ts_kind):
    ts = np.array([0.0, 0.6], F32)
    y0 = _leaves(AUGMENTED, cuda)
    (ys, nfe, _), (ys_p, nfe_p, _) = _both(
        _tree_field, y0, torch.from_numpy(ts).to(cuda) if ts_kind == "tensor" else ts)
    assert nfe == nfe_p and _equal(ys, ys_p)


def test_card_leaves_returned_in_another_layout_are_bit_equal(cuda):
    y0 = (_leaves([(6, 5)], cuda)[0], torch.zeros(4, 5, device=cuda))
    ts = np.array([0.0, 0.6, 1.5], F32)
    (ys, nfe, _), (ys_p, nfe_p, _) = _both(_adjoint_like_field, y0, ts)
    assert nfe == nfe_p and _equal(ys, ys_p)


def test_card_discrete_request_time_gradient_path_is_bit_equal(cuda):
    def run(solve):
        ts = torch.tensor([0.0, 0.3, 0.3, 0.9, 1.7], device=cuda, requires_grad=True)
        ys, nfe, _ = solve(_tree_field, _leaves(LIKELIHOOD, cuda), ts, RTOL, ATOL,
                           ode.DISCRETE_STEPS)
        return ys, nfe

    (ys, nfe), (ys_p, nfe_p) = run(ode._solve), run(_plain_solve)
    assert nfe == nfe_p and _equal(ys, ys_p)


def test_card_steps_launch_multi_tensor_kernels(cuda):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ode.odeint(_tree_field, _leaves(AUGMENTED, cuda), np.array([0.0, 0.6], F32),
                   rtol=RTOL, atol=ATOL)
        torch.cuda.synchronize()

    def in_step(event):
        while event is not None:
            if event.name == "caspr::ode.step":
                return True
            event = event.cpu_parent
        return False

    kernels = [k.name for e in prof.events() if in_step(e) for k in e.kernels]
    assert any("multi_tensor_apply_kernel" in k for k in kernels), sorted(set(kernels))[:20]
