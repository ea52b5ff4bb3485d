"""Adaptive Dormand-Prince (dopri5) integration and its continuous adjoint.

``odeint`` is the counterpart of caspr_tpu/ops/odeint.py::odeint, step for
step, so the two take the same steps and report the same number of
function evaluations (NFE) on the same problem:

  - one step size for the whole state, which is a tensor or a tuple of
    tensors (leaves); the error ratio is the largest over the leaves of
    each leaf's RMS of err / (atol + rtol * max(|y0|, |y1|)), not one RMS
    over all elements, and Hairer's initial step uses the same norm;
  - Hairer's initial step (one extra evaluation); a controller clipped to
    [0.2, 10] x h that never shrinks an accepted step;
  - no step is clamped to land on the last request time: the solver steps
    past it and fills request times from the quartic dense output (with a
    slack of 1e-6 * max(1, |t1|));
  - NFE starts at 2 (f0 and the step-size probe) and adds 6 per attempted
    step.

Time, step size and the controller live on the host as float32 scalars
(np.float32), as they are float32 on the JAX side; the state stays on its
device.  Each step reads the error ratio back to the host once, whatever
the number of leaves.

``func(t, y)`` takes a float32 time and the state (a tensor, or a tuple of
tensors when y0 is one) and returns dy/dt in the same form.
Reverse-time flows are written as forward flows of the time-reflected
dynamics by the caller (models/cnf.py).

``odeint_adjoint`` is the counterpart of
caspr_tpu/ops/odeint.py::odeint_adjoint: the same forward solve, with
gradients for y0, the request times and the tensor leaves of ``args`` from
backward augmented solves, and its backward NFE reported through an
``NFESink``.  ``odeint_discrete`` is the counterpart of its namesake: the
same solve under autograd, bounded in steps, with the +0.5 exhaustion
marker on its NFE.  ``odeint_train`` is the training solve, one or the
other by its ``backward`` argument.  ``nfe_add`` and ``nfe_sum`` combine
NFE counts as the JAX package does (caspr_tpu/ops/odeint.py:440-456).
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = np.float32

_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float64).astype(F32)
_A = [
    np.array(row, np.float64).astype(F32)
    for row in (
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    )
]
_B64 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], np.float64)
_B = _B64.astype(F32)
_B_ERR = (_B64 - np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
    np.float64)).astype(F32)
# 5th-order midpoint weights for the quartic dense output
_C_MID = np.array([
    6025192743 / 30085553152 / 2,
    0.0,
    51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2,
    187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2,
    11237099 / 235043384 / 2,
], np.float64).astype(F32)

# the attempted-step bound of odeint_discrete: about 2x the trained flow's
# step count at the reference's tolerances
DISCRETE_STEPS = 128
ODE_BACKWARDS = ("adjoint", "discrete")

_SAFETY = F32(0.9)
_IFACTOR = F32(10.0)
_DFACTOR = F32(0.2)
_ORDER_EXP = F32(-1.0 / 5.0)


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i] per leaf, accumulated left to right."""
    out = [float(coeffs[0]) * k for k in ks[0]]
    for c, k in zip(coeffs[1:], ks[1:]):
        out = [o + float(c) * leaf for o, leaf in zip(out, k)]
    return out


def _axpy(y, h, d):
    """y + h * d per leaf."""
    return tuple(a + float(h) * b for a, b in zip(y, d))


def _norm(leaves) -> np.float32:
    """max over the leaves of sqrt(mean(leaf^2)), in one host read."""
    rms = [torch.sqrt(torch.mean(torch.square(leaf))) for leaf in leaves]
    return F32((rms[0] if len(rms) == 1 else torch.stack(rms).max()).item())


def _error_ratio(err, y0, y1, rtol, atol) -> np.float32:
    return _norm([e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
                  for e, a, b in zip(err, y0, y1)])


def _initial_step(func, t0, y0, f0, rtol, atol) -> np.float32:
    """Hairer's starting-step heuristic (one extra function evaluation)."""
    scale = [atol + rtol * y.abs() for y in y0]
    d0 = _norm([y / s for y, s in zip(y0, scale)])
    d1 = _norm([f / s for f, s in zip(f0, scale)])
    if d0 < F32(1e-5) or d1 < F32(1e-5):
        h0 = F32(1e-6)
    else:
        h0 = F32(0.01) * d0 / d1
    f1 = func(t0 + h0, _axpy(y0, h0, f0))
    d2 = _norm([(a - b) / s for a, b, s in zip(f1, f0, scale)]) / h0
    dmax = max(d1, d2)
    if dmax <= F32(1e-15):
        h1 = max(F32(1e-6), h0 * F32(1e-3))
    else:
        h1 = (F32(0.01) / dmax) ** F32(0.2)
    return min(F32(100.0) * h0, h1)


def _optimal_step(h, ratio, accepted) -> np.float32:
    """Grow up to x10, shrink to x0.2, never shrink an accepted step; a NaN
    error ratio (diverged state) is a hard reject."""
    if np.isnan(ratio):
        return h * _DFACTOR
    ratio = max(ratio, F32(1e-10))
    factor = _SAFETY * ratio ** _ORDER_EXP
    lo = F32(1.0) if accepted else _DFACTOR
    return h * min(max(factor, lo), _IFACTOR)


def _dense_output(y0, y1, y_mid, f0, f1, h, theta):
    """The quartic through (y0, y_mid, y1) with slopes (f0, f1), at theta."""
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


def _solve(func, y0, ts, rtol, atol, max_steps: int):
    """The dopri5 loop of ``odeint`` and ``odeint_discrete``: (ys, nfe,
    whether every request time was reached).  The step controller (the
    initial step, the error ratio) runs without autograd; the stages and
    the dense output run under whatever grad mode the caller set.  Where
    grad is on and ts requires it, the dense output's theta = (ts_i - t) /
    h is a tensor, so the request times get their gradient through it."""
    single = isinstance(y0, torch.Tensor)
    if single:
        y0, leaf_func = (y0,), func
        func = lambda t, y: (leaf_func(t, y[0]),)
    else:
        y0 = tuple(y0)
    ts_grad = None
    if isinstance(ts, torch.Tensor):
        if ts.requires_grad and torch.is_grad_enabled():
            ts_grad = ts
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=F32)
    t, t_final = ts[0], ts[-1]
    f = func(t, y0)
    with torch.no_grad():
        h = _initial_step(func, t, y0, f, rtol, atol)
    y = y0
    filled = ts <= t
    outs = [y0 if done else None for done in filled]
    nfe, steps = 2.0, 0
    while not filled.all() and steps < max_steps and t < t_final:
        ks = [f]
        for i in range(6):
            ks.append(func(t + _C[i + 1] * h, _axpy(y, h, _weighted_sum(_A[i], ks))))
        y1 = _axpy(y, h, _weighted_sum(_B, ks))
        with torch.no_grad():
            err = [float(h) * d for d in _weighted_sum(_B_ERR, ks)]
            ratio = _error_ratio(err, y, y1, rtol, atol)
        accept = bool(ratio <= F32(1.0))
        t1 = t + h
        if accept:
            slack = F32(1e-6) * max(F32(1.0), abs(t1))
            newly = ~filled & (ts <= t1 + slack)
            if newly.any():
                y_mid = _axpy(y, h, _weighted_sum(_C_MID, ks))
                h_div = max(h, F32(1e-30))
                thetas = np.clip((ts - t) / h_div, F32(0.0), F32(1.0))
                for i in np.flatnonzero(newly):
                    theta = (thetas[i] if ts_grad is None else
                             torch.clamp((ts_grad[i] - float(t)) / float(h_div), 0.0, 1.0))
                    outs[i] = tuple(
                        _dense_output(*leaves, h, theta)
                        for leaves in zip(y, y1, y_mid, f, ks[6]))
                filled = filled | newly
            t, y, f = t1, y1, ks[6]
        h = _optimal_step(h, ratio, accept)
        nfe += 6.0
        steps += 1
    # request times never reached (the step bound, endpoint rounding) take
    # the final state
    outs = [y if o is None else o for o in outs]
    stacked = tuple(torch.stack([o[leaf] for o in outs]) for leaf in range(len(y0)))
    return (stacked[0] if single else stacked), nfe, bool(filled.all())


def odeint(func, y0, ts, *, rtol: float, atol: float, max_steps: int = 50_000):
    """Integrate dy/dt = func(t, y) from ts[0] and report y at every ts.

    y0: a tensor, or a tuple of tensors integrated together.  ts:
    non-decreasing float32 request times (1-D, any array type), ts[0] the
    initial time.  Returns (ys, nfe): ys (len(ts), *y0.shape), or a tuple
    of such tensors, one per leaf."""
    ys, nfe, _ = _solve(func, y0, ts, rtol, atol, max_steps)
    return ys, nfe


def odeint_discrete(func, y0, ts, *, rtol: float, atol: float, num_steps: int = DISCRETE_STEPS):
    """``odeint`` differentiable by autograd through the solver
    (discretise-then-optimise), the counterpart of caspr_tpu/ops/odeint.py::
    odeint_discrete: gradients exact for the discrete solution reach y0,
    whatever ``func`` closes over, and ts through the dense output.  The
    step controller is a constant of the gradient, as the JAX package's
    stop_gradient makes it, and func's time argument is a host float.

    At most ``num_steps`` steps are attempted.  If the bound is hit before
    every request time is reached, those outputs take the final state and
    the returned NFE carries a +0.5 marker (``nfe_exhausted``).  The graph
    holds what each evaluation saves for its backward; the controller's
    evaluations (the step-size probe, the error norms) are not in it."""
    ys, nfe, reached = _solve(func, y0, ts, rtol, atol, max(int(num_steps), 1))
    return ys, nfe + (0.0 if reached else 0.5)


def nfe_exhausted(nfe) -> bool:
    """Whether an ``odeint_discrete`` NFE count carries the step-bound
    exhaustion marker."""
    return bool(np.asarray(nfe) % 1.0 != 0.0)


def nfe_add(a, b) -> float:
    """Sum of two NFE counts whose +0.5 step-bound exhaustion markers are
    OR-ed, not added, so that two marked counts cannot sum to an unmarked
    one; the identity on whole counts."""
    fa, fb = math.floor(a), math.floor(b)
    return float(fa + fb + (0.5 if max(a - fa, b - fb) > 0 else 0.0))


def nfe_sum(counts) -> float:
    """``nfe_add`` over a sequence of NFE counts."""
    floors = [math.floor(c) for c in counts]
    marked = any(c - f > 0 for c, f in zip(counts, floors))
    return float(sum(floors) + (0.5 if marked else 0.0))


class NFESink:
    """The backward NFE of every adjoint solve given this sink is added to
    ``value`` when its backward runs: the port's stand-in for the JAX
    package's sink scalar, whose gradient carries the count."""

    def __init__(self):
        self.value = 0.0


def flatten_tree(tree):
    """(the tensor leaves of a dict / list / tuple tree in order,
    rebuild(leaves) -> a tree of the same structure; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys, items = list(tree), list(tree.values())
    elif isinstance(tree, (list, tuple)):
        keys, items = None, list(tree)
    else:
        return [], lambda leaves: tree
    parts = [flatten_tree(v) for v in items]
    leaves = [leaf for part, _ in parts for leaf in part]

    def rebuild(flat):
        out, at = [], 0
        for part, rebuild_part in parts:
            out.append(rebuild_part(flat[at:at + len(part)]))
            at += len(part)
        return dict(zip(keys, out)) if keys is not None else type(tree)(out)

    return leaves, rebuild


def _dot(a, b):
    """sum over the leaves of sum(a * b), float32."""
    return sum((x.float() * y.float()).sum() for x, y in zip(a, b))


class _Adjoint(torch.autograd.Function):
    """inputs: (spec, ts, *y0 leaves, *args leaves); outputs: the (T, ...)
    trajectory of each y leaf."""

    @staticmethod
    def forward(ctx, spec, ts, *leaves):
        y0, arg_leaves = leaves[:spec["num_y"]], leaves[spec["num_y"]:]
        args = spec["rebuild"](list(arg_leaves))
        ys, spec["nfe"] = odeint(lambda t, y: spec["func"](t, y, args), y0, ts,
                                 rtol=spec["rtol"], atol=spec["atol"],
                                 max_steps=spec["max_steps"])
        ctx.spec = spec
        ctx.save_for_backward(ts, *ys, *arg_leaves)
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        spec = ctx.spec
        num_y = spec["num_y"]
        saved = ctx.saved_tensors
        ts, ys, arg_leaves = saved[0], saved[1:1 + num_y], [a.detach() for a in saved[1 + num_y:]]
        func, rebuild = spec["func"], spec["rebuild"]
        g_ys = [torch.zeros_like(y) if g is None else g for g, y in zip(g_ys, ys)]
        times = ts.detach().cpu().numpy().astype(F32)
        num_t = len(times)
        grad_ts = torch.zeros_like(ts)
        if num_t == 1:  # the only request time is the initial one: identity
            return (None, grad_ts, *(g[0] for g in g_ys),
                    *(torch.zeros_like(a) for a in arg_leaves))

        def plain(t, y):
            with torch.no_grad():
                return func(t, y, rebuild(arg_leaves))

        a_y = tuple(g[num_t - 1] for g in g_ys)
        a_args = tuple(torch.zeros_like(a) for a in arg_leaves)
        nfe_bwd = 0.0
        dldts = []
        for i in range(num_t - 1, 0, -1):
            y_i = tuple(y[i] for y in ys)
            dldts.append(_dot((g[i] for g in g_ys), plain(times[i], y_i)))
            t_hi = times[i]

            def augmented(s, state, t_hi=t_hi):
                # solver time s runs 0 -> span; the flow's time is t_hi - s:
                # d/ds (y, a_y, a_args) = (-f, a_y^T df/dy, a_y^T df/dargs)
                with torch.enable_grad():
                    y = tuple(v.detach().requires_grad_() for v in state[:num_y])
                    args = [v.detach().requires_grad_() for v in arg_leaves]
                    f = func(t_hi - s, y, rebuild(args))
                    pairs = [(fo, ao) for fo, ao in zip(f, state[num_y:2 * num_y])
                             if fo.requires_grad]
                    grads = torch.autograd.grad(
                        [fo for fo, _ in pairs], (*y, *args),
                        grad_outputs=[ao for _, ao in pairs], allow_unused=True,
                    ) if pairs else (None,) * (num_y + len(args))
                vjp = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, (*y, *args))]
                return (*(-fo.detach() for fo in f), *vjp)

            span = times[i] - times[i - 1]
            aug, aug_nfe = odeint(augmented, (*y_i, *a_y, *a_args), np.array([0.0, span], F32),
                                  rtol=spec["rtol"], atol=spec["atol"], max_steps=spec["max_steps"])
            a_at_lo = tuple(leaf[1] for leaf in aug[num_y:2 * num_y])
            a_args = tuple(leaf[1] for leaf in aug[2 * num_y:])
            nfe_bwd += aug_nfe + 1.0  # every augmented evaluation calls func once; +1 for f_i
            a_y = tuple(a + g[i - 1] for a, g in zip(a_at_lo, g_ys))
        # dL/dts[0] = -a(t0) . f(t0, y0), with a(t0) before g[0] is added
        dldt0 = -_dot(a_at_lo, plain(times[0], tuple(y[0] for y in ys)))
        grad_ts = torch.stack([dldt0, *reversed(dldts)]).to(ts)
        if spec["sink"] is not None:
            spec["sink"].value += nfe_bwd + 1.0  # +1: f(t0, y0)
        return (None, grad_ts, *a_y, *a_args)


def odeint_adjoint(func, y0, ts, args=(), *, rtol: float, atol: float, max_steps: int = 50_000,
                   nfe_sink: NFESink | None = None):
    """``odeint`` with gradients by the continuous adjoint.

    func(t, y, args) -> dy/dt, with y a tensor or a tuple of tensors (as
    y0) and args a dict / list / tuple tree whose tensor leaves are the
    things to differentiate: whatever func closes over instead is a
    constant.  ts: a 1-D float32 tensor of non-decreasing request times,
    ts[0] the initial time (it may require grad).  Returns (ys, nfe) as
    ``odeint``.

    The backward re-integrates the augmented system (y, a_y, a_args)
    interval by interval from ts[-1] down to ts[0] at the same tolerances,
    with the same dopri5; its error norm runs over every leaf, so a_args
    has one leaf per tensor leaf of args, as in the JAX package.  It adds
    the output cotangent at each request time, gives dL/dts[i] = g_i .
    f(ts[i]) and dL/dts[0] = -a(ts[0]) . f(ts[0]), and adds its NFE
    (sum over the intervals of the augmented solve's NFE + 1, + 1) to
    ``nfe_sink.value``."""
    single = isinstance(y0, torch.Tensor)
    y_leaves = (y0,) if single else tuple(y0)
    arg_leaves, rebuild = flatten_tree(args)
    if single:
        leaf_func = func
        func = lambda t, y, a: (leaf_func(t, y[0], a),)
    if not isinstance(ts, torch.Tensor):
        ts = torch.as_tensor(np.asarray(ts, dtype=F32))
    spec = {"func": func, "rebuild": rebuild, "num_y": len(y_leaves), "rtol": rtol,
            "atol": atol, "max_steps": max_steps, "sink": nfe_sink}
    ys = _Adjoint.apply(spec, ts, *y_leaves, *arg_leaves)
    return (ys[0] if single else tuple(ys)), spec["nfe"]


def odeint_train(func, y0, ts, args=(), *, rtol: float, atol: float, backward: str = "adjoint",
                 num_steps: int = DISCRETE_STEPS, nfe_sink: NFESink | None = None):
    """The training solve of func(t, y, args): ``odeint_adjoint`` with
    ``backward="adjoint"`` (backward NFE to ``nfe_sink``), or
    ``odeint_discrete`` (at most ``num_steps`` steps; ``nfe_sink`` gets
    nothing: its gradient is autograd's, and the NFE is forward-only)."""
    if backward == "adjoint":
        return odeint_adjoint(func, y0, ts, args, rtol=rtol, atol=atol, nfe_sink=nfe_sink)
    if backward == "discrete":
        return odeint_discrete(lambda t, y: func(t, y, args), y0, ts, rtol=rtol, atol=atol,
                               num_steps=num_steps)
    raise ValueError(f"ODE backward {backward!r}, expected one of {ODE_BACKWARDS}")
