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
the number of leaves, and issues its arithmetic once over every leaf
(multi-tensor ``torch._foreach_*`` operations, the plain ones for a lone
leaf; one dense output for all the request times it reaches), so that its
launches depend on neither the number of leaves nor that of request times;
each element sees the operations of a leaf-by-leaf solve, in the same
order.

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

Data and point parallelism: each solver takes ``group=``, a process group
over which the state's rows (and, with sp, its points) are sharded
(``parallel.mesh``).  ``None`` is the one-process solver, op for op.  With
a group the error norms are global (``_norm``: one all-reduce per norm of
the sharded leaves' sums of squares and counts, still one host read), so
every accept, NaN reject and initial-step decision, and the end of the
loop, is the same on every rank and the one-process run's; the ranks stay
in lockstep through the collectives inside the loop.  The adjoint also
sums the VJP of its replicated args over the ranks at each augmented
evaluation, and that of its args sharded over the rows alone over the
point group (``odeint_adjoint``).

Spans (``utils.profiling.annotate``, recorded while a profiler is on): a
solve is ``caspr::ode.solve``, each attempted step ``caspr::ode.step``,
each evaluation of the dynamics ``caspr::ode.func`` (f0, the step-size
probe, the six stages; the adjoint's plain evaluations), each step's dense
output ``caspr::ode.dense`` (inside its step), each read of a
value to the host ``caspr::host_read`` (one a norm; ts when it is a
tensor); an adjoint's backward is ``caspr::adjoint`` and its augmented
solve between two request times ``caspr::adjoint.interval``.  A solve of
NFE 2 + 6 s thus records s step spans and s + 3 host reads (+ 1 for a
tensor ts).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce_sum, all_reduce_sum_leaves, is_lead
from ..utils.profiling import annotate

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

# the kinds of an adjoint's arg leaves (odeint_adjoint)
REPLICATED, ROWS = "replicated", "rows"
ARG_KINDS = (REPLICATED, ROWS)

# the attempted-step bound of odeint_discrete: about 2x the trained flow's
# step count at the reference's tolerances
DISCRETE_STEPS = 128
ODE_BACKWARDS = ("adjoint", "discrete")

_SAFETY = F32(0.9)
_IFACTOR = F32(10.0)
_DFACTOR = F32(0.2)
_ORDER_EXP = F32(-1.0 / 5.0)


def _each(op, leaves, *args):
    """``torch._foreach_<op>(leaves, *args)``: one multi-tensor launch over
    every leaf, a list in ``args`` pairing with them.  A lone leaf takes the
    tensor's own op, the same arithmetic: on CUDA it mostly costs the host
    less than a one-tensor foreach call, and it runs a large leaf over more
    blocks than the multi-tensor kernel's one per 64k elements."""
    if len(leaves) > 1:
        return getattr(torch, "_foreach_" + op)(leaves, *args)
    return [getattr(leaves[0], op)(*(a[0] if isinstance(a, (list, tuple)) else a for a in args))]


def _weighted_sum(coeffs, ks):
    """sum_i coeffs[i] * ks[i] per leaf, accumulated left to right: each
    term one product and one sum over every leaf at once."""
    out = _each("mul", ks[0], float(coeffs[0]))
    for c, k in zip(coeffs[1:], ks[1:]):
        _each("add_", out, _each("mul", k, float(c)))
    return out


def _axpy(y, h, d):
    """y + h * d per leaf, laid out as d: a state whose leaves the dynamics
    return in another layout (an adjoint's weight leaves, from autograd)
    takes the dynamics' layout after a step, so that the lists of each
    later step's multi-tensor launches agree."""
    out = _each("mul", d, float(h))
    _each("add_", out, y)
    return tuple(out)


def _gapless(leaves):
    """The leaves, each whose elements do not fill one block of memory (a
    slice of a wider buffer, such as a field's columns) as ``leaf * 1.0``:
    the same values, laid out as any elementwise result of the leaf is.  A
    multi-tensor launch takes only such blocks: on CUDA, a foreach op over a
    list that holds another runs tensor by tensor."""
    return tuple(leaf if _fills_block(leaf) else leaf * 1.0 for leaf in leaves)


def _fills_block(t) -> bool:
    if t.is_contiguous():
        return True
    size = 1
    for stride, extent in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != size:
            return False
        size *= extent
    return True


def _tolerance(magnitude, rtol, atol):
    """atol + rtol * magnitude per leaf."""
    out = _each("mul", magnitude, float(rtol))
    _each("add_", out, float(atol))
    return out


def _norm(leaves, group=None, weights=None) -> np.float32:
    """max over the leaves of sqrt(mean(leaf^2)), in one host read.

    With a process group, a leaf whose entry in ``weights`` (default: 1
    for every leaf) is a number holds this rank's part of a sharded leaf:
    its mean is over every rank's part, from one all-reduce of each such
    leaf's (sum of squares, element count) in float64, times the weight,
    1, or 0 where another rank holds the same part and adds it.  A leaf
    whose entry is None is equal on every rank and enters as it is.  Every
    rank gets the same value, so every host decision taken on it is the
    same on every rank."""
    if group is None:
        # x * x is torch.square's arithmetic; the means stay leaf by leaf
        means = [torch.mean(sq) for sq in _each("mul", leaves, leaves)]
        value = torch.sqrt(means[0]) if len(means) == 1 else torch.sqrt(torch.stack(means)).max()
        with annotate("caspr::host_read"):
            return F32(value.item())
    weights = (1.0,) * len(leaves) if weights is None else tuple(weights)
    split = [(leaf, w) for leaf, w in zip(leaves, weights) if w is not None]
    rms = [torch.sqrt(torch.mean(torch.square(leaf)))
           for leaf, w in zip(leaves, weights) if w is None]
    if split:
        sums = torch.stack([torch.stack([leaf.double().square().sum(),
                                         leaf.new_tensor(leaf.numel(), dtype=torch.float64)]) * w
                            for leaf, w in split])
        sums = all_reduce_sum(sums, group, "norm")
        rms.extend(torch.sqrt(sums[:, 0] / sums[:, 1]).float())
    value = torch.stack(rms).max()
    with annotate("caspr::host_read"):
        return F32(value.item())


def _error_ratio(err, y0, y1, rtol, atol, group=None, weights=None) -> np.float32:
    magnitude = _each("maximum", _each("abs", y0), _each("abs", y1))
    return _norm(_each("div", err, _tolerance(magnitude, rtol, atol)), group, weights)


def _initial_step(func, t0, y0, f0, rtol, atol, group=None, weights=None) -> np.float32:
    """Hairer's starting-step heuristic (one extra function evaluation)."""
    scale = _tolerance(_each("abs", y0), rtol, atol)
    d0 = _norm(_each("div", y0, scale), group, weights)
    d1 = _norm(_each("div", f0, scale), group, weights)
    if d0 < F32(1e-5) or d1 < F32(1e-5):
        h0 = F32(1e-6)
    else:
        h0 = F32(0.01) * d0 / d1
    f1 = func(t0 + h0, _axpy(y0, h0, f0))
    d2 = _norm(_each("div", _each("sub", f1, f0), scale), group, weights) / h0
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


def _dense_output(y0, y1, y_mid, f0, f1, h, thetas):
    """The quartic through (y0, y_mid, y1) with slopes (f0, f1) at each of
    ``thetas``, a (n,) tensor or n host floats: a (n, *leaf.shape) block per
    leaf.  The leaves ride as one tensor of all their elements (a view of a
    lone contiguous leaf), so that each operation is one launch whatever
    their number; leaves of mixed dtypes are taken one by one."""
    parts = (y0, y1, y_mid, f0, f1)
    if len({leaf.dtype for leaf in y0}) > 1:
        return [_dense_output(*(part[i:i + 1] for part in parts), h, thetas)[0]
                for i in range(len(y0))]
    y0f, y1f, y_midf, f0f, f1f = (torch.cat([leaf.reshape(-1) for leaf in part]) if len(part) > 1
                                  else part[0].reshape(-1) for part in parts)
    hf0 = float(h) * f0f
    hf1 = float(h) * f1f
    a = y1f - y0f - hf0
    b = y_midf - y0f - 0.5 * hf0
    c = hf1 - hf0
    c4 = -8.0 * a + 16.0 * b + 2.0 * c
    c3 = 14.0 * a - 32.0 * b - 3.0 * c
    c2 = -5.0 * a + 16.0 * b + c

    def at(th):
        return y0f + th * (hf0 + th * (c2 + th * (c3 + th * c4)))

    if isinstance(thetas, torch.Tensor):
        out = at(thetas.to(y0f.dtype)[:, None])
    else:
        rows = [at(float(th)) for th in thetas]
        out = torch.stack(rows) if len(rows) > 1 else rows[0][None]
    blocks, start = [], 0
    for leaf in y0:
        blocks.append(out[:, start:start + leaf.numel()].view(-1, *leaf.shape))
        start += leaf.numel()
    return blocks


def _solve(func, y0, ts, rtol, atol, max_steps: int, group=None, weights=None):
    """The dopri5 loop of ``odeint`` and ``odeint_discrete``: (ys, nfe,
    whether every request time was reached).  The step controller (the
    initial step, the error ratio) runs without autograd; the stages and
    the dense output run under whatever grad mode the caller set.

    Each step's arithmetic is issued once over every leaf (``torch.
    _foreach_*``, ``_dense_output``), and, ts being non-decreasing, the
    request times an accepted step reaches are one range, filled by one
    dense output: where ts is a tensor on the state's device, theta = (ts_i
    - t) / h is computed there for the whole range (where grad is on and ts
    requires it, so the request times get their gradient through it),
    otherwise on the host.  ``group`` and ``weights`` go to the error norms
    (``_norm``)."""
    with annotate("caspr::ode.solve"):
        single = isinstance(y0, torch.Tensor)
        y0 = _gapless((y0,) if single else y0)

        def func(t, y, state_func=func):
            with annotate("caspr::ode.func"):
                return _gapless((state_func(t, y[0]),) if single else state_func(t, y))

        ts_dev, ts_grad = None, False
        if isinstance(ts, torch.Tensor):
            if ts.requires_grad and torch.is_grad_enabled():
                ts_dev, ts_grad = ts.to(y0[0].device), True
            elif ts.device == y0[0].device:
                ts_dev = ts.detach().to(torch.float32)
            with annotate("caspr::host_read"):
                ts = ts.detach().cpu().numpy()
        ts = np.asarray(ts, dtype=F32)
        if np.any(ts[1:] < ts[:-1]):
            raise ValueError("the request times must be non-decreasing")

        def thetas(lo, hi, t, h_div):
            if ts_dev is None:
                return np.clip((ts[lo:hi] - t) / h_div, F32(0.0), F32(1.0))
            # CUDA takes a host float divisor as a product with its
            # reciprocal: the gradient path's theta does so (a division would
            # move its results on the card in the last place); the others
            # divide by h on the device, rounding as the host's float32
            # division of host request times does
            den = float(h_div) if ts_grad else ts_dev.new_full((), float(h_div))
            return torch.clamp((ts_dev[lo:hi] - float(t)) / den, 0.0, 1.0)

        t, t_final = ts[0], ts[-1]
        f = func(t, y0)
        with torch.no_grad():
            h = _initial_step(func, t, y0, f, rtol, atol, group, weights)
        y = y0
        done = int(np.count_nonzero(ts <= t))  # request times filled so far, a prefix
        blocks = [[leaf[None].expand(done, *leaf.shape)] for leaf in y0]
        nfe, steps = 2.0, 0
        while done < len(ts) and steps < max_steps and t < t_final:
            with annotate("caspr::ode.step"):
                ks = [f]
                for i in range(6):
                    ks.append(func(t + _C[i + 1] * h, _axpy(y, h, _weighted_sum(_A[i], ks))))
                y1 = _axpy(y, h, _weighted_sum(_B, ks))
                with torch.no_grad():
                    err = _each("mul", _weighted_sum(_B_ERR, ks), float(h))
                    ratio = _error_ratio(err, y, y1, rtol, atol, group, weights)
                accept = bool(ratio <= F32(1.0))
                t1 = t + h
                if accept:
                    slack = F32(1e-6) * max(F32(1.0), abs(t1))
                    hi = int(np.searchsorted(ts, t1 + slack, side="right"))
                    if hi > done:
                        with annotate("caspr::ode.dense"):
                            y_mid = _axpy(y, h, _weighted_sum(_C_MID, ks))
                            theta = thetas(done, hi, t, max(h, F32(1e-30)))
                            for leaf, block in zip(blocks, _dense_output(y, y1, y_mid, f, ks[6],
                                                                         h, theta)):
                                leaf.append(block)
                        done = hi
                    t, y, f = t1, y1, ks[6]
                h = _optimal_step(h, ratio, accept)
            nfe += 6.0
            steps += 1
        # request times never reached (the step bound, endpoint rounding) take
        # the final state
        if done < len(ts):
            for leaf, state in zip(blocks, y):
                leaf.append(state[None].expand(len(ts) - done, *state.shape))
        stacked = tuple(torch.cat(leaf) for leaf in blocks)
        return (stacked[0] if single else stacked), nfe, done == len(ts)


def odeint(func, y0, ts, *, rtol: float, atol: float, max_steps: int = 50_000, group=None):
    """Integrate dy/dt = func(t, y) from ts[0] and report y at every ts.

    y0: a tensor, or a tuple of tensors integrated together.  ts:
    non-decreasing float32 request times (1-D, any array type), ts[0] the
    initial time.  Returns (ys, nfe): ys (len(ts), *y0.shape), or a tuple
    of such tensors, one per leaf.

    ``group``, a process group over which the state's batch is sharded,
    makes every error norm global (``_norm``): each rank then takes the
    steps of the one-process solve of the whole batch.  Every leaf of y0
    is this rank's part (its rows, or its rows' points), which no other
    rank of the group holds.  The ranks must call with equal ts."""
    ys, nfe, _ = _solve(func, y0, ts, rtol, atol, max_steps, group)
    return ys, nfe


def odeint_discrete(func, y0, ts, *, rtol: float, atol: float, num_steps: int = DISCRETE_STEPS,
                    group=None):
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
    evaluations (the step-size probe, the error norms) are not in it.
    ``group`` is ``odeint``'s."""
    ys, nfe, reached = _solve(func, y0, ts, rtol, atol, max(int(num_steps), 1), group)
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
                                 max_steps=spec["max_steps"], group=spec["group"])
        ctx.spec = spec
        ctx.save_for_backward(ts, *ys, *arg_leaves)
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        with annotate("caspr::adjoint"):
            return _adjoint_backward(ctx.spec, ctx.saved_tensors, g_ys)


def _adjoint_backward(spec, saved, g_ys):
    """``_Adjoint.backward``: the augmented solves, interval by interval."""
    num_y = spec["num_y"]
    ts, ys, arg_leaves = saved[0], saved[1:1 + num_y], [a.detach() for a in saved[1 + num_y:]]
    func, rebuild, group, kinds = spec["func"], spec["rebuild"], spec["group"], spec["kinds"]
    g_ys = [torch.zeros_like(y) if g is None else g for g, y in zip(g_ys, ys)]
    with annotate("caspr::host_read"):
        times = ts.detach().cpu().numpy().astype(F32)
    num_t = len(times)
    grad_ts = torch.zeros_like(ts)
    if num_t == 1:  # the only request time is the initial one: identity
        return (None, grad_ts, *(g[0] for g in g_ys),
                *(torch.zeros_like(a) for a in arg_leaves))

    def plain(t, y):
        with annotate("caspr::ode.func"), torch.no_grad():
            return func(t, y, rebuild(arg_leaves))

    a_y = tuple(g[num_t - 1] for g in g_ys)
    a_args = tuple(torch.zeros_like(a) for a in arg_leaves)
    nfe_bwd = 0.0
    dldts = []
    for i in range(num_t - 1, 0, -1):
        with annotate("caspr::adjoint.interval"):
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
                vjp = [torch.zeros_like(x) if g is None else g
                       for g, x in zip(grads, (*y, *args))]
                if group is not None:
                    vjp[num_y:] = _sum_args(vjp[num_y:], kinds, group, spec["point_group"])
                return (*(-fo.detach() for fo in f), *vjp)

            span = times[i] - times[i - 1]
            aug, aug_nfe, _ = _solve(augmented, (*y_i, *a_y, *a_args),
                                     np.array([0.0, span], F32), spec["rtol"], spec["atol"],
                                     spec["max_steps"], group,
                                     (1.0,) * (2 * num_y) + spec["arg_weights"])
            a_at_lo = tuple(leaf[1] for leaf in aug[num_y:2 * num_y])
            a_args = tuple(leaf[1] for leaf in aug[2 * num_y:])
            nfe_bwd += aug_nfe + 1.0  # every augmented evaluation calls func once; +1 for f_i
            a_y = tuple(a + g[i - 1] for a, g in zip(a_at_lo, g_ys))
    # dL/dts[0] = -a(t0) . f(t0, y0), with a(t0) before g[0] is added
    dldt0 = -_dot(a_at_lo, plain(times[0], tuple(y[0] for y in ys)))
    grad_ts = torch.stack([dldt0, *reversed(dldts)]).to(ts)
    if spec["sink"] is not None:
        spec["sink"].value += nfe_bwd + 1.0  # +1: f(t0, y0)
    if group is not None and dist.get_rank(group) != 0:
        # a replicated leaf's a_args is its gradient summed over ranks
        # already: it leaves from rank 0 alone, so that the caller's sum
        # of every gradient over the ranks adds it once, and exactly
        a_args = tuple(torch.zeros_like(a) if k == REPLICATED else a
                       for a, k in zip(a_args, kinds))
    return (None, grad_ts, *a_y, *a_args)


def _sum_args(vjp, kinds, group, point_group):
    """The VJP leaves of the replicated args summed over the ranks of
    ``group``, and with a ``point_group`` those of the ROWS args over its
    ranks (one all-reduce of one flat buffer each); the others as they
    are."""
    out = list(vjp)
    for kind, over, name in ((REPLICATED, group, "adjoint_vjp"),
                             (ROWS, point_group, "adjoint_ctx")):
        at = [i for i, k in enumerate(kinds) if k == kind]
        if at and over is not None:
            for i, v in zip(at, all_reduce_sum_leaves([vjp[i] for i in at], over, name)):
                out[i] = v
    return out


def odeint_adjoint(func, y0, ts, args=(), *, rtol: float, atol: float, max_steps: int = 50_000,
                   nfe_sink: NFESink | None = None, group=None, kinds=None, point_group=None):
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
    ``nfe_sink.value``.

    ``group``: a process group over which y0 is sharded (``odeint``).  Both
    solves then take the one-process steps, and the caller says of each
    tensor leaf of args, in ``flatten_tree`` order (a sequence, or one kind
    for all), which of ``ARG_KINDS`` it is:
      - REPLICATED: equal on every rank, such as parameters.  At each
        augmented evaluation its VJP is summed over ``group`` ("adjoint_vjp"),
        so that its a_args is the global value on every rank, as in the
        JAX package, and enters the error norm so.  Its gradient is returned
        on the group's rank 0 and zero on the others: a sum over the ranks
        of every gradient then counts it once.
      - ROWS: this rank's rows, such as the CNF's context.  Without a
        ``point_group`` its a_args stays local and enters the norm reduced.
        With one, over which y0's points are sharded and whose ranks hold
        the same rows, its VJP, a sum over points, is summed over
        ``point_group`` at each evaluation ("adjoint_ctx"), so that every
        rank of it holds the one-process cotangent of its rows; it then
        enters the norm from the point group's rank 0.  Its gradient is
        returned on every rank.
    dL/dts is this rank's part of the sum over rows (and points)."""
    single = isinstance(y0, torch.Tensor)
    y_leaves = (y0,) if single else tuple(y0)
    arg_leaves, rebuild = flatten_tree(args)
    if single:
        leaf_func = func
        func = lambda t, y, a: (leaf_func(t, y[0], a),)
    if not isinstance(ts, torch.Tensor):
        ts = torch.as_tensor(np.asarray(ts, dtype=F32))
    if group is None:
        kinds = (ROWS,) * len(arg_leaves)
    elif kinds is None:
        raise ValueError(f"a sharded adjoint needs `kinds`: one of {ARG_KINDS} per arg leaf")
    elif isinstance(kinds, str):
        kinds = (kinds,) * len(arg_leaves)
    kinds = tuple(kinds)
    if len(kinds) != len(arg_leaves) or not set(kinds) <= set(ARG_KINDS):
        raise ValueError(f"`kinds` {kinds} for {len(arg_leaves)} leaves, each one of {ARG_KINDS}")
    lead = 1.0 if is_lead(point_group) else 0.0
    spec = {"func": func, "rebuild": rebuild, "num_y": len(y_leaves), "rtol": rtol,
            "atol": atol, "max_steps": max_steps, "sink": nfe_sink, "group": group,
            "kinds": kinds, "point_group": point_group,
            # the arg leaves' weights in the augmented solve's error norm
            "arg_weights": tuple(None if k == REPLICATED else lead for k in kinds)}
    ys = _Adjoint.apply(spec, ts, *y_leaves, *arg_leaves)
    return (ys[0] if single else tuple(ys)), spec["nfe"]


def odeint_train(func, y0, ts, args=(), *, rtol: float, atol: float, backward: str = "adjoint",
                 num_steps: int = DISCRETE_STEPS, nfe_sink: NFESink | None = None, group=None,
                 kinds=None, point_group=None):
    """The training solve of func(t, y, args): ``odeint_adjoint`` with
    ``backward="adjoint"`` (backward NFE to ``nfe_sink``), or
    ``odeint_discrete`` (at most ``num_steps`` steps; ``nfe_sink`` gets
    nothing: its gradient is autograd's, and the NFE is forward-only).
    ``group``, ``kinds`` and ``point_group`` are ``odeint_adjoint``'s; with
    "discrete" every gradient is this rank's part of the sum over rows and
    points (autograd's, which reads no kind: the caller sums what it must)."""
    if backward == "adjoint":
        return odeint_adjoint(func, y0, ts, args, rtol=rtol, atol=atol, nfe_sink=nfe_sink,
                              group=group, kinds=kinds, point_group=point_group)
    if backward == "discrete":
        return odeint_discrete(lambda t, y: func(t, y, args), y0, ts, rtol=rtol, atol=atol,
                               num_steps=num_steps, group=group)
    raise ValueError(f"ODE backward {backward!r}, expected one of {ODE_BACKWARDS}")
