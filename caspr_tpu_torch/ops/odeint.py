"""Adaptive Dormand-Prince (dopri5) integration, forward only.

The counterpart of caspr_tpu/ops/odeint.py::odeint, step for step, so the
two take the same steps and report the same number of function
evaluations (NFE) on the same problem:

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
"""

from __future__ import annotations

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
    th = float(theta)
    return y0 + th * (hf0 + th * (c2 + th * (c3 + th * c4)))


def odeint(func, y0, ts, *, rtol: float, atol: float, max_steps: int = 50_000):
    """Integrate dy/dt = func(t, y) from ts[0] and report y at every ts.

    y0: a tensor, or a tuple of tensors integrated together.  ts:
    non-decreasing float32 request times (1-D, any array type), ts[0] the
    initial time.  Returns (ys, nfe): ys (len(ts), *y0.shape), or a tuple
    of such tensors, one per leaf."""
    single = isinstance(y0, torch.Tensor)
    if single:
        y0, leaf_func = (y0,), func
        func = lambda t, y: (leaf_func(t, y[0]),)
    else:
        y0 = tuple(y0)
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=F32)
    t, t_final = ts[0], ts[-1]
    f = func(t, y0)
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
        err = [float(h) * d for d in _weighted_sum(_B_ERR, ks)]
        ratio = _error_ratio(err, y, y1, rtol, atol)
        accept = bool(ratio <= F32(1.0))
        t1 = t + h
        if accept:
            slack = F32(1e-6) * max(F32(1.0), abs(t1))
            newly = ~filled & (ts <= t1 + slack)
            if newly.any():
                y_mid = _axpy(y, h, _weighted_sum(_C_MID, ks))
                thetas = np.clip((ts - t) / max(h, F32(1e-30)), F32(0.0), F32(1.0))
                for i in np.flatnonzero(newly):
                    outs[i] = tuple(
                        _dense_output(*leaves, h, thetas[i])
                        for leaves in zip(y, y1, y_mid, f, ks[6]))
                filled = filled | newly
            t, y, f = t1, y1, ks[6]
        h = _optimal_step(h, ratio, accept)
        nfe += 6.0
        steps += 1
    # request times never reached (max_steps, endpoint rounding) take the
    # final state
    outs = [y if o is None else o for o in outs]
    stacked = tuple(torch.stack([o[leaf] for o in outs]) for leaf in range(len(y0)))
    return (stacked[0] if single else stacked), nfe
