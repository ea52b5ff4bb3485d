"""Adaptive Dormand-Prince (dopri5) integration and its continuous adjoint,
in plain PyTorch: the benchmark's own copy of the solver that the CaSPR
model specifies (torchdiffeq's dopri5 as the JAX package pins it down).

- One step size for the whole state (a tuple of tensors); the error ratio
  is the largest over the leaves of each leaf's RMS of
  err / (atol + rtol * max(|y0|, |y1|)).
- Hairer's initial step (one extra evaluation); a controller clipped to
  [0.2, 10] x h that never shrinks an accepted step; a NaN ratio rejects.
- The solver steps past the last request time and fills request times from
  the quartic dense output (slack 1e-6 * max(1, |t1|)).
- NFE starts at 2 (f0 and the step-size probe) and adds 6 per attempted
  step.
- Time, step size and controller are float32 scalars on the host.

``odeint_adjoint`` gives gradients for y0, the request times and the tensor
leaves of ``args`` by re-integrating the augmented system backwards, interval
by interval, at the same tolerances, with the VJPs from autograd.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32

_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float64).astype(F32)
_A = [np.array(row, np.float64).astype(F32) for row in (
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
)]
_B64 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], np.float64)
_B = _B64.astype(F32)
_B_ERR = (_B64 - np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                           187 / 2100, 1 / 40], np.float64)).astype(F32)
_C_MID = (np.array([6025192743 / 30085553152, 0.0, 51252292925 / 65400821598,
                    -2691868925 / 45128329728, 187940372067 / 1594534317056,
                    -1776094331 / 19743644256, 11237099 / 235043384], np.float64) / 2).astype(F32)


def _combine(coeffs, ks):
    out = [float(coeffs[0]) * k for k in ks[0]]
    for c, k in zip(coeffs[1:], ks[1:]):
        out = [o + float(c) * leaf for o, leaf in zip(out, k)]
    return out


def _step_to(y, h, d):
    return tuple(a + float(h) * b for a, b in zip(y, d))


def _rms_max(leaves) -> np.float32:
    rms = torch.stack([torch.sqrt(torch.mean(torch.square(leaf))) for leaf in leaves])
    return F32(rms.max().item())


def _first_step(func, t0, y0, f0, rtol, atol) -> np.float32:
    scale = [atol + rtol * y.abs() for y in y0]
    d0 = _rms_max([y / s for y, s in zip(y0, scale)])
    d1 = _rms_max([f / s for f, s in zip(f0, scale)])
    h0 = F32(1e-6) if d0 < F32(1e-5) or d1 < F32(1e-5) else F32(0.01) * d0 / d1
    f1 = func(t0 + h0, _step_to(y0, h0, f0))
    d2 = _rms_max([(a - b) / s for a, b, s in zip(f1, f0, scale)]) / h0
    dmax = max(d1, d2)
    h1 = (max(F32(1e-6), h0 * F32(1e-3)) if dmax <= F32(1e-15)
          else (F32(0.01) / dmax) ** F32(0.2))
    return min(F32(100.0) * h0, h1)


def _next_step(h, ratio, accepted) -> np.float32:
    if np.isnan(ratio):
        return h * F32(0.2)
    factor = F32(0.9) * max(ratio, F32(1e-10)) ** F32(-0.2)
    return h * min(max(factor, F32(1.0) if accepted else F32(0.2)), F32(10.0))


def _interpolate(y0, y1, y_mid, f0, f1, h, theta):
    hf0, hf1 = float(h) * f0, float(h) * f1
    a = y1 - y0 - hf0
    b = y_mid - y0 - 0.5 * hf0
    c = hf1 - hf0
    c4 = -8.0 * a + 16.0 * b + 2.0 * c
    c3 = 14.0 * a - 32.0 * b - 3.0 * c
    c2 = -5.0 * a + 16.0 * b + c
    th = theta if isinstance(theta, torch.Tensor) else float(theta)
    return y0 + th * (hf0 + th * (c2 + th * (c3 + th * c4)))


def odeint(func, y0, ts, *, rtol: float, atol: float, max_steps: int = 50_000):
    """Integrate dy/dt = func(t, y) for a tuple of leaves y0 and report y at
    every request time of ts (non-decreasing float32, ts[0] the start).
    Returns (tuple of (len(ts), *leaf.shape) tensors, nfe)."""
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
        h = _first_step(func, t, y0, f, rtol, atol)
    y = y0
    filled = ts <= t
    outs = [y0 if done else None for done in filled]
    nfe, steps = 2.0, 0
    while not filled.all() and steps < max_steps and t < t_final:
        ks = [f]
        for i in range(6):
            ks.append(func(t + _C[i + 1] * h, _step_to(y, h, _combine(_A[i], ks))))
        y1 = _step_to(y, h, _combine(_B, ks))
        with torch.no_grad():
            err = [float(h) * d for d in _combine(_B_ERR, ks)]
            ratio = _rms_max([e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
                              for e, a, b in zip(err, y, y1)])
        accept = bool(ratio <= F32(1.0))
        t1 = t + h
        if accept:
            newly = ~filled & (ts <= t1 + F32(1e-6) * max(F32(1.0), abs(t1)))
            if newly.any():
                y_mid = _step_to(y, h, _combine(_C_MID, ks))
                h_div = max(h, F32(1e-30))
                thetas = np.clip((ts - t) / h_div, F32(0.0), F32(1.0))
                for i in np.flatnonzero(newly):
                    theta = (thetas[i] if ts_grad is None else
                             torch.clamp((ts_grad[i] - float(t)) / float(h_div), 0.0, 1.0))
                    outs[i] = tuple(_interpolate(*leaves, h, theta)
                                    for leaves in zip(y, y1, y_mid, f, ks[6]))
                filled = filled | newly
            t, y, f = t1, y1, ks[6]
        h = _next_step(h, ratio, accept)
        nfe += 6.0
        steps += 1
    outs = [y if o is None else o for o in outs]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(len(y0))), nfe


def _flatten(tree):
    """(tensor leaves in order, rebuild(leaves) -> tree)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys, items = list(tree), list(tree.values())
    elif isinstance(tree, (list, tuple)):
        keys, items = None, list(tree)
    else:
        return [], lambda leaves: tree
    parts = [_flatten(v) for v in items]

    def rebuild(flat):
        out, at = [], 0
        for leaves, sub in parts:
            out.append(sub(flat[at:at + len(leaves)]))
            at += len(leaves)
        return dict(zip(keys, out)) if keys is not None else type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, ts, *leaves):
        y0, arg_leaves = leaves[:spec["num_y"]], leaves[spec["num_y"]:]
        args = spec["rebuild"](list(arg_leaves))
        ys, spec["nfe"] = odeint(lambda t, y: spec["func"](t, y, args), y0, ts,
                                 rtol=spec["rtol"], atol=spec["atol"])
        ctx.spec = spec
        ctx.save_for_backward(ts, *ys, *arg_leaves)
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        spec = ctx.spec
        num_y, func, rebuild = spec["num_y"], spec["func"], spec["rebuild"]
        saved = ctx.saved_tensors
        ts, ys = saved[0], saved[1:1 + num_y]
        arg_leaves = [a.detach() for a in saved[1 + num_y:]]
        g_ys = [torch.zeros_like(y) if g is None else g for g, y in zip(g_ys, ys)]
        times = ts.detach().cpu().numpy().astype(F32)

        def plain(t, y):
            with torch.no_grad():
                return func(t, y, rebuild(arg_leaves))

        a_y = tuple(g[-1] for g in g_ys)
        a_args = tuple(torch.zeros_like(a) for a in arg_leaves)
        nfe_bwd, dldts = 0.0, []
        for i in range(len(times) - 1, 0, -1):
            y_i = tuple(y[i] for y in ys)
            dldts.append(_dot([g[i] for g in g_ys], plain(times[i], y_i)))
            t_hi = times[i]

            def augmented(s, state, t_hi=t_hi):
                with torch.enable_grad():
                    y = tuple(v.detach().requires_grad_() for v in state[:num_y])
                    args = [v.detach().requires_grad_() for v in arg_leaves]
                    f = func(t_hi - s, y, rebuild(args))
                    pairs = [(fo, ao) for fo, ao in zip(f, state[num_y:2 * num_y])
                             if fo.requires_grad]
                    grads = torch.autograd.grad([fo for fo, _ in pairs], (*y, *args),
                                                grad_outputs=[ao for _, ao in pairs],
                                                allow_unused=True)
                vjp = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, (*y, *args))]
                return (*(-fo.detach() for fo in f), *vjp)

            aug, aug_nfe = odeint(augmented, (*y_i, *a_y, *a_args),
                                  np.array([0.0, times[i] - times[i - 1]], F32),
                                  rtol=spec["rtol"], atol=spec["atol"])
            a_lo = tuple(leaf[1] for leaf in aug[num_y:2 * num_y])
            a_args = tuple(leaf[1] for leaf in aug[2 * num_y:])
            nfe_bwd += aug_nfe + 1.0
            a_y = tuple(a + g[i - 1] for a, g in zip(a_lo, g_ys))
        dldt0 = -_dot(a_lo, plain(times[0], tuple(y[0] for y in ys)))
        grad_ts = torch.stack([dldt0, *reversed(dldts)]).to(ts)
        spec["nfe_bwd"][0] += nfe_bwd + 1.0
        return (None, grad_ts, *a_y, *a_args)


def odeint_adjoint(func, y0, ts, args, *, rtol: float, atol: float, nfe_bwd: list):
    """``odeint`` of func(t, y, args) with gradients by the continuous adjoint
    for y0, ts (a float32 tensor, at least two times) and the tensor leaves
    of args; the backward NFE is added to ``nfe_bwd[0]``."""
    y_leaves = tuple(y0)
    arg_leaves, rebuild = _flatten(args)
    spec = {"func": func, "rebuild": rebuild, "num_y": len(y_leaves), "rtol": rtol,
            "atol": atol, "nfe_bwd": nfe_bwd}
    ys = _Adjoint.apply(spec, ts, *y_leaves, *arg_leaves)
    return tuple(ys), spec["nfe"]
