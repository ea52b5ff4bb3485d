"""The port's discrete backward (``--ode-backward discrete``): odeint_discrete
against the JAX package's on a small ODE, and the train step with the
discrete backward against the continuous adjoint (the port's counterpart of
tests/test_train_infra.py::test_train_step_discrete_backward_matches_adjoint).

The ODE: a two-leaf state (y (4, 6), l (4,)) with dy/dt = (a y - c y^3)(1 +
t) + b and dl/dt = -sum(dy/dt * y), parameters a, b, c, request times with a
repeat.  Elementwise arithmetic only, so that the two frameworks' fields
agree to rounding; at rtol = atol = 1e-5 the step sequences then match and
the outputs and gradients agree to the solver's accuracy:
  - at the default bound: NFE equal; outputs and the gradients of y0, a, b,
    c and ts[1:] within 1e-5 of each one's largest magnitude.  ts[0] is a
    constant of the port's solve: its func takes a host time, and the
    models' solves start at a constant time;
  - at a bound of 4 steps: NFE equal with the +0.5 marker.  The first
    step's error estimate there is rounding noise (a ratio of 5e-4), so the
    two step sequences part in the last bits and the final states (which
    the unreached outputs take) differ by the truncation between two
    nearby times: each side's unreached outputs must equal its own final
    state, and the reached ones agree within 1e-5 as above.

The train step: TINY weights, one batch, the same Hutchinson noise injected,
Adam at 1e-3: losses within 1e-5 relative; the discrete NFE (forward only)
below the adjoint's (forward + backward); updated parameters within 5e-5 +
5e-3 |w| on 99.5% of every leaf's elements and within 1e-3 (one learning
rate) everywhere, the bars of the JAX package's test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.ops.odeint import odeint_discrete as jax_odeint_discrete
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
from caspr_tpu_torch.ops.odeint import (DISCRETE_STEPS, flatten_tree, nfe_exhausted,
                                        odeint_discrete, odeint_train)
from caspr_tpu_torch.train import make_optimizer, make_train_step
from test_torch_port_model import TINY

TOL = 1e-5
TS = np.array([0.0, 0.3, 0.3, 0.9, 1.7], np.float32)


def _problem(seed):
    rng = np.random.default_rng(seed)
    p = [rng.uniform(0.5, 2.0, 6).astype(np.float32),
         (0.3 * rng.standard_normal(6)).astype(np.float32),
         rng.uniform(0.5, 1.5, 6).astype(np.float32)]
    y0 = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((len(TS), 4, 6)).astype(np.float32)
    gl = rng.standard_normal((len(TS), 4)).astype(np.float32)
    return p, y0, g, gl


def _jax_run(seed, steps):
    p, y0, g, gl = _problem(seed)

    def field(t, s, a):
        dy = (a[0] * s[0] - a[2] * s[0] * s[0] * s[0]) * (1.0 + t) + a[1]
        return dy, -jnp.sum(dy * s[0], axis=-1)

    def loss(y0, ts, a):
        (ys, ls), nfe = jax_odeint_discrete(field, (y0, jnp.zeros(4, jnp.float32)), ts, a,
                                            rtol=TOL, atol=TOL, num_steps=steps)
        return jnp.sum(ys * g) + jnp.sum(ls * gl), (ys, ls, nfe)

    (_, (ys, ls, nfe)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(y0), jnp.asarray(TS), [jnp.asarray(v) for v in p])
    return (np.asarray(ys), np.asarray(ls), float(nfe), np.asarray(grads[0]),
            np.asarray(grads[1]), [np.asarray(v) for v in grads[2]])


def _port_run(seed, steps):
    p, y0, g, gl = _problem(seed)
    a = [torch.tensor(v, requires_grad=True) for v in p]
    y0 = torch.tensor(y0, requires_grad=True)
    ts = torch.tensor(TS, requires_grad=True)

    def field(t, s):
        dy = (a[0] * s[0] - a[2] * s[0] * s[0] * s[0]) * (1.0 + float(t)) + a[1]
        return dy, -(dy * s[0]).sum(-1)

    (ys, ls), nfe = odeint_discrete(field, (y0, torch.zeros(4)), ts, rtol=TOL, atol=TOL,
                                    num_steps=steps)
    loss = (ys * torch.from_numpy(g)).sum() + (ls * torch.from_numpy(gl)).sum()
    loss.backward()
    grad = lambda t: np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
    return (ys.detach().numpy(), ls.detach().numpy(), nfe, grad(y0), grad(ts),
            [grad(v) for v in a])


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale, (what, float(np.abs(got - want).max()),
                                                           scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_odeint_discrete_matches_jax(seed):
    ys, ls, nfe, g_y0, g_ts, g_a = _port_run(seed, DISCRETE_STEPS)
    jys, jls, jnfe, jg_y0, jg_ts, jg_a = _jax_run(seed, DISCRETE_STEPS)
    assert nfe == jnfe and not nfe_exhausted(nfe)
    _close(ys, jys, "y")
    _close(ls, jls, "l")
    _close(g_y0, jg_y0, "dy0")
    _close(g_ts[1:], jg_ts[1:], "dts")
    for i, (got, want) in enumerate(zip(g_a, jg_a)):
        _close(got, want, f"da{i}")


@pytest.mark.parametrize("seed", [0, 1])
def test_odeint_discrete_exhaustion_marker(seed):
    steps = 4
    ys, ls, nfe, *_ = _port_run(seed, steps)
    jys, jls, jnfe, *_ = _jax_run(seed, steps)
    assert nfe == jnfe == 2 + 6 * steps + 0.5 and nfe_exhausted(nfe) and nfe_exhausted(jnfe)
    for got, want in ((ys, jys), (ls, jls)):
        reached = [i for i in range(len(TS)) if not np.array_equal(want[i], want[-1])]
        assert reached and reached == [i for i in range(len(TS))
                                       if not np.array_equal(got[i], got[-1])]
        _close(got[reached], want[reached], "reached outputs")


def test_odeint_train_dispatch():
    y0 = torch.ones(2, 3, requires_grad=True)
    w = torch.tensor(0.7, requires_grad=True)
    f = lambda t, y, args: -args[0] * y
    got = {}
    for backward in ("adjoint", "discrete"):
        ys, nfe = odeint_train(f, y0, torch.tensor([0.0, 1.0]), (w,), rtol=1e-6, atol=1e-6,
                               backward=backward)
        got[backward] = torch.autograd.grad(ys[-1].sum(), (y0, w))
        assert not nfe_exhausted(nfe)
    for a, b in zip(got["adjoint"], got["discrete"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        odeint_train(f, y0, torch.tensor([0.0, 1.0]), (w,), rtol=1e-6, atol=1e-6,
                     backward="checkpointed")
    with pytest.raises(ValueError):
        make_train_step(None, None, 0.01, 100.0, ode_backward="checkpointed")


def test_train_step_discrete_backward_matches_adjoint():
    cfg = CaSPRConfig(**TINY)
    model = CaSPRModel(cfg, device="cpu")
    b, t, n = 2, 2, 16
    rng = np.random.default_rng(4)
    x = rng.random((b, t, n, 4), dtype=np.float32)
    x[..., 3] = np.linspace(0.0, 1.0, t, dtype=np.float32)[None, :, None]
    e = torch.from_numpy(rng.standard_normal((b * t, n, 3)).astype(np.float32))
    runs = {}
    for backward in ("adjoint", "discrete"):
        params, state = caspr_init(torch.Generator().manual_seed(4), cfg, device="cpu")
        tx = make_optimizer(1e-3)
        opt = tx.init(params)
        step = make_train_step(model, tx, 0.01, 100.0, ode_backward=backward)
        params, _, _, metrics = step(params, opt, state, x, x, e=e)
        runs[backward] = ([p.detach().numpy() for p in flatten_tree(params)[0]], metrics)
    (p_adj, m_adj), (p_disc, m_disc) = runs["adjoint"], runs["discrete"]
    assert m_disc["nfe"] == m_disc["nfe_forward"] == m_adj["nfe_forward"]
    assert max(m_disc["nfe"]) < max(m_adj["nfe"])
    np.testing.assert_allclose(m_disc["loss"], m_adj["loss"], rtol=1e-5)
    for i, (va, vd) in enumerate(zip(p_adj, p_disc)):
        diff = np.abs(vd - va)
        tight = diff <= 5e-5 + 5e-3 * np.abs(va)
        assert tight.mean() > 0.995, (i, tight.mean())
        assert diff.max() < 1e-3, (i, diff.max())
