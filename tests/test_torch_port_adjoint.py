"""The port's continuous adjoint against the JAX package's on the CPU, and
the encoder's backward in float64.

Inputs, weights and the Hutchinson noise are numpy arrays made from a seed
and handed to both sides.

Tolerances:
  - NFE forward and backward: equal (the solvers take the same steps: a
    difference is a different accept decision, not rounding);
  - adjoint gradients: 1e-4 relative to each leaf's largest magnitude
    (float32 states integrated over some 10 to 40 steps: the port's and the
    JAX package's augmented dynamics round differently at every
    evaluation, and the solver's local error tolerance is 1e-5 for the
    CNF);
  - the encoder's gradients in float64: 1e-9 relative to each leaf's
    largest.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models import latent_ode as jlode
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.ops.odeint import odeint_adjoint as jax_odeint_adjoint
from caspr_tpu.train import loop as jloop
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig
from caspr_tpu_torch.models.latent_ode import dynamics_apply
from caspr_tpu_torch.ops import pointops
from caspr_tpu_torch.ops.odeint import NFESink, flatten_tree, odeint_adjoint
from test_torch_port_model import TINY, _numpy_weights
from test_torch_port_train import _close, _leaves, _np_tree, _t, _to_torch

ADJ_TOL = 1e-4


def _stop_gradient_noise(monkeypatch):
    """Make the JAX package treat the Hutchinson noise as a constant of the
    adjoint, as its TPU kernel's VJP and the port do (on the CPU route at
    widths that are no lane multiples it differentiates jax.jvp in e)."""
    make = jcnf._make_dynamics

    def patched(cfg, reverse, with_div=True):
        dyn = make(cfg, reverse, with_div)

        def dynamics(t, states, args):
            if "e" in args:
                args = {**args, "e": jax.lax.stop_gradient(args["e"])}
            return dyn(t, states, args)

        return dynamics

    monkeypatch.setattr(jcnf, "_make_dynamics", patched)


def test_adjoint_latent_ode_matches_jax():
    """The TINY latent MLP (tanh, N(0, 0.1) weights) at request times with
    repeats: zero-length intervals cost the solver's two initial
    evaluations, and the adjoint's count must show them as the JAX one
    does."""
    lcfg = CaSPRConfig(**TINY).latent_ode_config()
    jparams = jlode.dynamics_init(jax.random.PRNGKey(4), jlode.LatentODEConfig(
        input_size=lcfg.input_size, hidden_size=lcfg.hidden_size))
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((2, lcfg.input_size)).astype(np.float32)
    ts = np.array([0.0, 0.1, 0.1, 0.35, 0.6, 0.6, 1.0], np.float32)
    w = rng.standard_normal((len(ts), 2, lcfg.input_size)).astype(np.float32)
    tol = dict(rtol=lcfg.rtol, atol=lcfg.atol)

    def jloss(z0, p, ts, sink):
        zs, nfe = jax_odeint_adjoint(jlode._ode_func, z0, ts, p, nfe_sink=sink, **tol)
        return jnp.sum(zs * jnp.asarray(w)), nfe

    (_, want_nfe), want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(z0), jparams, jnp.asarray(ts), jnp.zeros((), jnp.float32))
    params = _to_torch(_np_tree(jparams))
    leaves, rebuild = flatten_tree(params)
    for leaf in leaves:
        leaf.requires_grad_()
    z0_t, ts_t = _t(z0).requires_grad_(), _t(ts).requires_grad_()
    sink = NFESink()
    zs, nfe = odeint_adjoint(lambda t, z, p: dynamics_apply(p, z), z0_t, ts_t, params,
                             nfe_sink=sink, **tol)
    (zs * _t(w)).sum().backward()
    assert nfe == float(want_nfe)
    assert sink.value == float(want[3]) and sink.value > 5 * (len(ts) - 1)
    _close(z0_t.grad, want[0], ADJ_TOL)
    _close(ts_t.grad, want[2], ADJ_TOL)
    for got, ref in zip(leaves, _leaves(want[1]), strict=True):
        _close(got.grad, ref, ADJ_TOL)


def test_adjoint_cnf_block_matches_jax(monkeypatch):
    """One TINY CNF block (3 -> 32 -> 32 -> 3, zdim 160) forward with the
    adjoint, the noise the JAX side drew injected: gradients of the points,
    the log-density, the context, every ODEnet leaf and sqrt_end_time (a
    non-zero dL/dts[1] through t_end = sqrt_end_time^2), and both NFE.  The
    JAX package's own CPU route, whose adjoint carries a non-zero e leaf,
    takes the same number of backward evaluations on this block."""
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    block = _numpy_weights(shapes[0], rng)["point_cnf"][1]
    ccfg = jcfg.cnf_config()
    bt, n = 3, 40
    x = (0.5 * rng.standard_normal((bt, n, 3))).astype(np.float32)
    ctx = (0.5 * rng.standard_normal((bt, ccfg.zdim))).astype(np.float32)
    lp = np.zeros((bt, n, 1), np.float32)
    wy = rng.standard_normal((bt, n, 3)).astype(np.float32)
    wl = rng.standard_normal((bt, n, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    e = np.asarray(jax.random.normal(key, (bt, n, 3), jnp.float32))

    def jloss(p, x, c, lp, sink):
        y, logpy, nfe = jcnf.cnf_block_apply(p, ccfg, x, c, lp, key, False, nfe_sink=sink)
        return jnp.sum(y * wy) + jnp.sum(logpy * wl), nfe

    jblock = jax.tree_util.tree_map(jnp.asarray, block)
    run = lambda: jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jblock, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(lp), jnp.zeros((), jnp.float32))
    unwrapped_bwd_nfe = float(run()[1][4])
    _stop_gradient_noise(monkeypatch)
    (_, want_nfe), want = run()
    assert unwrapped_bwd_nfe == float(want[4])
    params = _to_torch(block)
    leaves, _ = flatten_tree(params)
    for leaf in leaves:
        leaf.requires_grad_()
    x_t, ctx_t, lp_t = (_t(a).requires_grad_() for a in (x, ctx, lp))
    sink = NFESink()
    y, logpy, nfe = cnf.cnf_block_forward(params, CaSPRConfig(**TINY).cnf_config(), x_t, ctx_t,
                                          lp_t, _t(e), training=True, nfe_sink=sink)
    ((y * _t(wy)).sum() + (logpy * _t(wl)).sum()).backward()
    assert nfe == float(want_nfe)
    assert sink.value == float(want[4])
    want_leaves = _leaves(want[0])
    assert len(leaves) == len(want_leaves) == 1 + 3 * 5  # sqrt_end_time last in both trees
    for got, ref in zip(leaves, want_leaves):
        _close(got.grad, ref, ADJ_TOL)
    assert float(params["sqrt_end_time"].grad) != 0.0
    for got, ref in zip((x_t, ctx_t, lp_t), want[1:4]):
        _close(got.grad, ref, ADJ_TOL)


# ----------------------- the encoder's backward in float64 -----------------


def test_encoder_gradients_in_float64_match_jax(monkeypatch):
    """The encoder's backward is the JAX package's, to rounding: its
    T-NOCS-loss gradients at TINY agree to 1e-9 of each leaf's largest in
    float64 on both sides.  (In float32 they do not, at TINY's radii: a ball
    of copies of one point makes GroupNorm normalise a rounding residue,
    and the ReLU after it lets it through by its sign; see TRAIN in
    tests/test_torch_port_train_step.py.)  The kernel wrappers take float32
    only, so the port runs its plain point ops here, whose backward the
    wrappers' equals (test_kernel_wrappers_differentiate_as_the_plain_versions)."""
    from jax._src.config import enable_x64

    from caspr_tpu.models.caspr import CaSPRModel as JaxModel
    from caspr_tpu_torch.models import pointnet2
    from caspr_tpu_torch.models.caspr import CaSPRModel
    from caspr_tpu_torch.train import compute_losses

    kw = dict(TINY, pretrain_tnocs=True)
    jcfg = JaxConfig(**kw)
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    params_np = _numpy_weights(shapes[0], rng)
    x = rng.random((2, 3, 48, 4))
    x[..., :3] *= 0.15
    x[..., 3] = np.linspace(0.0, 5.0, 3)[None, :, None]
    target = rng.random((2, 3, 48, 4))
    jmodel = JaxModel(jcfg)

    def jloss(p):
        out, _ = jmodel.forward(p, {}, jnp.asarray(x), jnp.asarray(target), jax.random.PRNGKey(0))
        return jloop.compute_losses(out, 0.01, 100.0)[0]

    with enable_x64(True):
        want = _leaves(jax.jit(jax.grad(jloss))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params_np)))
    for name in ("farthest_point_sampling", "gather_points", "ball_query", "ball_query_pair",
                 "three_nn", "three_interpolate"):
        monkeypatch.setattr(pointnet2, name, getattr(pointops, name))
    params = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(), params_np)
    out, _ = CaSPRModel(CaSPRConfig(**kw), device="cpu").forward(
        params, {}, torch.from_numpy(x), torch.from_numpy(target), training=True)
    got = torch.autograd.grad(compute_losses(out, 0.01, 100.0)[0], jax.tree_util.tree_leaves(params))
    for g, w in zip(got, want, strict=True):
        if np.abs(w).max() > 1e-12:  # conv biases ahead of one-channel groups: 0 in exact arithmetic
            _close(g, w, 1e-9)
