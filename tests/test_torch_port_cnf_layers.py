"""Every diffeq layer type and nonlinearity of the CNF against the JAX
package on the CPU.

The JAX package's ODEnet (caspr_tpu/models/cnf.py::odenet_apply) takes one
of seven layer types and seven nonlinearities (swish with a learned beta
per layer); the port's composition (``ops.cnf_fused.reference_primal``,
``reference_dynamics``) takes them all.  Weights come from the JAX
package's ``odenet_init`` / ``flow_init`` (swish_beta drawn away from its
initial 1, so that each layer's beta counts), inputs and the Hutchinson
noise from numpy seeds or the JAX package's own key split; widths are
(16, 16), zdim 8, 32 points.  No config here is one the fused kernels take
(``kernel_takes``), as none of them but concatsquash with softplus is one
the JAX package's kernel takes.

The JAX side runs eagerly (``jax.disable_jit``), op by op as PyTorch runs:
its flows are within 2.4e-7 of its jitted ones here at a fraction of the
compile time, and its jitted gradient can take other steps than its eager
one.  On concat_v2's draw the adjoint's backward solve takes its second
step from a first error ratio of 1.1e-5, float32 rounding: the JAX
package's jitted gradient took 22 backward evaluations, its eager one 16,
the port 16.

Tolerances:
  - the field (dx and e^T J e), all 7 x 7 configs: 1e-5 abs against
    ``_make_dynamics``'s jax.jvp route (2.9e-6 read, on square's largest
    values); the analytic tangent against autograd's jvp of the port's own
    primal, 1e-5 abs;
  - the flow in both directions, each layer type with softplus and each
    nonlinearity with concatsquash: equal NFE, points and log-density
    1e-4 abs (tests/test_torch_port_composition.py's bar);
  - the VJP of the field per layer type (and swish): every leaf's, the
    context's and the points' cotangent within 1e-5 of its largest against
    jax.grad through ``_make_dynamics`` (1e-6 read);
  - one adjoint step of a flow-only NLL (MovingBatchNorm statistics
    updated), each layer type with softplus and swish, and one discrete
    step: equal forward and backward NFE, the loss 1e-5 relative, the new
    MovingBatchNorm state 1e-4 relative, and each gradient leaf
    (swish_beta's among them) and the context's at GRAD_TOL of
    tests/test_torch_port_train_step.py as that file applies it (1e-4 of
    the leaf's largest gradient, plus 1e-6 of its largest weight), or at
    twice the leaf's float32 floor where that is larger: the distance of
    the port's float32 gradient from its float64 one, measured here.  The
    float32 gradient through the adjoint is ill-conditioned on
    concatscale's draw whatever computes it: the port's float32 gradient
    lies 4.6 times GRAD_TOL's bar from its float64 one on its worst leaf,
    the JAX package's 2.0 times from the port's, with the same steps (its
    jitted gradient 3.1e-4 of a first-layer leaf's largest from the port's
    float64 one); the field's VJP agrees to 5e-7 there.  On the other
    seven draws every leaf is within 0.12 of the bar.

The weights are flow_init's as drawn (no gain, unlike
tests/test_torch_port_model.py's CNF_GAIN of 6): at these widths a gain of
6 makes several fields blow up (ignore with softplus reaches 1.8e7 in the
forward solve, concat_v2 3.8e4), and relu's kinks take the forward solve
from 50 evaluations at gain 1 to 992 at 6.  Equal NFE is an accept
decision per step; where an error ratio lands within rounding of 1 a
decision can flip with the order of the sums: at a gain of 2 one draw did
(concatsquash with swish, forward, 20 evaluations against the JAX
package's 14, the points within 1.2e-7 of each other).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.ops.sampling import standard_normal_logprob as jax_logprob
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init
from caspr_tpu_torch.ops import cnf_fused
from caspr_tpu_torch.ops.odeint import NFESink, flatten_tree
from caspr_tpu_torch.ops.sampling import standard_normal_logprob
from caspr_tpu_torch.train.checkpoint import load_checkpoint, load_weights, save_checkpoint
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_adjoint import _stop_gradient_noise
from test_torch_port_model import TINY, _numpy_weights
from test_torch_port_train_step import GRAD_TOL

LAYER_TYPES = ("ignore", "concat", "concat_v2", "squash", "scale", "concatsquash", "concatscale")
NONLINEARITIES = ("tanh", "relu", "softplus", "elu", "square", "identity", "swish")
# the flows: each layer type with softplus, each other nonlinearity with
# concatsquash
FLOWS = [(lt, "softplus") for lt in LAYER_TYPES] + [
    ("concatsquash", nl) for nl in NONLINEARITIES if nl != "softplus"]
# the adjoint step: each layer type with softplus, and swish
STEPS = [(lt, "softplus") for lt in LAYER_TYPES] + [("concatsquash", "swish")]
DIMS, ZDIM, BT, N = (16, 16), 8, 4, 32
FIELD_TOL, POINT_TOL = 1e-5, 1e-4
ids = lambda c: "-".join(c)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return _t(tree)


def _jcfg(layer_type, nonlinearity, **kw):
    return jcnf.CNFConfig(dims=DIMS, zdim=ZDIM, layer_type=layer_type,
                          nonlinearity=nonlinearity, **kw)


def _port_cfg(jcfg):
    return cnf.CNFConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def _draw_betas(odenet, rng, gain=1.0):
    """The CNF layers' weights times ``gain``, and swish's betas drawn in
    [0.5, 1.5]."""
    odenet = dict(odenet, layers=[
        {k: dict(v, weight=v["weight"] * gain) if k == "_layer" else v for k, v in lp.items()}
        for lp in odenet["layers"]])
    if "swish_beta" in odenet:
        odenet["swish_beta"] = jnp.asarray(
            rng.uniform(0.5, 1.5, odenet["swish_beta"].shape).astype(np.float32))
    return odenet


# ------------------------------- the field --------------------------------


@pytest.mark.parametrize("nonlinearity", NONLINEARITIES)
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_field_matches_jax_jvp(layer_type, nonlinearity):
    """(dx, e^T J e) of the port's composition against the JAX package's
    dynamics (odenet_apply under jax.jvp), and the analytic tangent against
    autograd's jvp of the port's primal."""
    cfg = _jcfg(layer_type, nonlinearity)
    rng = np.random.default_rng(5)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(3), cfg)
    if nonlinearity == "swish":
        jparams["swish_beta"] = jnp.asarray(rng.uniform(0.5, 1.5, 2).astype(np.float32))
    y, e = (rng.standard_normal((BT, N, 3)).astype(np.float32) for _ in range(2))
    ctx = rng.standard_normal((BT, ZDIM)).astype(np.float32)
    t = np.float32(0.3)
    dynamics = jcnf._make_dynamics(cfg, reverse=False)
    args = {"params": jparams, "context": jnp.asarray(ctx), "t_end": jnp.float32(0.5),
            "e": jnp.asarray(e)}
    want_dx, minus_div = dynamics(jnp.float32(t), (jnp.asarray(y.reshape(BT, -1)),
                                                   jnp.zeros((BT, N))), args)
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    tc = torch.cat([torch.full((BT, 1), float(t)), _t(ctx)], dim=1)
    dx, div = cnf_fused.reference_dynamics(params, tc, _t(y), _t(e), layer_type, nonlinearity)
    np.testing.assert_allclose(dx.numpy().reshape(BT, -1), np.asarray(want_dx), rtol=0,
                               atol=FIELD_TOL)
    np.testing.assert_allclose(div.numpy(), -np.asarray(minus_div), rtol=0, atol=FIELD_TOL)
    primal = lambda v: cnf_fused.reference_primal(params, tc, v, layer_type, nonlinearity)
    p_dx, jvp = torch.autograd.functional.jvp(primal, _t(y), _t(e))
    np.testing.assert_allclose(p_dx.numpy(), dx.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose((jvp * _t(e)).sum(-1).numpy(), div.numpy(), rtol=0, atol=FIELD_TOL)


@pytest.mark.parametrize("config", STEPS, ids=ids)
def test_field_vjp_matches_jax_grad(config):
    """Autograd through the port's composition (the adjoint's VJP) against
    jax.grad through the JAX package's dynamics, the noise a constant."""
    layer_type, nonlinearity = config
    cfg = _jcfg(layer_type, nonlinearity)
    rng = np.random.default_rng(6)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(4), cfg)
    if nonlinearity == "swish":
        jparams["swish_beta"] = jnp.asarray(rng.uniform(0.5, 1.5, 2).astype(np.float32))
    y, e, ct_dx = (rng.standard_normal((BT, N, 3)).astype(np.float32) for _ in range(3))
    ctx = rng.standard_normal((BT, ZDIM)).astype(np.float32)
    ct_div = rng.standard_normal((BT, N)).astype(np.float32)
    dynamics = jcnf._make_dynamics(cfg, reverse=False)

    def loss(params, context, points):
        args = {"params": params, "context": context, "t_end": jnp.float32(0.5),
                "e": jax.lax.stop_gradient(jnp.asarray(e))}
        dx, minus_div = dynamics(jnp.float32(0.3), (points.reshape(BT, -1), jnp.zeros((BT, N))),
                                 args)
        return jnp.sum(dx * ct_dx.reshape(BT, -1)) - jnp.sum(minus_div * ct_div)

    want = jax.grad(loss, argnums=(0, 1, 2))(jparams, jnp.asarray(ctx), jnp.asarray(y))
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = jax.tree_util.tree_leaves(params)
    c, points = _t(ctx).requires_grad_(), _t(y).requires_grad_()
    for leaf in leaves:
        leaf.requires_grad_()
    tc = torch.cat([torch.full((BT, 1), 0.3), c], dim=1)
    dx, div = cnf_fused.reference_dynamics(params, tc, points, _t(e), layer_type, nonlinearity)
    ((dx * _t(ct_dx)).sum() + (div * _t(ct_div)).sum()).backward()
    got = [leaf.grad for leaf in leaves] + [c.grad, points.grad]
    for g, w in zip(got, jax.tree_util.tree_leaves(want[0]) + [want[1], want[2]]):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()  # ignore: no path from the context
        assert float(np.abs(g - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-30)


def test_unknown_layer_type_and_nonlinearity_raise():
    params = {"layers": [{"_layer": {"weight": torch.ones(3, 3), "bias": torch.zeros(3)}}]}
    with pytest.raises(ValueError, match="layer type"):
        cnf_fused.reference_primal(params, torch.ones(1, 2), torch.ones(1, 4, 3), "bogus", "relu")
    with pytest.raises(ValueError, match="nonlinearity"):
        cnf_fused._act("bogus")
    with pytest.raises(ValueError, match="layer type"):
        cnf.flow_param_shapes(cnf.CNFConfig(layer_type="bogus"))


# ------------------------------- the flows --------------------------------


def flow_problem(jcfg, seed, gain=1.0):
    """flow_init weights, MovingBatchNorm running variances away
    from 1, points, a context and the JAX key; returns the JAX trees and the
    port's."""
    k_init, key = jax.random.split(jax.random.PRNGKey(seed))
    jparams, jstate = jcnf.flow_init(k_init, jcfg)
    rng = np.random.default_rng(seed)
    jparams = [dict(p, odenet=_draw_betas(p["odenet"], rng, gain)) if "odenet" in p else p
               for p in jparams]
    jstate = [dict(s, running_var=jnp.asarray(rng.uniform(0.5, 1.5, 3).astype(np.float32)))
              if s else s for s in jstate]
    x = (0.5 * rng.standard_normal((BT, N, 3))).astype(np.float32)
    ctx = rng.standard_normal((BT, jcfg.zdim)).astype(np.float32)
    n_cnf = jcfg.chain().count("cnf")
    e = [np.asarray(jax.random.normal(k, (BT, N, 3), jnp.float32))
         for k in jax.random.split(key, n_cnf)]
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return dict(jparams=jparams, jstate=jstate, key=key, x=x, ctx=ctx, e=e,
                params=_to_torch(as_np(jparams)), state=_to_torch(as_np(jstate)),
                cfg=_port_cfg(jcfg), jcfg=jcfg)


def check_flow_both_ways(prob):
    """flow_reverse and flow_forward against flow_apply (reverse, and
    forward with a zero log-density), the JAX side eager."""
    jcfg, x, ctx = prob["jcfg"], jnp.asarray(prob["x"]), jnp.asarray(prob["ctx"])
    with jax.disable_jit():
        want_rev, _, _, want_rev_nfe = jcnf.flow_apply(
            prob["jparams"], prob["jstate"], jcfg, x, ctx, None, prob["key"], reverse=True)
        want_y, want_lp, _, want_nfe = jcnf.flow_apply(
            prob["jparams"], prob["jstate"], jcfg, x, ctx, jnp.zeros((BT, N, 1)), prob["key"])
    rev, rev_nfe = cnf.flow_reverse(prob["params"], prob["state"], prob["cfg"], _t(prob["x"]),
                                    _t(prob["ctx"]))
    y, lp, _, nfe = cnf.flow_forward(prob["params"], prob["state"], prob["cfg"], _t(prob["x"]),
                                     _t(prob["ctx"]), torch.zeros((BT, N, 1)),
                                     e=[_t(e) for e in prob["e"]])
    assert (rev_nfe, nfe) == (float(want_rev_nfe), float(want_nfe))
    for got, want in ((rev, want_rev), (y, want_y), (lp, want_lp)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=POINT_TOL)


@pytest.mark.parametrize("config", FLOWS, ids=ids)
def test_flow_both_directions_match_jax(config):
    check_flow_both_ways(flow_problem(_jcfg(*config), seed=len(config[0]) + 7))


# --------------------------- the adjoint step -----------------------------


def _port_step(prob, dtype, e, ode_backward):
    """The port's flow-only NLL and its gradient, in ``dtype``."""
    cast = lambda tree: jax.tree_util.tree_map(lambda t: t.detach().to(dtype).clone(), tree)
    params = jax.tree_util.tree_map(lambda t: t.requires_grad_(), cast(prob["params"]))
    ctx = _t(prob["ctx"]).to(dtype).requires_grad_()
    sink = NFESink()
    y, lp, state, nfe = cnf.flow_forward(params, cast(prob["state"]), prob["cfg"],
                                         _t(prob["x"]).to(dtype), ctx,
                                         torch.zeros((BT, N, 1), dtype=dtype),
                                         e=[_t(v).to(dtype) for v in e], training=True,
                                         nfe_sink=sink, ode_backward=ode_backward)
    loss = (-(standard_normal_logprob(y).sum(-1) - lp[..., 0])).mean()
    loss.backward()
    grads = [t.grad.numpy() for t in jax.tree_util.tree_leaves(params)] + [ctx.grad.numpy()]
    weights = [t.detach().numpy() for t in jax.tree_util.tree_leaves(params)] + [
        ctx.detach().numpy()]
    return float(loss.detach()), state, nfe, sink.value, grads, weights


def run_step(jcfg, seed, ode_backward="adjoint"):
    """One adjoint (or discrete) step's loss and gradients on both sides,
    and the port's gradient in float64."""
    prob = flow_problem(jcfg, seed)

    def loss(params, state, x, ctx, key, sink):
        y, lp, new_state, nfe = jcnf.flow_apply(params, state, jcfg, x, ctx,
                                                jnp.zeros((BT, N, 1)), key, training=True,
                                                nfe_sink=sink)
        nll = -(jnp.sum(jax_logprob(y), axis=-1) - lp[..., 0])
        return jnp.mean(nll), (new_state, nfe)

    with pytest.MonkeyPatch.context() as mp:
        _stop_gradient_noise(mp)
        if ode_backward == "discrete":
            mp.setenv("CASPR_TPU_ODE_BWD", "discrete")
        with jax.disable_jit():
            (want_loss, (want_state, want_nfe)), (gp, gc, gsink) = jax.value_and_grad(
                loss, argnums=(0, 3, 5), has_aux=True)(
                prob["jparams"], prob["jstate"], jnp.asarray(prob["x"]),
                jnp.asarray(prob["ctx"]), prob["key"], jnp.zeros(()))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(gp)]
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(gp)] + [np.asarray(gc)]
    return dict(want=(float(want_loss), want_state, float(want_nfe), float(gsink), want),
                got=_port_step(prob, torch.float32, prob["e"], ode_backward),
                float64=_port_step(prob, torch.float64, prob["e"], ode_backward)[4],
                paths=paths + ["ctx"])


def check_step(run):
    want_loss, want_state, want_nfe, want_bwd, want = run["want"]
    got_loss, state, nfe, bwd, got, old = run["got"]
    assert nfe == want_nfe
    assert bwd == want_bwd
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    # GRAD_TOL's bar as tests/test_torch_port_train_step.py applies it to
    # the weights after one step of plain gradient descent at rate 1 (the
    # leaf's largest gradient times rel, plus 1e-6 of its largest weight),
    # or twice the leaf's float32 floor where that is larger
    rel, floor = GRAD_TOL["point_cnf"]
    assert floor == 0.0
    assert len(got) == len(want) == len(run["float64"]) == len(run["paths"])
    for path, g, w, o, g64 in zip(run["paths"], got, want, old, run["float64"]):
        err = float(np.abs((o - g) - (o - w)).max())
        bar = rel * float(np.abs(w).max()) + 1e-6 * float(np.abs(o).max())
        float32_floor = float(np.abs(g - g64).max())
        assert err <= max(bar, 2.0 * float32_floor), (path, err, bar, float32_floor)
    for s, ws in zip(state, want_state):
        for k in s:
            np.testing.assert_allclose(s[k].numpy(), np.asarray(ws[k]), rtol=1e-4, atol=0)
    return run["paths"]


@pytest.mark.parametrize("config", STEPS, ids=ids)
def test_adjoint_step_matches_jax_grad(config):
    paths = check_step(run_step(_jcfg(*config), seed=len(config[0]) + 7))
    assert any("swish_beta" in p for p in paths) == (config[1] == "swish")


def test_discrete_step_matches_jax_grad():
    check_step(run_step(_jcfg("squash", "softplus"), seed=13, ode_backward="discrete"))


# --------------------- the leaves through the port's trees -----------------


@pytest.mark.parametrize("config", [("concat", "softplus"), ("squash", "swish"),
                                    ("concat_v2", "tanh"), ("concatscale", "elu")], ids=ids)
def test_new_leaves_load_save_and_flatten(config, tmp_path):
    """caspr_param_shapes, params_from_jax, caspr_init's draw, checkpoints
    and flatten_tree carry each layer type's leaves and swish_beta; a
    missing or misshapen leaf still raises."""
    layer_type, nonlinearity = config
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    ccfg = jcnf.CNFConfig(zdim=jcfg.latent_feat_size, dims=tuple(jcfg.cnf_dims),
                          layer_type=layer_type, nonlinearity=nonlinearity)
    flow = jax.tree_util.tree_map(np.asarray, jcnf.flow_init(jax.random.PRNGKey(2), ccfg)[0])
    params_np["point_cnf"] = flow
    cfg = CaSPRConfig(**TINY, cnf_layer_type=layer_type, cnf_nonlinearity=nonlinearity)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    want = jax.tree_util.tree_leaves(flow)
    got = jax.tree_util.tree_leaves(params["point_cnf"])
    assert len(got) == len(want) and all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    odenet = params["point_cnf"][1]["odenet"]
    assert ("swish_beta" in odenet) == (nonlinearity == "swish")
    first = odenet["layers"][0]
    if layer_type == "concat":
        assert tuple(first["_layer"]["weight"].shape) == (cfg.cnf_dims[0], 3 + 1 + cfg.latent_feat_size)
    # flatten_tree carries every leaf, rebuild puts them back
    leaves, rebuild = flatten_tree(params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(params))
    assert rebuild(leaves)["point_cnf"][1]["odenet"].keys() == odenet.keys()
    # a checkpoint round trip
    path = str(tmp_path / "ck.pkl")
    save_checkpoint(path, params, state)
    fresh, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    loaded = load_weights(fresh, load_checkpoint(path)["params"])
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)
    # caspr_init: swish_beta ones; every linear leaf in +-1/sqrt(in)
    fresh_odenet = fresh["point_cnf"][1]["odenet"]
    if nonlinearity == "swish":
        assert torch.equal(fresh_odenet["swish_beta"], torch.ones(len(cfg.cnf_dims)))
    for lp in fresh_odenet["layers"]:
        for name, lin in lp.items():
            bound = 1.0 / np.sqrt(lin["weight"].shape[1])
            for leaf in lin.values():
                assert float(leaf.abs().max()) <= bound and float(leaf.abs().max()) > 0, name
    # a missing or misshapen leaf raises
    if nonlinearity == "swish":
        del params_np["point_cnf"][1]["odenet"]["swish_beta"]
        with pytest.raises(ValueError, match="swish_beta: missing"):
            params_from_jax(params_np, state_np, cfg, device="cpu")
    else:
        lin = params_np["point_cnf"][1]["odenet"]["layers"][0]["_layer"]
        lin["weight"] = lin["weight"][:, :-1]
        with pytest.raises(ValueError, match="_layer.weight: shape"):
            params_from_jax(params_np, state_np, cfg, device="cpu")

