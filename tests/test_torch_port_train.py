"""The port's training pieces against the JAX package on the CPU: the VJP of
the CNF dynamics (the cnf_dynamics_vjp kernel's plain version), the NFE
helpers, the MovingBatchNorm update, the autograd of the encoder's kernel
wrappers, caspr_init, Adam and checkpoints.  The adjoint is in
tests/test_torch_port_adjoint.py, the train step in
tests/test_torch_port_train_step.py.

Inputs, weights, cotangents and the Hutchinson noise are numpy arrays made
from a seed and handed to both sides.

Tolerances:
  - dynamics VJP at H = 128: 2e-5 abs + 2e-5 relative against jax.vjp of
    the XLA composition and against torch autograd (float32 sums of 128 to
    400 terms in another order; as tests/test_cnf_fused.py holds the JAX
    package's own manual VJP), 5e-4 against the Pallas kernel in interpret
    mode (as tests/test_cnf_fused.py holds that kernel);
  - MovingBatchNorm statistics 1e-6 (float32 means and variances of 300
    numbers summed in another order);
  - the gather and interpolation backwards: identical to autograd of the
    plain versions (the same scatter-add, the same sums);
  - Adam: 1e-6 relative over five steps (the same arithmetic in another
    order of operations);
  - checkpoints: bit-identical leaves.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu.train import checkpoint as jcheckpoint
from caspr_tpu.train import loop as jloop
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init, caspr_param_shapes
from caspr_tpu_torch.ops import cnf_fused, kernels, pointops
from caspr_tpu_torch.ops.odeint import flatten_tree, nfe_add, nfe_sum
from caspr_tpu_torch.train import checkpoint, make_optimizer
from test_torch_port_model import REPO, TINY

VJP_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return _t(np.asarray(tree, np.float32))


def _leaves(tree):
    """numpy leaves of a JAX tree, in JAX's order (dict keys sorted), which
    is flatten_tree's order for trees built from JAX ones."""
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


def _close(got, want, rel):
    """|got - want| <= rel * max|want|, per leaf."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


# ------------------------------ dynamics VJP -------------------------------


@pytest.fixture(scope="module")
def vjp_case():
    """CNFConfig(dims=(128, 128), zdim=8): one hidden layer, L = 3; a
    ragged cloud of 200 points, random cotangents."""
    cfg = jcnf.CNFConfig(input_dim=3, dims=(128, 128), zdim=8)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    arr = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)
    case = dict(jparams=jparams, params=_to_torch(_np_tree(jparams)), tc=arr(2, 9, s=0.5),
                y=arr(2, 200, 3), e=arr(2, 200, 3), ct_dx=arr(2, 200, 3), ct_div=arr(2, 200))
    tc = _t(case["tc"])
    case["packed"] = (cnf_fused.context_gb(case["params"], tc), *cnf_fused.pack_weights(case["params"]))
    return case


@pytest.mark.parametrize("oracle", ["jax_vjp", "pallas_interpret", "torch_autograd"])
def test_dynamics_vjp_packed(vjp_case, oracle):
    c = vjp_case
    y, e, ct_dx, ct_div = (_t(c[k]) for k in ("y", "e", "ct_dx", "ct_div"))
    gb, wf, wh, wl = c["packed"]
    got = cnf_fused.dynamics_vjp_packed(y, e, gb, wf, wh, wl, ct_dx, ct_div)
    # the wrapper takes the plain version on the CPU, and counts nothing
    kernels.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(
        kernels.cnf_dynamics_vjp(y, e, gb, wf, wh, wl, ct_dx, ct_div), got))
    assert kernels.launches["cnf_dynamics_vjp"] == 0
    if oracle == "torch_autograd":
        leaves = [t.clone().requires_grad_() for t in (y, gb, wf, wh, wl)]
        dx, div = cnf_fused.dynamics_packed(leaves[0], e, *leaves[1:])
        want = torch.autograd.grad(((dx * ct_dx).sum() + (div * ct_div).sum()), leaves)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=VJP_TOL, atol=VJP_TOL)
        return
    if oracle == "pallas_interpret":
        jf, jh, jl = jcnf_fused._pack_weights(c["jparams"])
        jgb = jcnf_fused._context_gb(c["jparams"], jnp.asarray(c["tc"]))
        with pltpu.force_tpu_interpret_mode():
            want = jcnf_fused._fused_bwd_call(jf, jh, jl, jgb, *(jnp.asarray(c[k]) for k in (
                "y", "e", "ct_dx", "ct_div")))
        want = [np.asarray(w) for w in want]
        want[2], want[4] = want[2][:, :3], want[4][:3]  # the TPU kernel pads D to 8
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=5e-4)
        return
    # jax.vjp of the XLA composition, on the raw parameter tree: the port's
    # packed gradients go back to it through the (differentiable) packing
    _, vjp = jax.vjp(lambda p, tc, yy: jcnf_fused._reference_dynamics(p, tc, yy, jnp.asarray(c["e"])),
                     c["jparams"], jnp.asarray(c["tc"]), jnp.asarray(c["y"]))
    want_p, want_tc, want_y = vjp((jnp.asarray(c["ct_dx"]), jnp.asarray(c["ct_div"])))
    leaves, rebuild = flatten_tree(c["params"])
    leaves = [t.clone().requires_grad_() for t in leaves]
    tc = _t(c["tc"]).requires_grad_()
    params = rebuild(leaves)
    packed = (cnf_fused.context_gb(params, tc), *cnf_fused.pack_weights(params))
    grads = torch.autograd.grad(packed, (*leaves, tc), grad_outputs=got[1:])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_y), rtol=VJP_TOL, atol=VJP_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_tc), rtol=VJP_TOL, atol=VJP_TOL)
    for g, w in zip(grads[:-1], _leaves(want_p), strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=VJP_TOL, atol=VJP_TOL)


def test_nfe_add_and_sum_or_the_markers():
    assert nfe_add(14.0, 20.0) == 34.0
    assert nfe_add(14.5, 20.5) == 34.5 and nfe_add(14.5, 20.0) == 34.5
    assert nfe_sum([2.5, 3.5, 4.0]) == 9.5 and nfe_sum([2.0, 3.0]) == 5.0


# -------------------------- MovingBatchNorm update -------------------------


def test_mbn_training_update_matches_jax():
    ccfg = CaSPRConfig(**TINY).cnf_config()
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 25, 3)) * [1.0, 2.0, 0.5] + [0.3, -1.0, 2.0]).astype(np.float32)
    lp = rng.standard_normal((4, 25, 1)).astype(np.float32)
    params = {"weight": rng.standard_normal(3).astype(np.float32) * 0.1,
              "bias": rng.standard_normal(3).astype(np.float32) * 0.1}
    state = {"running_mean": rng.standard_normal(3).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, 3).astype(np.float32),
             "step": np.array([3.0], np.float32)}
    want_y, want_lp, want_state = jcnf.mbn_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state),
        ccfg, jnp.asarray(x), jnp.asarray(lp), False, True)
    y, logp, new_state = cnf.mbn_forward(_to_torch(params), _to_torch(state), ccfg, _t(x), _t(lp),
                                         training=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-6)
    for k in ("running_mean", "running_var", "step"):
        np.testing.assert_allclose(new_state[k].numpy(), np.asarray(want_state[k]), rtol=0, atol=1e-6)
    # evaluation keeps the state object as it is
    st = _to_torch(state)
    assert cnf.mbn_forward(_to_torch(params), st, ccfg, _t(x), _t(lp))[2] is st


# --------------------- autograd of the encoder's kernels -------------------


@pytest.mark.parametrize("op", ["gather", "three_interpolate"])
def test_kernel_wrappers_differentiate_as_the_plain_versions(op):
    """The wrappers' backward is the same plain PyTorch on both devices; on
    the CPU it must give what autograd of the plain version gives, with
    indices out of range clamped."""
    g = torch.Generator().manual_seed(7)
    if op == "gather":
        pts = torch.randn((2, 30, 5), generator=g, requires_grad=True)
        idx = torch.randint(-3, 34, (2, 6, 4), generator=g, dtype=torch.int32)
        inputs, run = (pts,), lambda f: f(pts, idx)
        wrapper, plain = kernels.gather_points, pointops.gather_points
    else:
        feats = torch.randn((2, 12, 7), generator=g, requires_grad=True)
        idx = torch.randint(0, 12, (2, 20, 3), generator=g, dtype=torch.int32)
        w = torch.rand((2, 20, 3), generator=g, requires_grad=True)
        inputs, run = (feats, w), lambda f: f(feats, idx, w)
        wrapper, plain = kernels.three_interpolate, pointops.three_interpolate
    out = run(wrapper)
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * cot).sum(), inputs)
    want = torch.autograd.grad((run(plain) * cot).sum(), inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(float(a.abs().max()) > 0 for a in got)


# -------------------------------- caspr_init -------------------------------


def test_caspr_init_distributions():
    """Every leaf of the JAX package's tree, with its shape and the JAX
    init's distribution: uniform bounds and moments of the linear layers,
    N(0, 0.1) of the latent ODE, constants elsewhere."""
    cfg = CaSPRConfig()
    params, state = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=JaxConfig()), jax.random.PRNGKey(0))
    got = jax.tree_util.tree_leaves_with_path((params, state))
    want = jax.tree_util.tree_leaves_with_path(jshapes)
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert all(tuple(a.shape) == tuple(b.shape) for (_, a), (_, b) in zip(got, want))
    shapes, _ = caspr_param_shapes(cfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name, v = keys[-1], leaf.numpy().astype(np.float64)
        parent = functools.reduce(lambda t, k: t[k], keys[:-1], shapes)
        if keys[0] == "latent_ode":
            if name == "weight":
                assert abs(v.mean()) < 0.01 and abs(v.std() - 0.1) < 0.01
            else:
                assert not v.any()
        elif "weight" in parent and len(parent["weight"]) == 2:  # a linear layer
            bound = 1.0 / np.sqrt(parent["weight"][1])
            assert np.abs(v).max() <= bound
            if v.size >= 4096:  # U(-b, b): mean 0, std b / sqrt(3)
                assert abs(v.mean()) < 0.05 * bound and abs(v.std() / bound - 3 ** -0.5) < 0.02
        elif name == "sqrt_end_time":
            assert float(leaf) == np.float32(np.sqrt(0.5))
        else:  # GroupNorm 1 / 0, MovingBatchNorm 0
            assert np.all(v == (1.0 if name == "weight" and keys[0] == "encoder" else 0.0))
    for st in state["point_cnf"][::2]:
        assert not st["running_mean"].any() and torch.all(st["running_var"] == 1)
        assert not st["step"].any()


# ----------------------------------- Adam ----------------------------------


def test_adam_matches_optax():
    """The JAX package's chain (decayed weights, scale_by_adam, -lr) and
    torch.optim.Adam with weight decay, five steps on the same gradients."""
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(5)]
    tx = jloop.make_optimizer(1e-2, (0.8, 0.95), 1e-6, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tparams = _to_torch(params)
    opt = make_optimizer(1e-2, (0.8, 0.95), 1e-6, 1e-3).init(tparams)
    leaves = flatten_tree(tparams)[0]
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, gl in zip(leaves, flatten_tree(_to_torch(g))[0]):
            leaf.grad = gl
        opt.step()
    for got, want in zip(leaves, _leaves(jp), strict=True):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    count = checkpoint.adam_state(tparams, opt)["count"]
    assert int(count) == int(jstate[1].count) == 5


# -------------------------------- checkpoints ------------------------------


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    cfg = CaSPRConfig(**TINY)
    params, state = caspr_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    opt = make_optimizer(1e-3).init(params)
    for leaf in flatten_tree(params)[0]:
        leaf.grad = torch.ones_like(leaf)
    opt.step()
    path = os.path.join(tmp_path, "port.pkl")
    checkpoint.save_checkpoint(path, params, state, opt, epoch=3, extra={"note": "port"})
    ck = jcheckpoint.load_checkpoint(path)
    assert ck["epoch"] == 3 and ck["extra"] == {"note": "port"}
    jshapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=JaxConfig(**TINY)),
                             jax.random.PRNGKey(0))
    target = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jshapes[0])
    merged = jcheckpoint.load_weights(target, ck["params"])
    # both sides in JAX's leaf order (dict keys sorted)
    got, want = jax.tree_util.tree_leaves(merged), jax.tree_util.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    assert int(ck["opt_state"]["count"]) == 1
    for a, b in zip(jax.tree_util.tree_leaves(ck["opt_state"]["mu"]), want, strict=True):
        np.testing.assert_array_equal(a, opt.state[b]["exp_avg"].numpy())
    back = checkpoint.load_checkpoint(path)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ck), strict=True):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_with_optax_state_loads_without_jax(tmp_path):
    """A checkpoint the JAX package wrote with its optax state, read by the
    port in a process where importing jax or optax fails."""
    shapes = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.ones(2, np.float32)]}
    jp = jax.tree_util.tree_map(jnp.asarray, shapes)
    tx = jloop.make_optimizer(1e-3, weight_decay=1e-4)
    opt_state = tx.init(jp)
    updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.ones_like, jp), opt_state, jp)
    path = os.path.join(tmp_path, "jax.pkl")
    jcheckpoint.save_checkpoint(path, jp, {"s": jnp.zeros(1)}, opt_state, epoch=2)
    code = (
        "import sys; sys.modules['jax'] = sys.modules['optax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np\n"
        "from caspr_tpu_torch.train.checkpoint import load_checkpoint\n"
        f"ck = load_checkpoint({path!r})\n"
        "o = ck['opt_state']\n"
        "print(int(o['count']), float(o['mu']['w'].sum()), float(o['nu']['b'][0].sum()), ck['epoch'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'optax') for m in sys.modules if sys.modules[m])\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    adam = opt_state[1]
    assert res.stdout.split() == [
        "1", str(float(np.asarray(adam.mu["w"]).sum())), str(float(np.asarray(adam.nu["b"][0]).sum())), "2"]


def test_checkpoint_loader_refuses_other_classes(tmp_path):
    path = os.path.join(tmp_path, "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "hook": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        checkpoint.load_checkpoint(path)
