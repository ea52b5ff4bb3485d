"""The port's likelihood direction against the JAX package on the CPU: the
with-divergence dynamics, dopri5 on a tuple state, the forward flow,
``CaSPRModel.forward``, and the evaluation step with the epoch runner.

Inputs, weights and the Hutchinson noise are numpy arrays made from a seed
and handed to both sides.  The JAX side draws its noise as
``jax.random.normal(jax.random.split(key, n_cnf)[0], x.shape)``
(caspr_tpu/models/cnf.py:382, 514); the tests compute that array and give
it to the port through ``e=``.

Tolerances:
  - dynamics (dx and e^T J e) at H = 128: 1e-5 abs, float32 sums of 128
    terms in another order, against the Pallas kernel in interpret mode as
    well as against the XLA composition;
  - dopri5 on two leaves: equal NFE, values 1e-5 abs;
  - forward flow and model: equal NFE (the solvers take the same steps);
    nll 1e-4 abs, T-NOCS loss 1e-5 abs; the tracker's means to the same
    bars.  The CNF weights are scaled as in tests/test_torch_port_model.py,
    so that the solver's error estimate is truncation error, not rounding.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu.ops.odeint import odeint as jax_odeint
from caspr_tpu.train import loop as jloop
from caspr_tpu.train.trackers import TestStatTracker as JaxTracker
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.ops import cnf_fused, kernels, odeint
from caspr_tpu_torch.train import TestStatTracker, compute_losses, make_eval_step, run_one_epoch
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_model import CLOUD_SIZE, TINY, _numpy_weights

B, T, N = 2, 3, 48
NLL_TOL, TNOCS_TOL = 1e-4, 1e-5
CNF_W, TNOCS_W = 0.01, 100.0  # the loss weights of the training recipe


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return _t(np.asarray(tree, np.float32))


# ------------------------------ dynamics ----------------------------------


@pytest.fixture(scope="module")
def dyn():
    """A 3 -> 128 -> 128 -> 128 -> 3 ODEnet with a ragged cloud (N = 200 is
    not a multiple of the TPU kernel's 128 lanes nor of the CUDA tiles)."""
    cfg = jcnf.CNFConfig(input_dim=3, dims=(128, 128, 128), zdim=16)
    k = jax.random.split(jax.random.PRNGKey(1), 2)
    jparams = jcnf.odenet_init(k[0], cfg)
    rng = np.random.default_rng(1)
    tc = (0.5 * rng.standard_normal((3, 17))).astype(np.float32)
    y = rng.standard_normal((3, 200, 3)).astype(np.float32)
    e = rng.standard_normal((3, 200, 3)).astype(np.float32)
    return dict(jparams=jparams, params=_to_torch(jax.tree_util.tree_map(np.asarray, jparams)),
                tc=tc, y=y, e=e)


@pytest.mark.parametrize("jax_route", ["pallas_interpret", "reference"])
@pytest.mark.parametrize("port_route", ["packed", "reference", "wrapper"])
def test_dynamics_match_jax(dyn, jax_route, port_route):
    args = [jnp.asarray(dyn[k]) for k in ("tc", "y", "e")]
    if jax_route == "reference":
        want_dx, want_div = jcnf_fused._reference_dynamics(dyn["jparams"], *args)
    else:
        with pltpu.force_tpu_interpret_mode():
            want_dx, want_div = jcnf_fused.fused_concatsquash_dynamics(dyn["jparams"], *args)
    tc, y, e = (_t(dyn[k]) for k in ("tc", "y", "e"))
    if port_route == "reference":
        dx, div = cnf_fused.reference_dynamics(dyn["params"], tc, y, e)
    elif port_route == "packed":
        dx, div = cnf_fused.dynamics_packed(
            y, e, cnf_fused.context_gb(dyn["params"], tc), *cnf_fused.pack_weights(dyn["params"]))
    else:  # the model's entry: the dispatching wrapper, plain on the CPU
        kernels.reset_launches()
        dx, div = cnf.fused_concatsquash_dynamics(dyn["params"], tc, y, e)
        assert kernels.launches["cnf_dynamics"] == 0
    assert dx.shape == (3, 200, 3) and div.shape == (3, 200)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(div.numpy(), np.asarray(want_div), rtol=0, atol=1e-5)


def test_dynamics_divergence_is_the_jacobian_form(dyn):
    """e^T J e against autograd's Jacobian-vector product of the primal."""
    tc, y, e = (_t(dyn[k]) for k in ("tc", "y", "e"))
    f = lambda v: cnf_fused.reference_primal(dyn["params"], tc, v)
    dx, jvp = torch.autograd.functional.jvp(f, y, e)
    got_dx, got_div = cnf_fused.reference_dynamics(dyn["params"], tc, y, e)
    np.testing.assert_allclose(got_dx.numpy(), dx.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_div.numpy(), (jvp * e).sum(-1).numpy(), rtol=0, atol=1e-5)


# ------------------------- dopri5 on a tuple state -------------------------


def test_odeint_tuple_state_matches_jax():
    """Two leaves of different size and scale: a (4, 30) leaf that is easy
    to integrate and a (4,) leaf that is hard, so the per-leaf error norm
    (max over leaves of each leaf's RMS) and one RMS over all elements give
    different step sequences."""
    rng = np.random.default_rng(2)
    a0 = rng.standard_normal((4, 30)).astype(np.float32)
    b0 = (5.0 + rng.random(4)).astype(np.float32)
    w = (0.3 * rng.standard_normal((30, 30))).astype(np.float32)
    ts = np.array([0.0, 0.4, 1.0], np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)

    def jfunc(t, y, args):
        a, b = y
        return (jnp.tanh(a @ jnp.asarray(w)) * 0.1, -b * b * jnp.cos(8.0 * t))

    (ja, jb), jnfe = jax.jit(
        lambda y0: jax_odeint(jfunc, y0, jnp.asarray(ts), None, **tol)
    )((jnp.asarray(a0), jnp.asarray(b0)))

    def func(t, y):
        a, b = y
        return (torch.tanh(a @ _t(w)) * 0.1, -b * b * float(np.cos(np.float32(8.0) * t)))

    (ta, tb), nfe = odeint(func, (_t(a0), _t(b0)), ts, **tol)
    assert nfe == float(jnfe)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)

    # one RMS over the concatenation is another solver: fewer steps here
    def flat(t, y):
        da, db = func(t, (y[:, :30], y[:, 30]))
        return torch.cat([da, db[:, None]], dim=1)

    _, nfe_flat = odeint(flat, torch.cat([_t(a0), _t(b0)[:, None]], dim=1), ts, **tol)
    assert nfe_flat != nfe


def test_odeint_single_tensor_and_one_leaf_tuple_agree():
    y0 = _t(np.linspace(0.5, 1.5, 6, dtype=np.float32))
    ts = np.array([0.0, 1.0], np.float32)
    ys, nfe = odeint(lambda t, y: -y * y, y0, ts, rtol=1e-6, atol=1e-6)
    (yt,), nfe_t = odeint(lambda t, y: (-y[0] * y[0],), (y0,), ts, rtol=1e-6, atol=1e-6)
    assert nfe == nfe_t and torch.equal(ys, yt)
    np.testing.assert_allclose(ys[1].numpy(), (y0 / (1 + y0)).numpy(), rtol=0, atol=1e-5)


# ----------------------- forward flow, model, eval step --------------------


@pytest.fixture(scope="module")
def ref():
    """TINY weights and one batch, through the jitted JAX forward and the
    jitted JAX eval step, with the noise the JAX side drew."""
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    target = rng.random((B, T, N, 4), dtype=np.float32)
    # times differ between the rows: the general latent solve
    target[..., 3] = np.sort(rng.random((B, T), dtype=np.float32), axis=1)[:, :, None]
    key = jax.random.PRNGKey(7)
    e = np.asarray(jax.random.normal(jax.random.split(key, 1)[0], (B * T, N, 3), jnp.float32))
    jmodel = JaxModel(jcfg)
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    jparams, jstate = as_j(params_np), as_j(state_np)

    @jax.jit
    def fwd(params, state, x, target, key):
        out, _ = jmodel.forward(params, state, x, target, key, training=False)
        z0, _ = jmodel.encode(params, x)
        feats, _ = jmodel.aggregate_and_solve_latent(params, z0, target[:, :, 0, 3], adjoint=False)
        return out, feats

    out, feats = fwd(jparams, jstate, jnp.asarray(x), jnp.asarray(target), key)
    jstep = jloop.make_eval_step(jmodel, CNF_W, TNOCS_W)
    cfg = CaSPRConfig(**TINY)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    return dict(out=jax.tree_util.tree_map(np.asarray, out), feats=np.asarray(feats),
                jstep=jstep, jparams=jparams, jstate=jstate, key=key, e=e, x=x, target=target,
                cfg=cfg, params=params, state=state, model=CaSPRModel(cfg, device="cpu"))


def test_flow_forward_matches(ref):
    """The chain alone, on the JAX run's latent features."""
    ccfg = ref["cfg"].cnf_config()
    jccfg = JaxConfig(**TINY).cnf_config()
    pts = ref["target"][..., :3].reshape(B * T, N, 3)
    ctx = ref["feats"].reshape(B * T, -1)
    logp0 = np.zeros((B * T, N, 1), np.float32)
    want_y, want_dlogp, _, want_nfe = jax.jit(
        lambda p, s, x, c, l, k: jcnf.flow_apply(p, s, jccfg, x, c, l, k, reverse=False,
                                                 training=False)
    )(ref["jparams"]["point_cnf"], ref["jstate"]["point_cnf"], jnp.asarray(pts),
      jnp.asarray(ctx), jnp.asarray(logp0), ref["key"])
    y, dlogp, state, nfe = cnf.flow_forward(ref["params"]["point_cnf"], ref["state"]["point_cnf"],
                                            ccfg, _t(pts), _t(ctx), _t(logp0), e=_t(ref["e"]))
    assert nfe == float(want_nfe)
    assert all(a is b for a, b in zip(state, ref["state"]["point_cnf"]))  # no update
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=NLL_TOL)
    np.testing.assert_allclose(dlogp.numpy(), np.asarray(want_dlogp), rtol=0, atol=NLL_TOL)


def test_mbn_forward_inverts_reverse(ref):
    ccfg = ref["cfg"].cnf_config()
    p, s = ref["params"]["point_cnf"][0], ref["state"]["point_cnf"][0]
    x = _t(np.random.default_rng(4).standard_normal((5, 7, 3)).astype(np.float32))
    y, logp, _ = cnf.mbn_forward(p, s, ccfg, x, torch.zeros(5, 7, 1))
    np.testing.assert_allclose(cnf.mbn_reverse(p, s, ccfg, y).numpy(), x.numpy(), atol=1e-6)
    logdet = (p["weight"] - 0.5 * torch.log(s["running_var"] + ccfg.bn_eps)).sum()
    np.testing.assert_allclose(logp.numpy(), -float(logdet), rtol=1e-6)


def test_model_forward_matches(ref):
    out, state = ref["model"].forward(ref["params"], ref["state"], _t(ref["x"]),
                                      _t(ref["target"]), e=_t(ref["e"]))
    want = ref["out"]
    assert out["nfe"] == (float(want["nfe"][0]), float(want["nfe"][1]))
    assert out["nll"].shape == (B, T, N) and out["tnocs_loss"].shape == (B, T, N, 4)
    np.testing.assert_allclose(out["nll"].numpy(), want["nll"], rtol=0, atol=NLL_TOL)
    np.testing.assert_allclose(out["tnocs_loss"].numpy(), want["tnocs_loss"], rtol=0,
                               atol=TNOCS_TOL)
    assert state is ref["state"]  # evaluation leaves the running statistics alone


def test_model_forward_draws_noise_from_the_generator(ref):
    run = lambda seed: ref["model"].forward(
        ref["params"], ref["state"], _t(ref["x"]), _t(ref["target"]),
        torch.Generator().manual_seed(seed))[0]["nll"]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


def test_model_forward_pretrain_and_training_branches(ref):
    cfg = CaSPRConfig(**TINY, pretrain_tnocs=True)
    model = CaSPRModel(cfg, device="cpu")
    out, _ = model.forward({"encoder": ref["params"]["encoder"]}, {}, _t(ref["x"]),
                           _t(ref["target"]))
    assert "nll" not in out and out["nfe"] == (0.0, 0.0)
    np.testing.assert_allclose(out["tnocs_loss"].numpy(), ref["out"]["tnocs_loss"], rtol=0,
                               atol=TNOCS_TOL)
    loss, cnf_loss, tnocs_loss = compute_losses(out, CNF_W, TNOCS_W)
    assert float(cnf_loss) == 0.0 and float(loss) == float(tnocs_loss) > 0.0
    # training: the same losses, differentiable, and a new MovingBatchNorm state
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), ref["params"])
    out, state = ref["model"].forward(params, ref["state"], _t(ref["x"]), _t(ref["target"]),
                                      training=True, e=_t(ref["e"]))
    np.testing.assert_allclose(out["nll"].detach().numpy(), ref["out"]["nll"], rtol=0, atol=NLL_TOL)
    assert out["nll"].requires_grad and state is not ref["state"]
    assert float(state["point_cnf"][0]["step"][0]) == float(ref["state"]["point_cnf"][0]["step"][0]) + 1


def test_eval_step_and_epoch_match_with_padding(ref, tmp_path):
    """One padded batch (2 rows, 1 real): per-item losses and nll against
    the JAX step, and the tracker's five means against the JAX epoch
    runner's, the padded row masked out of each."""
    want = jax.tree_util.tree_map(np.asarray, ref["jstep"](
        ref["jparams"], ref["jstate"], jnp.asarray(ref["x"]), jnp.asarray(ref["target"]),
        ref["key"]))
    step = make_eval_step(ref["model"], CNF_W, TNOCS_W)
    got = step(ref["params"], ref["state"], ref["x"], ref["target"], e=_t(ref["e"]))
    assert got["nfe"] == (float(want["nfe"][0]), float(want["nfe"][1]))
    # loss_per_item = 0.01 * mean_T(sum_N nll) + 100 * mean(tnocs): N * NLL_TOL
    # of slack on the first term, in units of the weight
    item_tol = CNF_W * N * NLL_TOL + TNOCS_W * TNOCS_TOL
    np.testing.assert_allclose(got["loss_per_item"].numpy(), want["loss_per_item"], rtol=0,
                               atol=item_tol)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=0, atol=item_tol)
    np.testing.assert_allclose(float(got["loss_per_item"].mean()), float(got["loss"]), rtol=1e-6)
    np.testing.assert_allclose(got["nll"].numpy(), want["nll"], rtol=0, atol=NLL_TOL)
    for k in ("tnocs_pos_err", "tnocs_time_err"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=2 * TNOCS_TOL)

    batch = {"input": ref["x"], "target": ref["target"], "model_id": ["m0", "m1"],
             "seq_id": ["s0", "s1"], "valid": 1}

    class _Loader:
        def __iter__(self):
            return iter([batch])

        def __len__(self):
            return 1

    # the JAX runner splits its key once per batch before the step
    jtracker = JaxTracker()
    jstep_fixed_key = lambda p, s, x, t, _k: ref["jstep"](p, s, x, t, ref["key"])
    jloop.run_one_epoch(jstep_fixed_key, ref["jparams"], None, ref["jstate"], _Loader(),
                        jax.random.PRNGKey(0), 0, jtracker, os.path.join(tmp_path, "jax.txt"),
                        mode="test", print_stats_every=1)
    tracker = TestStatTracker()
    step_fixed_noise = lambda p, s, x, t, g: step(p, s, x, t, g, e=_t(ref["e"]))
    log_out = os.path.join(tmp_path, "port.txt")
    run_one_epoch(step_fixed_noise, ref["params"], None, ref["state"], _Loader(), None, 0,
                  tracker, log_out, mode="test", print_stats_every=1)
    got_means, want_means = tracker.get_mean_stats(), jtracker.get_mean_stats()
    for g, w, tol in zip(got_means, want_means,
                         (item_tol, NLL_TOL, 2 * TNOCS_TOL, 2 * TNOCS_TOL, 0.0)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    # only the real row counted
    assert tracker.cnf_err_count == T * N and tracker.total_loss_count == 1
    np.testing.assert_allclose(got_means[0], float(got["loss_per_item"][0]), rtol=1e-6)
    # the same log lines, numbers aside
    shape_of = lambda path: re.sub(r"-?\d+\.\d+", "#", open(path).read())
    assert shape_of(log_out) == shape_of(os.path.join(tmp_path, "jax.txt"))
    assert "TEST Mean CNF NLL" in shape_of(log_out)
