"""The CNF composition path: configs the fused kernels do not take, against
the JAX package on the CPU.

``ops.cnf_fused.kernel_takes`` reads from the config whether the ODEnet runs
in the fused kernels (equal hidden widths, a multiple of 32 up to 512, 1-6
hidden-to-hidden layers); any other config runs the unfused composition on
either device, as the JAX package runs ``odenet_apply`` where ``can_fuse``
is false.  Two such configs at the TINY widths of
tests/test_torch_port_model.py: ``cnf_dims=(16, 32)`` (unequal widths, 16 no
multiple of 32) and ``(32,)`` (no hidden-to-hidden layer).  The SA radii are
those of tests/test_torch_port_train_step.py's TRAIN, where every ball holds
distinct points: at TINY's radii a ball of copies of one point makes the
encoder's float32 output follow the order of its sums, and on these draws
z0 then lands further from the JAX package's than the 1e-4 bar, which
would hide the CNF's agreement.

Tolerances:
  - NFE: equal (the solvers take the same steps);
  - decoded points and nll: 1e-4 abs, as in tests/test_torch_port_model.py
    and tests/test_torch_port_flow.py (the composition's float32 sums in
    another order than XLA's);
  - the adjoint train step: the bars of tests/test_torch_port_train_step.py
    for the metrics and for every leaf of the flow and the latent ODE.  The
    encoder's float32 gradient is ill-conditioned leaf by leaf on this input
    whatever computes it (the port's own float32 gradient lies far from its
    float64 one here, as ``_encoder_float32_floor`` measures), so the
    encoder's whole gradient is held in relative L2 to 4x that distance, as
    chip_smoke.py's phase 7 holds it on the card.

With one hidden layer the flow's field is close to linear at the weights'
gain of tests/test_torch_port_model.py, dopri5's error estimate sits at
float32 rounding, and the likelihood solve's step sequence follows the order
of the sums (on these draws the JAX package's own jitted and eager forwards
at ``(32,)`` take different numbers of CNF evaluations).  That config's CNF
layers get 1.5x more gain, where the error estimate is truncation error.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.models.caspr import caspr_init as torch_caspr_init
from caspr_tpu_torch.ops.cnf_fused import kernel_takes
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_model import CLOUD_SIZE, TINY, _numpy_weights
from chip_smoke import encoder_float32_floor
from test_torch_port_train import _leaves
from test_torch_port_train_step import GRAD_TOL, TRAIN, _check_metrics, _run_both

B, T, N, NUM_POINTS = 2, 3, 48, 32
POINT_TOL = NLL_TOL = 1e-4
COMPOSED = [(16, 32), (32,)]
EXTRA_GAIN = {(32,): 1.5}  # on the CNF layers' weights: see the module's note


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=COMPOSED, ids=lambda d: "x".join(map(str, d)))
def ref(request):
    """One batch through the JAX package's jitted reconstruct and forward at
    TINY with these CNF widths, and the port's model with the same weights."""
    kw = dict(TRAIN, cnf_dims=request.param)
    jcfg = JaxConfig(**kw)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    for layer in params_np["point_cnf"][1]["odenet"]["layers"]:
        layer["_layer"]["weight"] *= np.float32(EXTRA_GAIN.get(request.param, 1.0))
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    timestamps = np.linspace(0.0, 1.0, T, dtype=np.float32)
    target = rng.random((B, T, N, 4), dtype=np.float32)
    target[..., 3] = np.sort(rng.random((B, T), dtype=np.float32), axis=1)[:, :, None]
    key = jax.random.PRNGKey(9)
    e = np.asarray(jax.random.normal(jax.random.split(key, 1)[0], (B * T, N, 3), jnp.float32))
    jmodel = JaxModel(jcfg)

    @jax.jit
    def run(params, state, x, timestamps, target, key):
        z0, _ = jmodel.encode(params, x)
        z, ode_nfe = jmodel.aggregate_and_solve_latent(
            params, z0, jnp.broadcast_to(timestamps, (B, T)), adjoint=False, shared_times=True)
        y, _, rec, cnf_nfe = jmodel.decode(params, state, z, key, num_points=NUM_POINTS)
        fwd, _ = jmodel.forward(params, state, x, target, key, training=False)
        return dict(y=y, rec=rec, nfe=(ode_nfe, cnf_nfe), nll=fwd["nll"], fwd_nfe=fwd["nfe"])

    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    out = jax.tree_util.tree_map(np.asarray, run(
        as_j(params_np), as_j(state_np), jnp.asarray(x), jnp.asarray(timestamps),
        jnp.asarray(target), key))
    cfg = CaSPRConfig(**kw)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    return dict(out=out, cfg=cfg, params=params, state=state, x=x, timestamps=timestamps,
                target=target, e=e, model=CaSPRModel(cfg, device="cpu"))


@pytest.mark.parametrize("dims,fused", [
    ((512, 512, 512), True),   # CaSPRConfig()'s
    ((32, 32), True),          # TINY's
    ((96,) * 7, True),         # 6 hidden-to-hidden layers
    ((16, 32), False),         # unequal widths
    ((32,), False),            # no hidden-to-hidden layer
    ((48, 48), False),         # no multiple of 32
    ((640, 640), False),       # wider than 512
    ((64,) * 8, False),        # 7 hidden-to-hidden layers: past the VJP's range
])
def test_kernel_takes_reads_the_config(dims, fused):
    assert kernel_takes(CaSPRConfig(cnf_dims=dims).cnf_config()) is fused
    assert kernel_takes(CaSPRConfig().cnf_config())


@pytest.mark.parametrize("dims,route", [((32, 32), "fused"), ((16, 32), "composition"),
                                        ((32,), "composition")])
def test_dynamics_take_the_selected_route(dims, route, monkeypatch):
    """The model's dynamics go through the packed wrappers (the kernels on
    the card, their plain versions here) for a config the kernels take, and
    through the composition otherwise; never both."""
    calls = []
    for name in ("fused_concatsquash_primal", "fused_concatsquash_dynamics"):
        real = getattr(cnf, name)
        monkeypatch.setattr(cnf, name, lambda *a, real=real: calls.append("fused") or real(*a))
    for name in ("reference_primal", "reference_dynamics"):
        real = getattr(cnf, name)
        monkeypatch.setattr(cnf, name,
                            lambda *a, real=real: calls.append("composition") or real(*a))
    cfg = CaSPRConfig(**dict(TINY, cnf_dims=dims))
    params, _ = torch_caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    odenet, ccfg = params["point_cnf"][1]["odenet"], cfg.cnf_config()
    tc = torch.randn((2, 1 + ccfg.zdim), generator=torch.Generator().manual_seed(1))
    y = torch.randn((2, 5, 3))
    dx = cnf.odenet_primal(odenet, ccfg, tc, y)
    dx2, div = cnf.odenet_dynamics(odenet, ccfg, tc, y, torch.randn((2, 5, 3)))
    assert calls == [route, route]
    assert dx.shape == dx2.shape == (2, 5, 3) and div.shape == (2, 5)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=1e-6)


def test_reconstruct_matches_jax(ref):
    out = ref["out"]
    _, _, rec, _, nfe = ref["model"].reconstruct(
        ref["params"], ref["state"], _t(ref["x"]), None, num_points=NUM_POINTS,
        timestamps=_t(ref["timestamps"]), base_samples=_t(out["y"]))
    assert nfe == tuple(float(v) for v in out["nfe"])
    assert rec.shape == (B, T, NUM_POINTS, 3)
    np.testing.assert_allclose(rec.numpy(), out["rec"], rtol=0, atol=POINT_TOL)


def test_forward_matches_jax(ref):
    got, _ = ref["model"].forward(ref["params"], ref["state"], _t(ref["x"]), _t(ref["target"]),
                                  e=_t(ref["e"]))
    assert got["nfe"] == tuple(float(v) for v in ref["out"]["fwd_nfe"])
    assert got["nll"].shape == (B, T, N)
    np.testing.assert_allclose(got["nll"].numpy(), ref["out"]["nll"], rtol=0, atol=NLL_TOL)


TRAIN_SEED = 11  # test_torch_port_train_step.py's


@pytest.fixture(scope="module")
def composed_train(tmp_path_factory):
    return _run_both(dict(TRAIN, cnf_dims=(16, 32)), TRAIN_SEED, 1,
                     tmp_path_factory.mktemp("composed"))


def _encoder_float32_floor():
    """Relative L2 distance of the port's float32 gradient of the T-NOCS
    loss (the encoder alone) from its float64 one, on the train step's
    weights and input (drawn as ``_run_both`` draws them)."""
    cfg_kwargs = dict(TRAIN, cnf_dims=(16, 32))
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=JaxConfig(**cfg_kwargs)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(TRAIN_SEED)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    target = rng.random((B, T, N, 4), dtype=np.float32)
    cfg = CaSPRConfig(**cfg_kwargs)
    params, _ = params_from_jax(params_np, state_np, cfg, device="cpu")
    return encoder_float32_floor(torch, CaSPRModel(cfg, device="cpu"), params, x, target)


@pytest.mark.parametrize("what", ["metrics", "flow_and_latent", "encoder"])
def test_composed_train_step_matches_jax(composed_train, what):
    """One adjoint train step at cnf_dims=(16, 32): the composition's VJP is
    autograd through ``reference_dynamics``."""
    run = composed_train
    if what == "metrics":
        _check_metrics(run)
        assert run["metrics"]["nfe"][1] > run["metrics"]["nfe_forward"][1]
        return
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(run["jparams"])]
    modules = [p.split("'")[1] for p in paths]
    want = _leaves(run["jparams"])
    got = [t.detach().numpy() for t in jax.tree_util.tree_leaves(run["params"])]
    # sgd(1.0) on both sides: old - new is the gradient
    grads = [(old - w).astype(np.float64) for w, old in zip(want, run["old"])]
    port_grads = [(old - g).astype(np.float64) for g, old in zip(got, run["old"])]
    if what == "encoder":
        enc = [i for i, m in enumerate(modules) if m == "encoder"]
        flat = lambda gs: np.concatenate([gs[i].ravel() for i in enc])
        rel = np.linalg.norm(flat(port_grads) - flat(grads)) / np.linalg.norm(flat(grads))
        assert rel <= 4.0 * _encoder_float32_floor()
        return
    for path, m, g, w, old, grad in zip(paths, modules, got, want, run["old"], grads):
        if m == "encoder":
            continue
        rel, floor = GRAD_TOL[m]
        tol = rel * float(np.abs(grad).max()) + 1e-6 * np.abs(old).max()
        assert floor == 0.0 and float(np.abs(g - w).max()) <= tol, path
