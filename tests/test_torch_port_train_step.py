"""The port's train step and epoch runner against the JAX package's on the
CPU, at the TINY configuration of tests/test_torch_port_model.py.

One batch goes through the JAX package's jitted train step, driven by its
own ``run_one_epoch(mode="train")``, and through the port's, with the same
weights (numpy, from a seed), the same update and the same Hutchinson noise:
the JAX step draws it as ``jax.random.normal(jax.random.split(key,
1)[0], (B*T, N, 3))`` (caspr_tpu/models/cnf.py:382, 514), and the port gets
that array through ``e=``.  The JAX package treats the noise as a constant
of the adjoint, as the port does, by the wrapper of
tests/test_torch_port_train.py (its CPU route would otherwise differentiate
jax.jvp in e at these widths).

Tolerances:
  - NFE, forward and forward + adjoint per solver: equal;
  - losses: 1e-5 relative (float32 sums over the batch, the forward
    states agreeing to 1e-4 absolute as in tests/test_torch_port_flow.py);
  - updated parameters: the update is plain gradient descent with rate 1
    on both sides (optax.sgd(1.0), torch.optim.SGD(lr=1)), so the updated
    parameters are params - grads and hold the gradients themselves: each
    leaf of the flow and the latent ODE within 1e-4 of its largest
    gradient; each leaf of the encoder within 1e-3 of its largest gradient
    plus 1e-4 of the encoder's largest; plus 1e-6 of the leaf's largest
    weight for the float32 rounding of the subtraction.  (Adam's first step
    moves a weight by lr * g / (|g| + eps), about +-lr whatever the size
    of g, and flips it where g is within rounding of 0; test_adam_matches_
    optax in tests/test_torch_port_train.py holds the port's Adam.)  The
    encoder's float32 gradients are within 7e-5 of the float64 ones at these
    radii (see TRAIN) on the T-NOCS loss alone; with the CNF's loss, whose
    gradient reaches the encoder through the latent code, some small leaves
    land up to 1.1e-3 of their largest, or 4e-5 of the encoder's largest,
    from the JAX package's (a conv bias ahead of a GroupNorm of one channel
    per group has a gradient of 0 in exact arithmetic, and float32 noise);
    in float64 the two agree to 1e-9
    (tests/test_torch_port_train.py::test_encoder_gradients_in_float64_match_jax).
    The flow's are within 1e-4 as in tests/test_torch_port_train.py;
  - MovingBatchNorm state: 1e-4 relative (the second one's statistics are
    of the flow's output, which agrees to 1e-4);
  - the epoch runner: the same log lines, numbers aside, and the same
    tracker values.
"""

import functools
import os
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init as jax_caspr_init
from caspr_tpu.train import loop as jloop
from caspr_tpu.train.trackers import TrainLossTracker as JaxTracker
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.train import TrainLossTracker, make_train_step, run_one_epoch
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_model import CLOUD_SIZE, TINY, _numpy_weights
from test_torch_port_adjoint import _stop_gradient_noise
from test_torch_port_train import _leaves

# TINY with wider SA balls: at TINY's radii most balls of the first levels
# hold a single point, repeated; GroupNorm then normalises a group of
# identical rows to a rounding residue, and the ReLU after it passes or
# stops each residue by its sign, so the encoder's float32 gradient is
# chaotic there (the port and the JAX package agree to 1e-12 in float64 and
# each lands up to 10% of a leaf's largest gradient from that in float32).
# With these radii every ball holds distinct points and the port's float32
# gradient is within 1e-4 of the float64 one.
TRAIN = dict(TINY, radii_list=(0.08, 0.12, 0.18, 0.25, 0.4, 0.8))
B, T, N = 2, 3, 48
CNF_W, TNOCS_W = 0.01, 100.0
GRAD_TOL = {"encoder": (1e-3, 1e-4), "latent_ode": (1e-4, 0.0), "point_cnf": (1e-4, 0.0)}


class _Loader:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return iter([self.batch])

    def __len__(self):
        return 1


def _run_both(cfg_kwargs, seed, accum_steps, tmp_path):
    """One batch through the JAX and the port's epoch runners; returns
    both sides' metrics, parameters, state, trackers and log paths."""
    jcfg = JaxConfig(**cfg_kwargs)
    shapes = jax.eval_shape(functools.partial(jax_caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    target = rng.random((B, T, N, 4), dtype=np.float32)
    target[..., 3] = np.sort(rng.random((B, T), dtype=np.float32), axis=1)[:, :, None]
    batch = {"input": x, "target": target}
    key = jax.random.PRNGKey(seed)

    jmodel = JaxModel(jcfg)
    tx = optax.sgd(1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    with pytest.MonkeyPatch.context() as mp:
        _stop_gradient_noise(mp)
        jstep = jloop.make_train_step(jmodel, tx, CNF_W, TNOCS_W, accum_steps=accum_steps)
        jmetrics = []

        def jstep_fixed_key(p, o, s, xx, tt, _key):
            out = jstep(p, o, s, xx, tt, key)
            jmetrics.append(jax.tree_util.tree_map(np.asarray, out[3]))
            return out

        jtracker = JaxTracker()
        jlog = os.path.join(tmp_path, "jax.txt")
        new_jparams, _, new_jstate, _ = jloop.run_one_epoch(
            jstep_fixed_key, jparams, tx.init(jparams),
            jax.tree_util.tree_map(jnp.asarray, state_np), _Loader(batch), jax.random.PRNGKey(0),
            0, jtracker, jlog, mode="train", print_stats_every=1)

    # the noise each microbatch's forward drew, in batch order
    keys = [key] if accum_steps == 1 else list(jax.random.split(key, accum_steps))
    rows = B * T // accum_steps
    e = np.concatenate([np.asarray(jax.random.normal(jax.random.split(k, 1)[0], (rows, N, 3)))
                        for k in keys])
    cfg = CaSPRConfig(**cfg_kwargs)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    model = CaSPRModel(cfg, device="cpu")
    step = make_train_step(model, None, CNF_W, TNOCS_W, accum_steps=accum_steps)
    metrics = []

    def step_fixed_noise(p, o, s, xx, tt, _generator):
        out = step(p, o, s, xx, tt, e=torch.from_numpy(e))
        metrics.append(out[3])
        return out

    tracker = TrainLossTracker()
    log = os.path.join(tmp_path, "port.txt")
    sgd = torch.optim.SGD(jax.tree_util.tree_leaves(params), lr=1.0)
    params, _, state = run_one_epoch(step_fixed_noise, params, sgd, state,
                                     _Loader(batch), None, 0, tracker, log, mode="train",
                                     print_stats_every=1)
    return dict(jmetrics=jmetrics[0], metrics=metrics[0], old=_leaves(params_np),
                jparams=new_jparams, params=params,
                jstate=new_jstate, state=state, jtracker=jtracker, tracker=tracker, jlog=jlog,
                log=log)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    return _run_both(TRAIN, 11, 1, tmp_path_factory.mktemp("full"))


@pytest.fixture(scope="module")
def accum(tmp_path_factory):
    return _run_both(dict(TRAIN, pretrain_tnocs=True), 12, 2, tmp_path_factory.mktemp("accum"))


def _check_metrics(run):
    got, want = run["metrics"], run["jmetrics"]
    assert got["nfe"] == tuple(float(v) for v in want["nfe"])
    assert got["nfe_forward"] == tuple(float(v) for v in want["nfe_forward"])
    for k in ("loss", "cnf_loss", "tnocs_loss", "mean_nll", "tnocs_pos_err", "tnocs_time_err"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def _check_params(run):
    """params - grads on both sides, per leaf of module m: within
    GRAD_TOL[m] = (rel, floor) as rel * the leaf's largest JAX gradient +
    floor * the module's largest + 1e-6 * the leaf's largest weight."""
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(run["jparams"])]
    modules = [p.split("'")[1] for p in paths]
    want = _leaves(run["jparams"])
    got = [t.detach().numpy() for t in jax.tree_util.tree_leaves(run["params"])]
    assert len(got) == len(want) == len(run["old"])
    grads = [float(np.abs(old - w).max()) for w, old in zip(want, run["old"])]
    largest = {m: max(g for g, mm in zip(grads, modules) if mm == m) for m in set(modules)}
    for path, m, g, w, old, grad in zip(paths, modules, got, want, run["old"], grads):
        rel, floor = GRAD_TOL[m]
        tol = rel * grad + floor * largest[m] + 1e-6 * np.abs(old).max()
        assert float(np.abs(g - w).max()) <= tol, (path, float(np.abs(g - w).max()), tol, grad)
    assert sum(g > 0 for g in grads) >= 0.9 * len(grads)  # nearly every leaf has a gradient


@pytest.mark.parametrize("what", ["metrics", "params", "state", "epoch_log"])
def test_train_step_matches_jax(full, what):
    if what == "metrics":
        _check_metrics(full)
        assert full["metrics"]["nfe"][0] > full["metrics"]["nfe_forward"][0]  # adjoint counted
    elif what == "params":
        _check_params(full)
    elif what == "state":
        for got, want in zip(jax.tree_util.tree_leaves(full["state"]), _leaves(full["jstate"]),
                             strict=True):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)
        assert float(full["state"]["point_cnf"][0]["step"][0]) == 1.0
    else:
        shape_of = lambda path: re.sub(r"-?\d+\.\d+", "#", open(path).read())
        assert shape_of(full["log"]) == shape_of(full["jlog"])
        assert "TRAIN Mean NFE (latent-ode, decoder)" in shape_of(full["log"])
        for k in ("train_losses", "cnf_losses", "tnocs_losses", "train_steps"):
            np.testing.assert_allclose(getattr(full["tracker"], k),
                                       np.asarray(getattr(full["jtracker"], k), np.float64),
                                       rtol=1e-5)


@pytest.mark.parametrize("what", ["metrics", "params"])
def test_accumulated_train_step_matches_jax(accum, what):
    """accum_steps=2 on the T-NOCS pretraining config (the encoder alone):
    microbatch gradients averaged, one update."""
    if what == "metrics":
        assert accum["metrics"]["nfe"] == (0.0, 0.0)
        _check_metrics(dict(accum, jmetrics={**accum["jmetrics"], "mean_nll": 0.0}))
    else:
        _check_params(accum)
