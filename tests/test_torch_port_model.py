"""The port's reconstruct path against the JAX package on the CPU, at the
TINY configuration of tests/test_eval_padding.py.

One jitted JAX run (the reference fixture) produces every stage's output:
the encoder's z0 and T-NOCS, the latent solve (both the shared-times and
the general branch), one reverse CNF block solve, the decode and the
reconstruct.  Each port stage gets the JAX stage's inputs, so a
difference points at that stage; reconstruct then runs the port end to
end.  Weights are numpy arrays in the parameter tree of the JAX package's
caspr_init (its structure from jax.eval_shape), handed to both sides;
base samples are the JAX run's own.

Tolerances:
  - NFE: equal.  The solvers take the same steps; a difference means a
    different accept decision, not rounding;
  - encoder z0 and T-NOCS: 1e-4 abs.  z0 is O(1) after two GroupNorms of
    sums over up to 1600 channels, reordered between XLA and PyTorch;
  - latent ODE states: 1e-5 abs;
  - the CNF block's states: (accepted steps) x rtol x max(1, max|y|).  The
    first step's error estimate sits near float32 rounding, so the two
    step sequences differ in their last bits, and two dopri5 runs whose
    step points differ agree to the local error bound rtol * |y| per step,
    not to rounding;
  - decoded points: 1e-4 abs (the flow's states are O(1) there).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models import latent_ode as jlode
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init
from caspr_tpu_torch.models import cnf, latent_ode
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_param_shapes
from caspr_tpu_torch.weights import DEMO_CHECKPOINT, load_checkpoint, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    sa_points=(16, 8, 8, 4, 4),
    ball_samples=(4, 8),
    local_feat_size=64,
    latent_feat_size=160,
    ode_hidden_size=32,
    motion_feat_size=16,
    global_feat_size=128,
    cnf_dims=(32, 32),
)
B, T, N, NUM_POINTS = 2, 3, 48, 32
ENC_TOL, ODE_TOL, POINT_TOL = 1e-4, 1e-5, 1e-4
# The clouds fill a 0.15 cube, so that the SA balls (radii from 0.02) hold
# several distinct points.  A ball of copies of one point gives GroupNorm a
# group whose variance is a last-bit rounding residue; it divides that by
# sqrt(var + 1e-5), up to 316x, and XLA and PyTorch sum in different orders.
CLOUD_SIZE = 0.15
# The CNF layers' weights are scaled up so that the decoder's field is
# nonlinear enough for dopri5's error estimate to be truncation error.  On a
# near-linear field the estimate is float32 rounding noise, and the step
# sequence then follows the order of operations: the JAX package's own jit
# and eager runs of one such solve took 14 and 20 evaluations.
CNF_GAIN = 6.0


def _numpy_weights(shapes, rng, path=""):
    """Random numpy weights in the tree of ``shapes`` (jax.ShapeDtypeStructs)."""
    if isinstance(shapes, dict):
        return {k: _numpy_weights(v, rng, f"{path}/{k}") for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_numpy_weights(v, rng, f"{path}/{i}") for i, v in enumerate(shapes)]
    shape = tuple(shapes.shape)
    name = path.rsplit("/", 1)[-1]
    if name == "sqrt_end_time":
        return np.asarray(np.sqrt(0.5), np.float32)
    if name == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "step":
        return np.zeros(shape, np.float32)
    if len(shape) == 2:  # (out, in): torch's default uniform bound
        bound = 1.0 / np.sqrt(shape[1])
        if "/_layer/" in path:
            bound *= CNF_GAIN
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name == "weight" and "point_cnf" not in path:  # GroupNorm scale
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """Weights, inputs and every JAX stage output, from one jitted run."""
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    timestamps = np.linspace(0.0, 1.0, T, dtype=np.float32)
    times = np.sort(rng.random((B, T), dtype=np.float32), axis=1)  # rows differ
    y_block = rng.standard_normal((B * T, NUM_POINTS, 3)).astype(np.float32)
    model = JaxModel(jcfg)
    ccfg = jcfg.cnf_config()

    @jax.jit
    def run(params, state, x, timestamps, times, y_block, key):
        z0, tnocs = model.encode(params, x)
        z, ode_nfe = model.aggregate_and_solve_latent(
            params, z0, jnp.broadcast_to(timestamps, (B, T)), adjoint=False,
            shared_times=True)
        z_gen, ode_nfe_gen = model.aggregate_and_solve_latent(params, z0, times, adjoint=False)
        ctx = z.reshape(B * T, -1)
        block, _, block_nfe = jcnf.cnf_block_apply(
            params["point_cnf"][1], ccfg, y_block, ctx, None, key, reverse=True)
        y, _, rec, cnf_nfe = model.decode(params, state, z, key, num_points=NUM_POINTS)
        return dict(z0=z0, tnocs=tnocs, z=z, ode_nfe=ode_nfe, z_gen=z_gen,
                    ode_nfe_gen=ode_nfe_gen, block=block, block_nfe=block_nfe, y=y, rec=rec,
                    cnf_nfe=cnf_nfe)

    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    out = run(as_j(params_np), as_j(state_np), jnp.asarray(x), jnp.asarray(timestamps),
              jnp.asarray(times), jnp.asarray(y_block), jax.random.PRNGKey(1))
    out = {k: np.asarray(v) for k, v in out.items()}
    cfg = CaSPRConfig(**TINY)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    return dict(out=out, cfg=cfg, params=params, state=state, x=x, timestamps=timestamps,
                times=times, y_block=y_block, model=CaSPRModel(cfg, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def test_encode_matches(ref):
    z0, tnocs = ref["model"].encode(ref["params"], _t(ref["x"]))
    np.testing.assert_allclose(z0.numpy(), ref["out"]["z0"], rtol=0, atol=ENC_TOL)
    np.testing.assert_allclose(tnocs.numpy(), ref["out"]["tnocs"], rtol=0, atol=ENC_TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_latent_solve_matches(ref, shared):
    out = ref["out"]
    times = np.broadcast_to(ref["timestamps"], (B, T)) if shared else ref["times"]
    z, nfe = ref["model"].aggregate_and_solve_latent(
        ref["params"], _t(out["z0"]), _t(times), shared_times=shared)
    want, want_nfe = (out["z"], out["ode_nfe"]) if shared else (out["z_gen"], out["ode_nfe_gen"])
    assert nfe == float(want_nfe)
    np.testing.assert_allclose(z.numpy(), want, rtol=0, atol=ODE_TOL)


def test_latent_ode_solve_direct(ref):
    """The solver alone on the latent dynamics, against the JAX solver."""
    rng = np.random.default_rng(5)
    z0 = rng.standard_normal((B, TINY["motion_feat_size"])).astype(np.float32)
    t = np.array([0.0, 0.3, 0.3, 1.0], np.float32)
    lcfg = ref["cfg"].latent_ode_config()
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), ref["params"]["latent_ode"])
    want, want_nfe = jlode.latent_ode_solve(jparams, jlode.LatentODEConfig(
        input_size=lcfg.input_size, hidden_size=lcfg.hidden_size), jnp.asarray(z0),
        jnp.asarray(t), adjoint=False)
    got, nfe = latent_ode.latent_ode_solve(ref["params"]["latent_ode"], lcfg, _t(z0), _t(t))
    assert nfe == float(want_nfe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ODE_TOL)


def test_cnf_reverse_block_matches(ref):
    out = ref["out"]
    ctx = _t(out["z"].reshape(B * T, -1))
    got, nfe = cnf.cnf_block_apply(ref["params"]["point_cnf"][1], ref["cfg"].cnf_config(),
                                   _t(ref["y_block"]), ctx)
    assert nfe == float(out["block_nfe"])
    steps = (nfe - 2) / 6
    tol = steps * ref["cfg"].cnf_config().rtol * max(1.0, float(np.abs(out["block"]).max()))
    np.testing.assert_allclose(got.numpy(), out["block"], rtol=0, atol=tol)


def test_decode_from_samples_matches(ref):
    out = ref["out"]
    logp, rec, nfe = ref["model"].decode_from_samples(
        ref["params"], ref["state"], _t(out["z"]), _t(out["y"]))
    assert nfe == float(out["cnf_nfe"])
    np.testing.assert_allclose(rec.numpy(), out["rec"], rtol=0, atol=POINT_TOL)
    assert logp.shape == (B, T, NUM_POINTS)


def test_reconstruct_matches(ref):
    """The port end to end, with the JAX run's base samples injected."""
    out = ref["out"]
    y, _, rec, tnocs, (ode_nfe, cnf_nfe) = ref["model"].reconstruct(
        ref["params"], ref["state"], _t(ref["x"]), None, num_points=NUM_POINTS,
        timestamps=_t(ref["timestamps"]), base_samples=_t(out["y"]))
    assert (ode_nfe, cnf_nfe) == (float(out["ode_nfe"]), float(out["cnf_nfe"]))
    assert rec.shape == (B, T, NUM_POINTS, 3)
    np.testing.assert_allclose(rec.numpy(), out["rec"], rtol=0, atol=POINT_TOL)
    np.testing.assert_allclose(tnocs.numpy(), out["tnocs"], rtol=0, atol=ENC_TOL)


def test_reconstruct_samples_with_generator(ref):
    """Without injected samples the base points come from the generator:
    the same seed gives the same output; truncation and contours hold."""
    m = ref["model"]
    args = (ref["params"], ref["state"], _t(ref["x"]))
    run = lambda seed, **kw: m.reconstruct(*args, torch.Generator().manual_seed(seed),
                                           num_points=8, **kw)
    a, b = run(3), run(3)
    assert torch.equal(a[2], b[2]) and torch.isfinite(a[2]).all()
    y = run(4, truncate_std=0.5, constant_in_time=True)[0]
    assert float(y.abs().max()) <= 0.5 and torch.equal(y[:, 0], y[:, 1])
    y = run(5, sample_contours=(0.2, 0.4))[0]
    np.testing.assert_allclose(torch.linalg.vector_norm(y, dim=-1)[..., :4].numpy(), 0.2, rtol=1e-6)


def test_params_from_jax_demo_checkpoint():
    """Every leaf of the trained full-width checkpoint lands with its shape,
    and nothing is left over."""
    ck = load_checkpoint(DEMO_CHECKPOINT)
    params, state = params_from_jax(ck["params"], ck["state"], CaSPRConfig(), device="cpu")
    flat = lambda tree: jax.tree_util.tree_leaves(tree)
    src = flat(ck["params"]) + flat(ck["state"])
    dst = flat(params) + flat(state)
    assert len(src) == len(dst) == 227
    is_shape = lambda s: isinstance(s, tuple) and all(isinstance(d, int) for d in s)
    assert len(jax.tree_util.tree_leaves(caspr_param_shapes(CaSPRConfig()), is_leaf=is_shape)) == 227
    for s, d in zip(src, dst):
        assert tuple(d.shape) == np.shape(s) and d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(), s)


def test_params_from_jax_rejects_a_misfit():
    ck = load_checkpoint(DEMO_CHECKPOINT)
    params = dict(ck["params"])
    params["extra_head"] = {"weight": np.zeros((2, 2), np.float32)}
    latent = dict(params["latent_ode"])
    latent.pop("layer3")
    latent["layer0"] = {"weight": np.zeros((512, 65), np.float32), "bias": latent["layer0"]["bias"]}
    params["latent_ode"] = latent
    with pytest.raises(ValueError) as err:
        params_from_jax(params, ck["state"], CaSPRConfig(), device="cpu")
    msg = str(err.value)
    assert "params.extra_head: unexpected" in msg
    assert "params.latent_ode.layer3: missing" in msg
    assert "params.latent_ode.layer0.weight: shape (512, 65)" in msg


def test_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CaSPRModel(CaSPRConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CaSPRModel(CaSPRConfig(), device="cuda")
    assert CaSPRModel(CaSPRConfig(), device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither JAX nor the JAX package.
    In a subprocess: this process has JAX loaded by conftest.py."""
    code = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "import caspr_tpu_torch, caspr_tpu_torch.nn, caspr_tpu_torch.ops.kernels\n"
        "import caspr_tpu_torch.models, caspr_tpu_torch.weights, chip_smoke\n"
        "import caspr_tpu_torch.train, caspr_tpu_torch.utils.evaluations\n"
        "import caspr_tpu_torch.train.checkpoint, caspr_tpu_torch.ops.odeint\n"
        "import caspr_tpu_torch.data, caspr_tpu_torch.data.native_loader, caspr_tpu_torch.compat\n"
        "import caspr_tpu_torch.cli.train, caspr_tpu_torch.cli.test, caspr_tpu_torch.utils.config\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'caspr_tpu'))\n"
        "assert 'caspr_tpu_torch' in sys.modules\n"
        "print('BAD', bad)\n"
    ).format(repo=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
