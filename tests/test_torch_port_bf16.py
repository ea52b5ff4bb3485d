"""The CNF kernels' bfloat16 matmul mode (``CNFConfig.matmul_dtype="bf16"``,
``CaSPRConfig(cnf_matmul_dtype="bf16")``) against the JAX package's
CASPR_TPU_CNF_MATMUL=bf16 on the CPU.

In that mode every layer product of the fused kernels rounds both operands
to bfloat16 and accumulates in float32 (caspr_tpu/ops/cnf_fused.py ``mm``).
On the CPU the port's wrappers take their plain versions
(``ops/cnf_fused.py::primal_packed``, ``dynamics_packed`` with
``matmul_dtype="bf16"``), and the JAX side runs its own Pallas kernels in
interpret mode (as tests/test_cnf_fused.py does), with
CASPR_TPU_CNF_KERNEL=pallas and CASPR_TPU_CNF_MATMUL=bf16 set by the test
alone (monkeypatch) where a whole block or model runs.  The inputs are made
from a seed with numpy and handed to both sides.

Tolerances:
  - the field (dx, and div for the with-divergence kernel): each output
    within 2e-3 of its largest magnitude of the JAX kernel's.  The two
    round the same float32 values to bfloat16, but a value that the two
    frameworks' sums put on either side of a rounding boundary moves by one
    bfloat16 unit (2^-8 relative), and the next layer carries it on.  And
    the port's distance from the float64 field without rounding within
    1.5x the JAX bf16 kernel's: the port's rounding is the JAX package's,
    not a coarser one;
  - the sampling block (``cnf_block_apply``, and with ``sample_div``) and
    the reconstruct: CNF NFE within 6 of the JAX package's (the margin
    tests/test_cnf_fused.py allows between its own two routes: dopri5's
    accept decisions follow the bfloat16 roundings), equal latent-ODE NFE,
    points within 5e-3 of their largest magnitude (two solves to rtol 1e-5
    of one field whose evaluations differ by the roundings above);
  - the gradient through ``cnf_dynamics(..., "bf16")``: each leaf within
    1e-5 of its largest magnitude of jax.grad's through
    ``fused_concatsquash_dynamics(..., "bf16")``.  Both backwards are the
    float32 composition's VJP (the JAX package's default
    CASPR_TPU_CNF_BWD), so only float32 sums in another order separate
    them.
"""

import functools

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
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.ops import cnf_fused, kernels
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_cnf_layers import _t, _to_torch
from test_torch_port_model import CLOUD_SIZE, TINY, _numpy_weights

FIELD_TOL, VS64_RATIO, POINT_TOL, NFE_MARGIN, GRAD_TOL = 2e-3, 1.5, 5e-3, 6, 1e-5


def _rel(got, want):
    """Largest error over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree.double()


@pytest.mark.parametrize("dims", [(128, 128, 128), (512, 512, 512)], ids=lambda d: f"H{d[0]}")
def test_plain_versions_match_the_jax_bf16_kernels(dims):
    """primal_packed and dynamics_packed with matmul_dtype="bf16" against the
    Pallas kernels with matmul_dtype="bf16" in interpret mode, 2 clouds of
    300 points."""
    jcfg = jcnf.CNFConfig(input_dim=3, dims=dims, zdim=16)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(11)
    tc = (0.5 * rng.standard_normal((2, 17))).astype(np.float32)
    y, e = rng.standard_normal((2, 2, 300, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = (jcnf_fused.fused_concatsquash_primal(jparams, jnp.asarray(tc), jnp.asarray(y),
                                                     "bf16"),
                *jcnf_fused.fused_concatsquash_dynamics(jparams, jnp.asarray(tc), jnp.asarray(y),
                                                        jnp.asarray(e), "bf16"))
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    gb, w = cnf_fused.context_gb(params, _t(tc)), cnf_fused.pack_weights(params)
    got = (cnf_fused.primal_packed(_t(y), gb, *w, "bf16"),
           *cnf_fused.dynamics_packed(_t(y), _t(e), gb, *w, "bf16"))
    p64 = _double(params)
    gb64, w64 = cnf_fused.context_gb(p64, _t(tc).double()), cnf_fused.pack_weights(p64)
    y64, e64 = _t(y).double(), _t(e).double()
    exact = (cnf_fused.primal_packed(y64, gb64, *w64),
             *cnf_fused.dynamics_packed(y64, e64, gb64, *w64))
    for name, g, wnt, x in zip(("primal dx", "dynamics dx", "dynamics div"), got, want, exact):
        err, ours, theirs = _rel(g, wnt), _rel(g, x), _rel(wnt, x)
        assert err <= FIELD_TOL, (name, err)
        assert ours <= VS64_RATIO * theirs, (name, "from float64: port", ours, "JAX", theirs)
        # the mode is on: the bfloat16 field is not the float32 one
        assert _rel(g, x) > 1e-5, (name, ours)


# ----------------------------- the CNF block ------------------------------

BLOCK_CFG = dict(input_dim=3, dims=(128, 128), zdim=8)


@pytest.fixture(scope="module")
def block_problem():
    jcfg = jcnf.CNFConfig(**BLOCK_CFG)
    key = jax.random.PRNGKey(7)
    jparams = jcnf.cnf_block_init(key, jcfg)
    rng = np.random.default_rng(7)
    return dict(jcfg=jcfg, key=key, jparams=jparams,
                params=_to_torch(jax.tree_util.tree_map(np.asarray, jparams)),
                x=rng.standard_normal((2, 96, 3)).astype(np.float32),
                ctx=rng.standard_normal((2, 8)).astype(np.float32),
                e=np.asarray(jax.random.normal(key, (2, 96, 3), jnp.float32)))


@pytest.mark.parametrize("sample_div", [False, True], ids=["points", "sample_div"])
def test_cnf_block_matches_jax_bf16(block_problem, sample_div, monkeypatch):
    """The reverse (sampling) block in bfloat16 against the JAX package's
    with its Pallas kernels in bfloat16; with ``sample_div`` the two-leaf
    decode with the JAX key's noise (CASPR_TPU_SAMPLE_DIV=1)."""
    p = block_problem
    monkeypatch.setenv("CASPR_TPU_CNF_KERNEL", "pallas")
    monkeypatch.setenv("CASPR_TPU_CNF_MATMUL", "bf16")
    monkeypatch.setenv("CASPR_TPU_SAMPLE_DIV", "1" if sample_div else "0")
    with pltpu.force_tpu_interpret_mode():
        want, _, want_nfe = jcnf.cnf_block_apply(p["jparams"], p["jcfg"], jnp.asarray(p["x"]),
                                                 jnp.asarray(p["ctx"]), None, p["key"], True)
    ccfg = cnf.CNFConfig(**BLOCK_CFG, matmul_dtype="bf16")
    kw = dict(sample_div=True, e=_t(p["e"])) if sample_div else {}
    got, nfe = cnf.cnf_block_apply(p["params"], ccfg, _t(p["x"]), _t(p["ctx"]), **kw)
    f32, f32_nfe = cnf.cnf_block_apply(p["params"], cnf.CNFConfig(**BLOCK_CFG), _t(p["x"]),
                                       _t(p["ctx"]), **kw)
    nfes = dict(port=nfe, jax=float(want_nfe), port_f32=f32_nfe)
    assert abs(nfe - float(want_nfe)) <= NFE_MARGIN, nfes
    assert _rel(got, want) <= POINT_TOL, (_rel(got, want), nfes)
    assert not torch.equal(got, f32), nfes  # the mode is on


# ----------------------------- the reconstruct ----------------------------

B, T, N, NUM_POINTS = 2, 3, 48, 32
# TINY's CNF, (32, 32), is one the JAX kernels do not take (can_fuse wants
# widths that are multiples of 128), so the reconstruct runs at TINY with
# the CNF at (128, 128), which both packages' kernels take
RECON = dict(TINY, cnf_dims=(128, 128))


@pytest.fixture(scope="module")
def recon_ref():
    """RECON weights and one batch through the JAX package's jitted
    reconstruct with its Pallas CNF kernels in bfloat16 (interpret mode)."""
    jcfg = JaxConfig(**RECON)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    timestamps = np.linspace(0.0, 1.0, T, dtype=np.float32)
    jmodel = JaxModel(jcfg)
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setenv("CASPR_TPU_CNF_KERNEL", "pallas")
        mp.setenv("CASPR_TPU_CNF_MATMUL", "bf16")
        mp.delenv("CASPR_TPU_SAMPLE_DIV", raising=False)
        y, _, rec, _, nfe = jax.jit(
            lambda p, s, xx, ts, k: jmodel.reconstruct(p, s, xx, k, num_points=NUM_POINTS,
                                                       timestamps=ts)
        )(as_j(params_np), as_j(state_np), jnp.asarray(x), jnp.asarray(timestamps),
          jax.random.PRNGKey(17))
    return dict(y=np.asarray(y), rec=np.asarray(rec), nfe=tuple(float(v) for v in nfe), x=x,
                timestamps=timestamps, params_np=params_np, state_np=state_np)


def _port_reconstruct(ref, matmul_dtype):
    cfg = CaSPRConfig(**RECON, cnf_matmul_dtype=matmul_dtype)
    params, state = params_from_jax(ref["params_np"], ref["state_np"], cfg, device="cpu")
    return CaSPRModel(cfg, device="cpu").reconstruct(
        params, state, _t(ref["x"]), None, num_points=NUM_POINTS,
        timestamps=_t(ref["timestamps"]), base_samples=_t(ref["y"]))


def test_reconstruct_matches_jax_bf16(recon_ref, monkeypatch):
    """CaSPRModel.reconstruct with cnf_matmul_dtype="bf16": the decode
    through the primal wrapper in bfloat16 once per CNF evaluation."""
    calls = []
    real = kernels.cnf_primal
    monkeypatch.setattr(cnf, "cnf_primal", lambda *a: calls.append(a[-1]) or real(*a))
    kernels.reset_launches()
    _, _, rec, _, nfe = _port_reconstruct(recon_ref, "bf16")
    want_nfe = recon_ref["nfe"]
    assert nfe[0] == want_nfe[0], (nfe, want_nfe)
    assert abs(nfe[1] - want_nfe[1]) <= NFE_MARGIN, (nfe, want_nfe)
    assert calls == ["bf16"] * int(nfe[1])
    assert not any(kernels.launches.values())  # plain versions on the CPU
    assert rec.shape == (B, T, NUM_POINTS, 3)
    assert _rel(rec, recon_ref["rec"]) <= POINT_TOL, (_rel(rec, recon_ref["rec"]), nfe, want_nfe)


def test_one_converted_parameter_set_runs_in_both_modes(recon_ref):
    """params_from_jax is arithmetic-blind: the same converted weights
    reconstruct in float32 and in bfloat16, finite, and the two decodes
    differ (the mode is on) by about what the roundings give."""
    _, _, f32, _, f32_nfe = _port_reconstruct(recon_ref, "f32")
    _, _, bf16, _, bf16_nfe = _port_reconstruct(recon_ref, "bf16")
    assert bool(torch.isfinite(f32).all()) and bool(torch.isfinite(bf16).all())
    assert f32_nfe[0] == bf16_nfe[0]  # the latent ODE has no bfloat16 mode
    assert 0.0 < _rel(bf16, f32) <= POINT_TOL, (_rel(bf16, f32), f32_nfe, bf16_nfe)


# ------------------------------ the gradient ------------------------------


def test_gradient_through_bf16_dynamics_matches_jax(monkeypatch):
    """The gradient of a loss through cnf_dynamics(..., "bf16") (the
    float32 VJP, ops.kernels._CNFDynamics) against jax.grad through
    fused_concatsquash_dynamics(..., "bf16") under the default backward."""
    monkeypatch.delenv("CASPR_TPU_CNF_BWD", raising=False)
    jcfg = jcnf.CNFConfig(**BLOCK_CFG)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(9), jcfg)
    rng = np.random.default_rng(9)
    tc = (0.5 * rng.standard_normal((2, 9))).astype(np.float32)
    y, e, ct_dx = rng.standard_normal((3, 2, 64, 3)).astype(np.float32)
    ct_div = rng.standard_normal((2, 64)).astype(np.float32)

    def loss(p, c, yy):
        with pltpu.force_tpu_interpret_mode():
            dx, div = jcnf_fused.fused_concatsquash_dynamics(p, c, yy, jnp.asarray(e), "bf16")
        return jnp.sum(dx * ct_dx) + jnp.sum(div * ct_div)

    want = jax.grad(loss, argnums=(0, 1, 2))(jparams, jnp.asarray(tc), jnp.asarray(y))
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = jax.tree_util.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    c, points = _t(tc).requires_grad_(), _t(y).requires_grad_()
    dx, div = cnf.fused_concatsquash_dynamics(params, c, points, _t(e), "bf16")
    ((dx * _t(ct_dx)).sum() + (div * _t(ct_div)).sum()).backward()
    got = [leaf.grad for leaf in leaves] + [c.grad, points.grad]
    wants = jax.tree_util.tree_leaves(want[0]) + [want[1], want[2]]
    assert len(got) == len(wants)
    for g, w in zip(got, wants):
        assert _rel(g, w) <= GRAD_TOL, (tuple(w.shape), _rel(g, w))


# --------------------------------- pins -----------------------------------


def test_matmul_dtype_defaults_to_f32_and_reaches_the_cnf_config():
    assert cnf.CNFConfig().matmul_dtype == "f32"
    assert CaSPRConfig().cnf_matmul_dtype == "f32"
    assert CaSPRConfig().cnf_config().matmul_dtype == "f32"
    assert CaSPRConfig(cnf_matmul_dtype="bf16").cnf_config().matmul_dtype == "bf16"
    with pytest.raises(ValueError, match="matmul_dtype"):
        cnf.CNFConfig(matmul_dtype="fp16")
    y, gb, wf, wh, wl = (torch.ones(s) for s in ((1, 4, 3), (1, 8, 32), (32, 3), (1, 32, 32),
                                                  (3, 32)))
    for bad in ("fp16", "bfloat16", None):
        with pytest.raises(ValueError, match="matmul_dtype"):
            kernels.cnf_primal(y, gb, wf, wh, wl, bad)
        with pytest.raises(ValueError, match="matmul_dtype"):
            kernels.cnf_dynamics(y, y, gb, wf, wh, wl, bad)


def test_cpu_wrappers_take_the_bf16_plain_versions():
    g = torch.Generator().manual_seed(3)
    y, e = torch.randn((2, 2, 40, 3), generator=g)
    gb = torch.rand((2, 8, 64), generator=g)
    w = (torch.randn((64, 3), generator=g), torch.randn((2, 64, 64), generator=g) / 8,
         torch.randn((3, 64), generator=g) / 8)
    kernels.reset_launches()
    assert torch.equal(kernels.cnf_primal(y, gb, *w, "bf16"),
                       cnf_fused.primal_packed(y, gb, *w, "bf16"))
    for a, b in zip(kernels.cnf_dynamics(y, e, gb, *w, "bf16"),
                    cnf_fused.dynamics_packed(y, e, gb, *w, "bf16")):
        assert torch.equal(a, b)
    assert not any(kernels.launches.values())
    # the f32 plain versions are untouched by the mode's code
    assert not torch.equal(cnf_fused.primal_packed(y, gb, *w, "bf16"),
                           cnf_fused.primal_packed(y, gb, *w))


@pytest.mark.parametrize("dims", [(16, 32), (32,)], ids=lambda d: "-".join(map(str, d)))
def test_bf16_is_not_read_where_the_kernels_do_not_take_the_config(dims, monkeypatch):
    """Where kernel_takes is false, and bf16_takes (the JAX package's
    can_fuse) too, the composition runs at float32 whatever matmul_dtype
    says, as the JAX package's odenet_apply does where its
    _dynamics_kernel_mode is "xla": the same bits in both modes, and no
    fused wrapper called (tests/test_torch_port_bf16_vjp.py covers the
    configs where only one of the two holds)."""
    for name in ("fused_concatsquash_primal", "fused_concatsquash_dynamics"):
        monkeypatch.setattr(cnf, name, lambda *a: pytest.fail("a fused wrapper was called"))
    cfgs = [cnf.CNFConfig(dims=dims, zdim=8, matmul_dtype=m) for m in ("f32", "bf16")]
    assert not cnf_fused.kernel_takes(cfgs[1]) and not cnf_fused.bf16_takes(cfgs[1])
    rng = np.random.default_rng(2)
    jparams = jcnf.cnf_block_init(jax.random.PRNGKey(2), jcnf.CNFConfig(dims=dims, zdim=8))
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    x = _t(rng.standard_normal((2, 40, 3)))
    ctx = _t(rng.standard_normal((2, 8)))
    e = _t(rng.standard_normal((2, 40, 3)))
    tc = torch.cat([torch.full((2, 1), 0.3), ctx], dim=1)
    runs = [(cnf.odenet_primal(params["odenet"], c, tc, x),
             *cnf.odenet_dynamics(params["odenet"], c, tc, x, e),
             *cnf.cnf_block_apply(params, c, x, ctx)) for c in cfgs]
    (f32, bf16) = runs
    for a, b in zip(f32, bf16):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
