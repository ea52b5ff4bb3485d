"""The reference-parity decode (``sample_div=True``), ``flow_total_time`` and
``utils/transforms.py`` against the JAX package on the CPU.

The JAX package's decode integrates the points alone unless
CASPR_TPU_SAMPLE_DIV=1, where it integrates the reference's two-leaf state,
the points and a log-density from zero with a Hutchinson noise drawn per
solve (caspr_tpu/models/cnf.py::cnf_block_apply).  The port takes that as
an argument: ``reconstruct(..., sample_div=True, e=...)``.  Here the JAX
package's jitted reconstruct runs at the TINY configuration of
tests/test_torch_port_model.py with the variable set by the test alone
(monkeypatch), and the port gets its base samples and the noise the JAX
side drew, ``jax.random.normal(jax.random.split(k_flow, 1)[0], (B*T,
num_points, 3))`` with ``k_samp, k_flow = jax.random.split(key)``
(caspr_tpu/models/caspr.py::decode).  TINY's CNF, (32, 32), is one the
fused kernels take, so the port's decode runs the ``cnf_dynamics`` wrapper
(its plain version on the CPU) once per evaluation and no ``cnf_primal``.

Tolerances:
  - reconstruct: equal NFE, points 1e-4 abs (tests/test_torch_port_model.py's
    bar, on its weights, CNF_GAIN included: 1.0e-5 read, on points up to
    7.2).  The bar is one for O(1) points: on another draw of weights
    (default_rng(31)) whose gained flow carries points out to 41.5, the
    default decode and the sample-div one both land 9.3e-4 from the JAX
    package's (2.2e-5 of the largest; the encoder's float32 rounding,
    carried through an expanding flow), with equal NFE;
  - the identities of tests/test_cnf_fused.py::test_sample_mode_skips_
    divergence on the port: the sample-div block bit-equal to an explicit
    integration of (points, zero log-density) with equal NFE, and the
    default decode within 1e-3 of it (the same field under another error
    norm: other accepted steps);
  - flow_total_time and its gradient: 1e-7 relative; the transforms:
    bit-equal (the same numpy code on the same rng).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.models.caspr import CaSPRConfig as JaxConfig
from caspr_tpu.models.caspr import CaSPRModel as JaxModel
from caspr_tpu.models.caspr import caspr_init
from caspr_tpu.utils import transforms as jtransforms
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.ops import kernels, odeint
from caspr_tpu_torch.utils import transforms
from caspr_tpu_torch.weights import params_from_jax
from test_torch_port_cnf_layers import _jcfg, _t, check_flow_both_ways, flow_problem
from test_torch_port_model import CLOUD_SIZE, TINY, _numpy_weights

B, T, N, NUM_POINTS = 2, 3, 48, 32
POINT_TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """TINY weights and one batch through the JAX package's jitted
    reconstruct with CASPR_TPU_SAMPLE_DIV=1."""
    jcfg = JaxConfig(**TINY)
    shapes = jax.eval_shape(functools.partial(caspr_init, cfg=jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)  # tests/test_torch_port_model.py's weights
    params_np = _numpy_weights(shapes[0], rng)
    state_np = _numpy_weights(shapes[1], rng, "/point_cnf")
    x = rng.random((B, T, N, 4), dtype=np.float32)
    x[..., :3] *= CLOUD_SIZE
    x[..., 3] = np.linspace(0.0, 5.0, T, dtype=np.float32)[None, :, None]
    timestamps = np.linspace(0.0, 1.0, T, dtype=np.float32)
    key = jax.random.PRNGKey(17)
    k_flow = jax.random.split(key)[1]
    e = np.asarray(jax.random.normal(jax.random.split(k_flow, 1)[0], (B * T, NUM_POINTS, 3)))
    jmodel = JaxModel(jcfg)
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CASPR_TPU_SAMPLE_DIV", "1")
        y, _, rec, _, nfe = jax.jit(
            lambda p, s, xx, ts, k: jmodel.reconstruct(p, s, xx, k, num_points=NUM_POINTS,
                                                       timestamps=ts)
        )(as_j(params_np), as_j(state_np), jnp.asarray(x), jnp.asarray(timestamps), key)
    cfg = CaSPRConfig(**TINY)
    params, state = params_from_jax(params_np, state_np, cfg, device="cpu")
    return dict(y=np.asarray(y), rec=np.asarray(rec), nfe=tuple(float(v) for v in nfe), e=e,
                x=x, timestamps=timestamps, cfg=cfg, params=params, state=state,
                model=CaSPRModel(cfg, device="cpu"))


def _reconstruct(ref, **kw):
    return ref["model"].reconstruct(ref["params"], ref["state"], _t(ref["x"]), None,
                                    num_points=NUM_POINTS, timestamps=_t(ref["timestamps"]),
                                    base_samples=_t(ref["y"]), **kw)


def test_sample_div_reconstruct_matches_jax(ref, monkeypatch):
    """The decode through the with-divergence wrapper, once per evaluation,
    and never the primal one."""
    calls = []
    for name in ("fused_concatsquash_primal", "fused_concatsquash_dynamics"):
        real = getattr(cnf, name)
        monkeypatch.setattr(cnf, name, lambda *a, real=real, name=name: calls.append(name)
                            or real(*a))
    kernels.reset_launches()
    _, _, rec, _, nfe = _reconstruct(ref, sample_div=True, e=_t(ref["e"]))
    assert nfe == ref["nfe"]
    assert calls == ["fused_concatsquash_dynamics"] * int(nfe[1])
    assert not any(kernels.launches.values())  # plain versions on the CPU
    assert rec.shape == (B, T, NUM_POINTS, 3)
    np.testing.assert_allclose(rec.numpy(), ref["rec"], rtol=0, atol=POINT_TOL)


def test_sample_div_draws_noise_from_the_generator(ref):
    """Without ``e`` each block's noise is drawn from the generator at the
    points' shape, as flow_forward draws it."""
    seeded = lambda: torch.Generator().manual_seed(5)
    _, _, a, _, nfe_a = ref["model"].reconstruct(
        ref["params"], ref["state"], _t(ref["x"]), seeded(), num_points=NUM_POINTS,
        timestamps=_t(ref["timestamps"]), base_samples=_t(ref["y"]), sample_div=True)
    e = torch.randn((B * T, NUM_POINTS, 3), generator=seeded())
    _, _, b, _, nfe_b = _reconstruct(ref, sample_div=True, e=e)
    assert nfe_a == nfe_b and torch.equal(a, b)


def test_sample_div_identities(ref):
    """The sample-div block equals integrating (points, an explicit zero
    log-density) under the reverse field (-dx, e^T J e); the default
    decode, on the points alone, stays within 1e-3 of it."""
    block, ccfg = ref["params"]["point_cnf"][1], ref["cfg"].cnf_config()
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((B * T, NUM_POINTS, 3)))
    ctx = _t(0.3 * rng.standard_normal((B * T, ccfg.zdim)))
    e = _t(rng.standard_normal((B * T, NUM_POINTS, 3)))
    y, nfe = cnf.cnf_block_apply(block, ccfg, x, ctx, sample_div=True, e=e)
    t_end = np.float32(float(block["sqrt_end_time"]) ** 2)
    bt, n, d = x.shape

    def field(s, state):
        tc = torch.cat([torch.full((bt, 1), float(t_end - s)), ctx], dim=1)
        dx, div = cnf.odenet_dynamics(block["odenet"], ccfg, tc, state[0].reshape(bt, n, d), e)
        return -dx.reshape(bt, -1), div

    (xs, lps), nfe_z = odeint(field, (x.reshape(bt, -1), torch.zeros((bt, n))),
                              np.array([0.0, t_end], np.float32), rtol=ccfg.rtol, atol=ccfg.atol)
    assert nfe == nfe_z and torch.equal(y, xs[1].reshape(bt, n, d))
    assert float(lps[1].abs().max()) > 0.0  # the log-density was integrated
    y_fast, _ = cnf.cnf_block_apply(block, ccfg, x, ctx)
    np.testing.assert_allclose(y_fast.numpy(), y.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("config", [("squash", "swish"), ("concat", "relu")],
                         ids=lambda c: "-".join(c))
def test_sample_div_flow_reverse_matches_jax(config, monkeypatch):
    """flow_reverse(sample_div=True) of configs the kernels do not take
    against flow_apply(reverse=True) under CASPR_TPU_SAMPLE_DIV=1, the JAX
    side eager, with the JAX key's noise."""
    prob = flow_problem(_jcfg(*config), seed=3)
    monkeypatch.setenv("CASPR_TPU_SAMPLE_DIV", "1")
    with jax.disable_jit():
        want, _, _, want_nfe = jcnf.flow_apply(
            prob["jparams"], prob["jstate"], prob["jcfg"], jnp.asarray(prob["x"]),
            jnp.asarray(prob["ctx"]), None, prob["key"], reverse=True)
    got, nfe = cnf.flow_reverse(prob["params"], prob["state"], prob["cfg"], _t(prob["x"]),
                                _t(prob["ctx"]), sample_div=True, e=[_t(e) for e in prob["e"]])
    assert nfe == float(want_nfe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=POINT_TOL)


# ------------------- the knobs reached through CNFConfig -------------------


@pytest.mark.parametrize("knob", [dict(train_T=False), dict(batch_norm=False),
                                  dict(num_blocks=2)], ids=lambda k: "-".join(map(str, k.items())))
def test_config_knobs_match_jax(knob):
    """Reverse and forward against flow_apply for the CNFConfig knobs the
    JAX package's CaSPRConfig never sets."""
    check_flow_both_ways(flow_problem(_jcfg("concatsquash", "softplus", **knob), seed=21))


# -------------------------- flow_total_time --------------------------------


@pytest.mark.parametrize("knob", [dict(num_blocks=2), dict(train_T=False)],
                         ids=lambda k: "-".join(map(str, k.items())))
def test_flow_total_time_matches_jax(knob):
    jcfg = _jcfg("concatsquash", "softplus", **knob)
    prob = flow_problem(jcfg, seed=2)
    rng = np.random.default_rng(2)
    jparams = [dict(p, sqrt_end_time=jnp.float32(rng.uniform(0.5, 1.0))) if "sqrt_end_time" in p
               else p for p in prob["jparams"]]
    want = jcnf.flow_total_time(jparams, jcfg)
    params = [dict(p, sqrt_end_time=_t(np.asarray(jp["sqrt_end_time"])).requires_grad_())
              if "sqrt_end_time" in p else p for p, jp in zip(prob["params"], jparams)]
    got = cnf.flow_total_time(params, prob["cfg"])
    np.testing.assert_allclose(float(got.detach() if isinstance(got, torch.Tensor) else got), float(want), rtol=1e-7)
    if not jcfg.train_T:
        assert isinstance(got, float) and got == jcfg.time_length * jcfg.num_blocks
        return
    want_grad = jax.grad(lambda ps: jcnf.flow_total_time(ps, jcfg))(jparams)
    got.backward()
    for p, wg in zip(params, want_grad):
        if "sqrt_end_time" in p:
            np.testing.assert_allclose(float(p["sqrt_end_time"].grad),
                                       float(wg["sqrt_end_time"]), rtol=1e-7)


# ----------------------------- utils/transforms ----------------------------


@pytest.mark.parametrize("name,args", [
    ("quaternion_to_matrix", ([0.3, -0.2, 0.9, 0.1],)),
    ("axis_angle_to_matrix", ([0.4, -1.2, 0.7],)),
    ("axis_angle_to_matrix", ([0.0, 0.0, 0.0],)),
    ("random_rotation", ()),
    ("rotation_axis", ([1.0, 2.0, -0.5], 0.8)),
    ("random_rotation_axis", ("y",)),
    ("random_sphere_point", ()),
    ("random_sphere_points", (64, 0.7)),
    ("sphere_surface_points", (64, 0.3)),
    ("normals_to_angles", (np.random.default_rng(0).standard_normal((5, 7, 3)),)),
    ("angles_to_normals", (np.random.default_rng(1).uniform(0.0, 3.0, (6, 2)),)),
])
def test_transforms_match_jax_package(name, args):
    """The same numbers under the same rng, and the same module contents."""
    takes_rng = name.startswith("random_") or name == "sphere_surface_points"
    kw = lambda: {"rng": np.random.default_rng(7)} if takes_rng else {}
    want = getattr(jtransforms, name)(*args, **kw())
    got = getattr(transforms, name)(*args, **kw())
    assert np.array_equal(got, want)


def test_transforms_names_and_refusal():
    public = lambda m: sorted(k for k in vars(m) if not k.startswith("_") and k != "annotations")
    assert public(transforms) == public(jtransforms)
    with pytest.raises(ValueError, match="Axis"):
        transforms.random_rotation_axis("w")
