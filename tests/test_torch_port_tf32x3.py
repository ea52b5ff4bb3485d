"""The 3xTF32 arithmetic of the tensor-core CNF kernels, modelled on the CPU
(caspr_tpu_torch/checks/tf32x3_arithmetic.py).

The kernels (csrc/cnf_primal.cu, csrc/cnf_dynamics.cu) cannot run here, so
these tests hold their arithmetic, as the emulation models it, to the bars
the card holds the kernels to:

  - ``round_tf32`` rounds to nearest with ties away from zero (the PTX
    ``cvt.rna.tf32.f32``), and hi + lo gives back the float32 value to
    within 2^-22 relative;
  - at full width with the trained decoder, the emulated stacks lie within
    1e-5 relative (largest error over largest magnitude) of the float64
    plain version, and within 4x the float32 plain version's own distance
    from it (chip_smoke.py phase 2 (b));
  - at TINY widths they agree at 1e-5 abs with the JAX package's Pallas
    kernels in interpret mode (``_fused_primal_call``, ``_fused_call``; JAX
    runs at "highest" precision here, tests/conftest.py);
  - swapped into the model, they leave the solvers' NFE as the float32 plain
    versions give it, on chip_smoke.py phase 5's problem: the prediction for
    the card-versus-CPU phases, where equal NFE is the bar;
  - the VJP kernel's products (csrc/cnf_dynamics_vjp.cu): the forward
    recompute, the input cotangents dm W (the weights transposed) and the
    weight gradients dm^T z, a product over every row (K = 2 x points),
    each K-slice of 8 rows summed apart and the slices added in float32:
    each output of the emulated VJP within 1e-5 relative of the float64
    plain version and 4x the float32 plain version's distance (the card's
    bar is 1e-4), and the long-K product alone at the training path's
    51 200 rows within 4x float32's distance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu_torch.checks import tf32x3_arithmetic as tf32x3
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
from caspr_tpu_torch.ops import cnf_fused, kernels
from caspr_tpu_torch.weights import load_demo
from test_torch_port_model import TINY


def _bits(values):
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_round_tf32_is_nearest_with_ties_away_from_zero():
    one = 0x3F800000  # 1.0; the last kept bit of the mantissa is 0x2000
    for sign in (0, 0x80000000):
        x = _bits([sign | (one + 0x0FFF), sign | (one + 0x1000), sign | (one + 0x1001),
                   sign | (one + 0x2000 + 0x1000), sign | (one + 0x3FFF)])
        want = _bits([sign | one, sign | (one + 0x2000), sign | (one + 0x2000),
                      sign | (one + 0x4000), sign | (one + 0x4000)])
        assert torch.equal(tf32x3.round_tf32(x), want)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    hi, lo = tf32x3.split_tf32(x)
    for part in (hi, lo):  # the 13 dropped bits are clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22


@pytest.fixture(scope="module")
def demo_inputs():
    """The trained decoder (H = 512) at 2 clouds of 128 seeded points."""
    return tf32x3.phase2_inputs(torch.device("cpu"), bt=2, n=128, seed=3)


def test_emulated_stacks_keep_float32_accuracy_at_full_width(demo_inputs):
    y, e, gb, wf, wh, wl = demo_inputs
    w64 = [t.double() for t in (gb, wf, wh, wl)]
    cases = [
        (tf32x3.primal_tf32x3(y, gb, wf, wh, wl), cnf_fused.primal_packed(y, gb, wf, wh, wl),
         cnf_fused.primal_packed(y.double(), *w64)),
        (tf32x3.dynamics_tf32x3(y, e, gb, wf, wh, wl), cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl),
         cnf_fused.dynamics_packed(y.double(), e.double(), *w64)),
    ]
    for got, plain, exact in cases:
        for g, p, x in zip(*(r if isinstance(r, tuple) else (r,) for r in (got, plain, exact))):
            emulated, float32 = tf32x3.rel_distance(g, x), tf32x3.rel_distance(p, x)
            assert emulated <= 1e-5 and emulated <= 4.0 * float32, (emulated, float32)


def test_emulated_stacks_match_the_jax_kernels_at_tiny_widths():
    """3 -> 32 -> 32 -> 3 (TINY's CNF) on a ragged cloud, against the Pallas
    kernels in interpret mode."""
    cfg = jcnf.CNFConfig(input_dim=3, dims=tuple(TINY["cnf_dims"]), zdim=16)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(5)
    tc = (0.5 * rng.standard_normal((3, 17))).astype(np.float32)
    y = rng.standard_normal((3, 200, 3)).astype(np.float32)
    e = rng.standard_normal((3, 200, 3)).astype(np.float32)
    jgb = jcnf_fused._context_gb(jparams, jnp.asarray(tc))
    jw = jcnf_fused._pack_weights(jparams)
    with pltpu.force_tpu_interpret_mode():
        want_dx = jcnf_fused._fused_primal_call(*jw, jgb, jnp.asarray(y))
        want_dyn = jcnf_fused._fused_call(*jw, jgb, jnp.asarray(y), jnp.asarray(e))
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), jparams)
    gb = cnf_fused.context_gb(params, torch.from_numpy(tc))
    w = cnf_fused.pack_weights(params)
    got_dx = tf32x3.primal_tf32x3(torch.from_numpy(y), gb, *w)
    got_dyn = tf32x3.dynamics_tf32x3(torch.from_numpy(y), torch.from_numpy(e), gb, *w)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=0, atol=1e-5)
    for got, want in zip(got_dyn, want_dyn):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _phase5(model, params, state):
    """chip_smoke.py phase 5's problem on the CPU (its seed and draws):
    (decoded points, reconstruct NFE, nll, forward NFE)."""
    rng = np.random.default_rng(0)
    x = rng.random((1, 2, 2048, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    target = rng.random((1, 2, 2048, 4), dtype=np.float32)
    target[..., 3] = np.array([0.2, 0.9], np.float32)[None, :, None]
    noise = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    t = torch.from_numpy
    with torch.no_grad():
        _, _, rec, _, nfe = model.reconstruct(params, state, t(x), None, num_points=512,
                                              timestamps=t(ts), base_samples=t(base))
        res, _ = model.forward(params, state, t(x), t(target), e=t(noise))
    return rec, nfe, res["nll"], res["nfe"]


def test_emulated_kernels_keep_the_solvers_nfe(monkeypatch):
    model = CaSPRModel(CaSPRConfig(), device="cpu")
    params, state = load_demo(device="cpu")
    rec, nfe, nll, nfe_forward = _phase5(model, params, state)
    monkeypatch.setattr(kernels, "primal_packed", tf32x3.primal_tf32x3)
    monkeypatch.setattr(kernels, "dynamics_packed", tf32x3.dynamics_tf32x3)
    rec_tc, nfe_tc, nll_tc, nfe_forward_tc = _phase5(model, params, state)
    assert not torch.equal(rec_tc, rec)  # the swap took effect
    assert nfe_tc == nfe and nfe_forward_tc == nfe_forward
    assert float((rec_tc - rec).abs().max()) <= 1e-3  # phase 5's bars
    assert float((nll_tc - nll).abs().max()) <= 1e-3


def test_emulated_vjp_keeps_float32_accuracy_at_full_width(demo_inputs):
    y, e, gb, wf, wh, wl = demo_inputs
    g = torch.Generator().manual_seed(4)
    args = (y, e, gb, wf, wh, wl, torch.randn(y.shape, generator=g),
            torch.randn(y.shape[:2], generator=g))
    got = tf32x3.dynamics_vjp_tf32x3(*args)
    plain = cnf_fused.dynamics_vjp_packed(*args)
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    for name, gg, p, x in zip(("dy", "dgb", "dw_first", "dw_hidden", "dw_last"), got, plain, exact):
        emulated, float32 = tf32x3.rel_distance(gg, x), tf32x3.rel_distance(p, x)
        assert emulated <= 1e-5 and emulated <= 4.0 * float32, (name, emulated, float32)


def test_emulated_weight_gradient_over_a_long_k():
    """dm^T z over 51 200 rows (25 clouds x 1024 points x 2 streams), in 16
    chunks, as the kernel's split-K product runs it: float32-class."""
    g = torch.Generator().manual_seed(6)
    dm = torch.randn((51_200, 64), generator=g) * torch.rand((51_200, 1), generator=g)
    z = torch.nn.functional.softplus(torch.randn((51_200, 96), generator=g))
    exact = dm.double().T @ z.double()
    emulated = tf32x3.rel_distance(tf32x3.weight_grad_tf32x3(dm, z, chunks=16), exact)
    float32 = tf32x3.rel_distance(dm.T @ z, exact)
    assert emulated <= 4.0 * float32, (emulated, float32)
