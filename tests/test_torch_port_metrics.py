"""The port's metrics against the JAX package on the CPU: the approxmatch
EMD (value and gradient) and the Chamfer distance.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU the port's ``approx_match_emd`` takes its plain version
(ops/metrics.py), the oracle of the CUDA kernel; the JAX side is run both
ways it can run here: its XLA composition, and its Pallas kernel in
interpret mode.

Tolerances:
  - EMD cost against the XLA composition, which sums in the same order:
    rtol = atol = 1e-4, the bar the JAX package holds its own kernel to
    (tests/test_emd_pallas.py);
  - EMD cost against the Pallas kernel in interpret mode: rtol = 5e-4.  The
    kernel sums its tiles in another order, and at these sizes the float32
    result depends on that order up to a few 1e-4: on the first pair of the
    128 x 128 case the plain version, the XLA composition and the Pallas
    kernel sit 3.8e-4, 3.7e-4 and 1.7e-4 from the float64 value of the same
    algorithm (at level -4^7 a last-bit difference in d^2 is 1.6e-3 in the
    exponent);
  - EMD gradient: 2e-4 abs.  The gradient is a sum of unit vectors weighted
    by the match, and single entries of the float32 match depend on the
    order of the sums in the same way: the two float32 gradients differ by
    6e-5 at most here (5% of the entries by more than 1e-5), while each is
    2.7e-2 from the float64 gradient of the same algorithm;
  - Chamfer: 1e-6 abs.  Both sides pick the neighbour from the expansion
    and take the distance in the exact difference form, so a different
    pick between near-equal neighbours moves the value by rounding only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.ops import metrics as jmetrics
from caspr_tpu.ops.emd_pallas import approx_match_emd_pallas
from caspr_tpu_torch.ops import approx_match_emd, chamfer_distance, kernels, metrics

EMD_TOL = {"xla": 1e-4, "pallas_interpret": 5e-4}


def _clouds(seed, b, n, m):
    rng = np.random.default_rng(seed)
    return rng.random((b, n, 3), dtype=np.float32), rng.random((b, m, 3), dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("b,n,m", [(2, 128, 128), (2, 100, 150), (1, 64, 1024)])
@pytest.mark.parametrize("jax_route", ["xla", "pallas_interpret"])
def test_emd_matches_jax(b, n, m, jax_route):
    x1, x2 = _clouds(n + m, b, n, m)
    if jax_route == "xla":
        want = jmetrics.approx_match_emd(jnp.asarray(x1), jnp.asarray(x2))
    else:
        with pltpu.force_tpu_interpret_mode():
            want = approx_match_emd_pallas(jnp.asarray(x1), jnp.asarray(x2))
    kernels.reset_launches()
    got = approx_match_emd(_t(x1), _t(x2))
    assert kernels.launches["emd"] == 0  # the plain route on the CPU
    assert got.shape == (b,) and got.dtype == torch.float32
    tol = EMD_TOL[jax_route]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_emd_identity_near_zero():
    x1, _ = _clouds(3, 2, 96, 96)
    got = approx_match_emd(_t(x1), _t(x1)).numpy()
    assert np.all(got / 96 < 5e-3)


def test_emd_match_conserves_mass():
    """Every left point ends up sending its capacity, every right point
    receives at most its own (N < M: capacities M/N and 1)."""
    x1, x2 = _clouds(4, 1, 50, 80)
    match = metrics._approx_match(_t(x1[0]), _t(x2[0]))
    np.testing.assert_allclose(match.sum(dim=1).numpy(), 80 / 50, rtol=1e-3)
    assert float(match.sum(dim=0).max()) <= 1.0 + 1e-4


def test_emd_gradient_matches_jax():
    x1, x2 = _clouds(5, 2, 64, 64)
    weights = np.array([1.0, -0.5], np.float32)  # a non-uniform cotangent
    want1, want2 = jax.grad(
        lambda a, b: jnp.sum(jmetrics.approx_match_emd(a, b) * weights), argnums=(0, 1)
    )(jnp.asarray(x1), jnp.asarray(x2))
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    (approx_match_emd(a, b) * _t(weights)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want1), rtol=0, atol=2e-4)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want2), rtol=0, atol=2e-4)


@pytest.mark.parametrize("bad", ["dtype", "last_dim", "batch"])
def test_emd_refuses_what_the_kernel_does_not_take(bad):
    x1, x2 = (_t(c) for c in _clouds(6, 2, 8, 8))
    if bad == "dtype":
        with pytest.raises(TypeError):
            approx_match_emd(x1.double(), x2.double())
    elif bad == "last_dim":
        with pytest.raises(ValueError):
            approx_match_emd(x1[..., :2].contiguous(), x2)
    else:
        with pytest.raises(ValueError, match="batch"):
            approx_match_emd(x1, x2[:1])


# batch 2 is one chunk; batch 6 is more than a chunk of 4 and ends in a short one
@pytest.mark.parametrize("b,n,m", [(2, 300, 200), (6, 40, 56)])
def test_chamfer_matches_jax(b, n, m):
    assert metrics.CHAMFER_CHUNK == 4
    pred, gt = _clouds(7 + b, b, n, m)
    want1, want2 = jmetrics.chamfer_distance(jnp.asarray(pred), jnp.asarray(gt))
    got1, got2 = chamfer_distance(_t(pred), _t(gt))
    assert got1.shape == (b, n) and got2.shape == (b, m)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=0, atol=1e-6)
    # and against brute force in float64
    d = ((pred[:, :, None, :].astype(np.float64) - gt[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got1.numpy(), d.min(axis=2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got2.numpy(), d.min(axis=1), rtol=0, atol=1e-6)


def test_chamfer_near_duplicate_points_keep_their_digits():
    """Neighbours 1e-4 apart at coordinates near 1: the expansion alone would
    lose half the digits of d^2 = 3e-8; the refined value keeps them."""
    rng = np.random.default_rng(9)
    gt = (0.9 + 0.1 * rng.random((1, 64, 3))).astype(np.float32)
    pred = gt + np.float32(1e-4)
    got1, _ = chamfer_distance(_t(pred), _t(gt))
    exact = ((pred.astype(np.float64) - gt) ** 2).sum(-1)
    np.testing.assert_allclose(got1.numpy(), exact, rtol=1e-5, atol=0)
