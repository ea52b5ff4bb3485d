"""The port's plain ops against the JAX package's XLA versions on the CPU.

On the CPU the JAX package takes its XLA versions (ops/pointops.py
_use_pallas() is False), and tests/test_pallas_kernels.py holds the
Pallas kernels to those; these tests hold the port's plain versions to
them, and the card run (chip_smoke.py, test_torch_port_kernels.py) holds
the CUDA kernels to the plain versions.  Inputs are made with numpy from a
seed and handed to both sides.

Tolerances:
  - indices (FPS, ball query, three-NN, gather): identical.  Both sides
    compute squared distances in the same difference form, so ties
    (duplicated or grid points) break the same way;
  - ball query may differ only where a distance is within 1e-5 of r^2 (a
    last-bit difference in d^2 flips the strict compare there);
  - values (distances, interpolation, linear, group_norm): 1e-6 abs, the
    float32 rounding of a few reordered sums of O(1) terms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caspr_tpu.nn import core as jcore
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu.ops import pointops as jops
from caspr_tpu.ops import sampling as jsampling
from caspr_tpu_torch.nn import group_norm, linear
from caspr_tpu_torch.ops import cnf_fused, kernels, pointops, sampling

VALUE_TOL = 1e-6


def _cloud(rng, b, n, kind):
    if kind == "uniform":
        return rng.random((b, n, 3), dtype=np.float32)
    if kind == "duplicated":  # every point four times, shuffled: exact ties
        base = rng.random((b, n // 4, 3), dtype=np.float32)
        pts = np.repeat(base, 4, axis=1)
        return np.stack([p[rng.permutation(n)] for p in pts])
    # coordinates on a 1/4 grid: many exactly equal distances
    return (rng.integers(0, 5, (b, n, 3)) / 4.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "grid"])
def test_pairwise_sqdist_matches(kind):
    rng = np.random.default_rng(0)
    a, b = _cloud(rng, 2, 32, kind), _cloud(rng, 2, 24, kind)
    got = pointops.pairwise_sqdist(_t(a), _t(b)).numpy()
    want = np.asarray(jops.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "grid"])
@pytest.mark.parametrize("n,m", [(64, 16), (48, 40), (16, 16), (8, 12)])
def test_fps_matches(kind, n, m):
    rng = np.random.default_rng(1)
    xyz = _cloud(rng, 3, n, kind)
    got = pointops.farthest_point_sampling(_t(xyz), m).numpy()
    want = np.asarray(jops.farthest_point_sampling_xla(jnp.asarray(xyz), m))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_gather_points_matches_and_clamps():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 20, 5)).astype(np.float32)
    idx = rng.integers(0, 20, (2, 6, 4)).astype(np.int32)
    got = pointops.gather_points(_t(pts), _t(idx)).numpy()
    want = np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    # out of range: clamped to [0, N), as the TPU kernel does (the JAX XLA
    # version wraps negatives and fills NaN past the end instead)
    bad = np.array([[-3, 0, 19, 25]] * 2, np.int32)
    got = pointops.gather_points(_t(pts), _t(bad)).numpy()
    want = np.take_along_axis(pts, np.clip(bad, 0, 19)[..., None], axis=1)
    np.testing.assert_array_equal(got, want)


def _ball_query_agrees(xyz, new_xyz, radius, got, want):
    """Indices identical except where a point sits within 1e-5 of r^2."""
    r2 = np.float32(radius * radius)
    d2p = pointops.pairwise_sqdist(_t(new_xyz), _t(xyz)).numpy()
    d2j = np.asarray(jops.pairwise_sqdist(jnp.asarray(new_xyz), jnp.asarray(xyz)))
    flip = (d2p < r2) != (d2j < r2)
    assert np.all(np.abs(d2p[flip] - r2) <= 1e-5)
    same_rows = ~flip.any(axis=-1)
    np.testing.assert_array_equal(got[same_rows], want[same_rows])


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "grid"])
@pytest.mark.parametrize("radius,k", [(0.1, 4), (0.25, 8), (0.5, 16), (2.0, 80)])
def test_ball_query_matches(kind, radius, k):
    rng = np.random.default_rng(3)
    xyz = _cloud(rng, 2, 64, kind)
    new_xyz = xyz[:, :16]
    got = pointops.ball_query(_t(xyz), _t(new_xyz), radius, k).numpy()
    want = np.asarray(jops.ball_query_xla(jnp.asarray(xyz), jnp.asarray(new_xyz), radius, k))
    assert got.dtype == np.int32 and got.shape == (2, 16, k)
    _ball_query_agrees(xyz, new_xyz, radius, got, want)


def test_ball_query_empty_ball_is_zero():
    xyz = np.zeros((1, 8, 3), np.float32)
    new_xyz = np.ones((1, 2, 3), np.float32)
    got = pointops.ball_query(_t(xyz), _t(new_xyz), 0.1, 4).numpy()
    np.testing.assert_array_equal(got, np.zeros((1, 2, 4), np.int32))


@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_ball_query_pair_matches(kind):
    rng = np.random.default_rng(4)
    xyz = _cloud(rng, 2, 64, kind)
    new_xyz = xyz[:, :16]
    got = pointops.ball_query_pair(_t(xyz), _t(new_xyz), 0.2, 4, 0.5, 8)
    want = jops.ball_query_pair(jnp.asarray(xyz), jnp.asarray(new_xyz), 0.2, 4, 0.5, 8)
    for g, w, r in zip(got, want, (0.2, 0.5)):
        _ball_query_agrees(xyz, new_xyz, r, g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_features", [True, False])
def test_group_points_matches(with_features):
    rng = np.random.default_rng(5)
    xyz = rng.random((2, 32, 3), dtype=np.float32)
    new_xyz = xyz[:, :8]
    feats = rng.standard_normal((2, 32, 6)).astype(np.float32) if with_features else None
    idx = rng.integers(0, 32, (2, 8, 4)).astype(np.int32)
    got = pointops.group_points(_t(xyz), _t(new_xyz), None if feats is None else _t(feats),
                                _t(idx)).numpy()
    want = np.asarray(jops.group_points(jnp.asarray(xyz), jnp.asarray(new_xyz),
                                        None if feats is None else jnp.asarray(feats),
                                        jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "grid"])
def test_three_nn_matches(kind):
    rng = np.random.default_rng(6)
    q, s = _cloud(rng, 2, 40, kind), _cloud(rng, 2, 12, kind)
    gd, gi = pointops.three_nn(_t(q), _t(s))
    wd, wi = jops.three_nn_xla(jnp.asarray(q), jnp.asarray(s))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=VALUE_TOL)


def test_three_interpolate_matches():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 12, 16)).astype(np.float32)
    idx = rng.integers(0, 12, (2, 30, 3)).astype(np.int32)
    w = rng.random((2, 30, 3), dtype=np.float32)
    w /= w.sum(-1, keepdims=True)
    got = pointops.three_interpolate(_t(feats), _t(idx), _t(w)).numpy()
    want = np.asarray(jops.three_interpolate(jnp.asarray(feats), jnp.asarray(idx),
                                             jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches(bias):
    rng = np.random.default_rng(8)
    params = {"weight": rng.standard_normal((7, 5)).astype(np.float32) / 3}
    if bias:
        params["bias"] = rng.standard_normal(7).astype(np.float32)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    got = linear({k: _t(v) for k, v in params.items()}, _t(x)).numpy()
    want = np.asarray(jcore.linear({k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("shape", [(2, 32), (2, 10, 32), (3, 4, 5, 64)])
def test_group_norm_matches(shape):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    params = {"weight": rng.standard_normal(c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    got = group_norm({k: _t(v) for k, v in params.items()}, _t(x), 16).numpy()
    want = np.asarray(jcore.group_norm({k: jnp.asarray(v) for k, v in params.items()},
                                       jnp.asarray(x), 16))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


def test_standard_normal_logprob_matches():
    z = np.linspace(-4, 4, 33, dtype=np.float32)
    got = sampling.standard_normal_logprob(_t(z)).numpy()
    want = np.asarray(jsampling.standard_normal_logprob(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_TOL)


def test_sampling_laws():
    """The generators differ from JAX's, so the laws are checked instead:
    moments of N(0,1) and of N(0,1) truncated to +-1 (std 0.5396) within
    5 standard errors at 60000 samples, and sphere points at the radius."""
    g = torch.Generator().manual_seed(0)
    z = sampling.sample_gaussian(g, (20000, 3))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    t = sampling.sample_gaussian(g, (20000, 3), truncate_std=1.0)
    assert float(t.abs().max()) <= 1.0
    assert abs(float(t.mean())) < 0.005 and abs(float(t.std()) - 0.5396) < 0.005
    s = sampling.sphere_surface_points(g, 1000, radius=0.3)
    np.testing.assert_allclose(torch.linalg.vector_norm(s, dim=1).numpy(), 0.3, rtol=1e-6)


@pytest.mark.parametrize("dims", [(32, 32), (32, 32, 32)])
def test_cnf_primal_matches(dims):
    """The fused decoder dynamics as the port computes them on the CPU (the
    kernel wrapper's plain version, from context_gb and the packed weights)
    and the unfused stack, against the JAX package's XLA composition.
    1e-5 abs: (y W^T) g + (b g + hb) regroups (y W^T + b) g + hb, and the
    softplus layers carry that rounding through up to four layers."""
    rng = np.random.default_rng(10)
    zdim, h = 10, dims[0]
    layers, d_in = [], 3
    for d_out in dims + (3,):
        layers.append({
            "_layer": {"weight": (rng.uniform(-1, 1, (d_out, d_in)) / np.sqrt(d_in)).astype(np.float32),
                       "bias": rng.standard_normal(d_out).astype(np.float32)},
            "_hyper_bias": {"weight": (rng.standard_normal((d_out, 1 + zdim)) / 3).astype(np.float32)},
            "_hyper_gate": {"weight": (rng.standard_normal((d_out, 1 + zdim)) / 3).astype(np.float32),
                            "bias": rng.standard_normal(d_out).astype(np.float32)},
        })
        d_in = d_out
    tc = rng.standard_normal((3, 1 + zdim)).astype(np.float32)
    y = rng.standard_normal((3, 20, 3)).astype(np.float32)
    jparams = {"layers": [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in lp.items()}
                          for lp in layers]}
    want = np.asarray(jcnf_fused._reference_primal(jparams, jnp.asarray(tc), jnp.asarray(y)))
    params = {"layers": [{k: {kk: _t(vv) for kk, vv in v.items()} for k, v in lp.items()}
                         for lp in layers]}
    gb = cnf_fused.context_gb(params, _t(tc))
    assert gb.shape == (3, max(8, 2 * len(layers)), h)
    fused = kernels.cnf_primal(_t(y), gb, *cnf_fused.pack_weights(params)).numpy()
    unfused = cnf_fused.reference_primal(params, _t(tc), _t(y)).numpy()
    np.testing.assert_allclose(fused, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(unfused, want, rtol=0, atol=1e-5)
