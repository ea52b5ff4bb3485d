"""The index arithmetic of the ball-query and interpolation kernels,
modelled on the CPU (caspr_tpu_torch/checks/ball_interp_arithmetic.py).

csrc/ball_query.cu scans a centroid's sources with one warp, 32 a step,
up to 4 centroids a warp at once: ballot masks (on the larger radius first,
on the smaller only in a step with a hit), popcount ranks, chunks of the
cloud staged in shared memory with +inf past its end, an early exit once
every list is full and the first hit as padding.  The model of that scan,
with each group size and the host's assignment of centroids to warps, must
give the plain version's indices and the JAX
package's (its XLA ball query and its Pallas kernels in interpret mode),
identically: empty balls, balls that fill in the first step, hits at lanes
0 and 31 and across 32- and chunk boundaries, K > N, one radius (K2 = 0),
duplicated points, a source exactly at r^2 (out: the compare is strict),
and N from 1 past one chunk.

csrc/three_interpolate.cu gives each query row a warp whose lanes walk the
channels as float4 pieces (C % 4 == 0, 16-byte aligned bases) or one float
at a time; the model of that walk must write every output float once,
bit-equal (torch.equal) to the plain version for C from 1 to 1030 with
out-of-range indices clamped.  Against the JAX package's interpolation (XLA
here, and its lane-shuffle Pallas kernel in interpret mode) the bar is
1e-6: each output is a float32 sum of three products, which XLA may group
or contract into fused multiply-adds, a few ulps of values of order 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.ops import pointops as jops
from caspr_tpu.ops.pallas_kernels import (ball_query_pair_pallas, ball_query_pallas,
                                          three_interpolate_shuf)
from caspr_tpu_torch.checks import ball_interp_arithmetic as model
from caspr_tpu_torch.ops import pointops

CHUNK = 64  # the model's chunk in most cases: a few chunks at small N


def _case(kind, rng):
    """(xyz (B, N, 3), centers (B, M, 3), r1, k1, r2, k2, chunk) float32."""
    if kind == "uniform":
        xyz = rng.random((2, 300, 3), dtype=np.float32)
        return xyz, xyz[:, :12].copy(), 0.2, 8, 0.35, 16, CHUNK
    if kind == "empty":  # every source far from every centroid
        xyz = rng.random((2, 100, 3), dtype=np.float32)
        return xyz, xyz[:, :6] + np.float32(5.0), 0.2, 8, 0.4, 16, CHUNK
    if kind == "fill_first_step":  # every source inside: both lists full at the first step
        xyz = rng.random((2, 200, 3), dtype=np.float32) * np.float32(0.01)
        return xyz, xyz[:, :6].copy(), 0.5, 8, 1.0, 32, CHUNK
    if kind == "lane_edges":  # hits only at lanes 0 and 31, and across 32- and chunk boundaries
        xyz = np.full((1, 260, 3), 3.0, np.float32)
        hits = [0, 31, 32, 63, 64, 95, 127, 128, 191, 192, 255]
        xyz[0, hits] = rng.random((len(hits), 3), dtype=np.float32) * np.float32(0.01)
        centers = np.zeros((1, 4, 3), np.float32)
        return xyz, centers, 0.1, 4, 0.2, 9, CHUNK
    if kind == "k_above_n":
        xyz = rng.random((2, 20, 3), dtype=np.float32)
        return xyz, xyz[:, :5].copy(), 0.5, 40, 2.0, 64, CHUNK
    if kind == "one_radius":  # K2 = 0: kernels.ball_query's form
        xyz = rng.random((2, 150, 3), dtype=np.float32)
        return xyz, xyz[:, :10].copy(), 0.3, 12, 0.0, 0, CHUNK
    if kind == "duplicated":  # every point several times: equal distances
        base = rng.random((2, 40, 3), dtype=np.float32)
        xyz = base[:, rng.integers(0, 40, 240)]
        return xyz, base[:, :8].copy(), 0.25, 8, 0.4, 16, CHUNK
    if kind == "exact_r2":  # sources at exactly r (r^2 exact in float32) and just inside
        r = np.float32(0.25)
        inside = np.nextafter(r, np.float32(0.0))
        pts = [[r, 0, 0], [0, -r, 0], [0, 0, r], [inside, 0, 0], [0, 0, -inside],
               [0.5, 0.5, 0.5], [r, 0, 0]]
        xyz = np.tile(np.array(pts, np.float32)[None], (1, 10, 1))
        centers = np.zeros((1, 3, 3), np.float32)
        return xyz, centers, 0.25, 6, 0.5, 12, 32
    raise ValueError(kind)


CASES = ["uniform", "empty", "fill_first_step", "lane_edges", "k_above_n", "one_radius",
         "duplicated", "exact_r2"]


def _plain(xyz, centers, r1, k1, r2, k2):
    xyz_t, cen_t = torch.from_numpy(xyz), torch.from_numpy(centers)
    if k2 == 0:
        return [pointops.ball_query(xyz_t, cen_t, r1, k1).numpy()]
    return [t.numpy() for t in pointops.ball_query_pair(xyz_t, cen_t, r1, k1, r2, k2)]


def _model(xyz, centers, r1, k1, r2, k2, chunk, **kw):
    """The model's lists ([list 1] for k2 = 0) and steps."""
    out1, out2, steps = model.ball_query_model(xyz, centers, pointops.radius_sq(r1), k1,
                                               pointops.radius_sq(r2), k2, chunk, **kw)
    return ([out1, out2] if k2 else [out1]), steps


# resident warps: the card's (one centroid a warp here), and so few that a
# warp takes 2 or 8 centroids, in groups of 2 or 4
RESIDENT = {"groups_of_1": model.RESIDENT_WARPS, "groups_of_2": 8, "groups_of_4": 1}


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("kind", CASES)
def test_ball_scan_model_matches_plain_and_jax_xla(kind, resident):
    rng = np.random.default_rng(sum(map(ord, kind)))
    xyz, centers, r1, k1, r2, k2, chunk = _case(kind, rng)
    got, steps = _model(xyz, centers, r1, k1, r2, k2, chunk, resident_warps=RESIDENT[resident])
    want = _plain(xyz, centers, r1, k1, r2, k2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if k2:
        jax_lists = jops.ball_query_pair(jnp.asarray(xyz), jnp.asarray(centers), r1, k1, r2, k2)
    else:
        jax_lists = [jops.ball_query_xla(jnp.asarray(xyz), jnp.asarray(centers), r1, k1)]
    for g, w in zip(got, jax_lists):
        np.testing.assert_array_equal(g, np.asarray(w))
    n = xyz.shape[1]
    all_steps = sum(-(-min(chunk, n - s) // 32) for s in range(0, n, chunk))
    if kind == "fill_first_step":
        assert (steps == 1).all()
    if kind == "empty":
        assert (steps == all_steps).all() and (got[0] == 0).all() and (got[1] == 0).all()
    if kind == "exact_r2":  # the points at exactly r are out, those just inside in
        assert set(np.unique(got[0]).tolist()) == {3, 4, 10, 11, 17, 18}


@pytest.mark.parametrize("kind", CASES)
def test_ball_scan_model_matches_the_pallas_kernels(kind):
    """ball_query_pair_pallas (ball_query_pallas for K2 = 0) in interpret
    mode, as tests/test_pallas_kernels.py runs them."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    xyz, centers, r1, k1, r2, k2, chunk = _case(kind, rng)
    got, _ = _model(xyz, centers, r1, k1, r2, k2, chunk, resident_warps=1)
    with pltpu.force_tpu_interpret_mode():
        if k2:
            want = ball_query_pair_pallas(jnp.asarray(xyz), jnp.asarray(centers), r1, k1, r2, k2)
        else:
            want = [ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), r1, k1)]
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 2047, 2049, CHUNK - 1, CHUNK + 1,
                               model.KERNEL_CHUNK - 1, model.KERNEL_CHUNK + 1])
def test_ball_scan_model_at_cloud_sizes(n):
    """The kernel's chunk (4096) and the test's (64); radii so that some
    balls fill early and some never do."""
    rng = np.random.default_rng(n)
    xyz = rng.random((1, n, 3), dtype=np.float32)
    centers = np.concatenate([xyz[:, :3], rng.random((1, 3, 3), dtype=np.float32)], axis=1)
    r1, r2 = (0.1, 0.3) if n > 64 else (0.3, 0.6)
    want = _plain(xyz, centers, r1, 8, r2, 32)
    for chunk in sorted({CHUNK, model.kernel_chunk(n)}):
        got, _ = _model(xyz, centers, r1, 8, r2, 32, chunk, resident_warps=2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jax_lists = jops.ball_query_pair(jnp.asarray(xyz), jnp.asarray(centers), r1, 8, r2, 32)
    for g, w in zip(want, jax_lists):
        np.testing.assert_array_equal(g, np.asarray(w))
    if n <= 2049:
        with pltpu.force_tpu_interpret_mode():
            pallas = ball_query_pair_pallas(jnp.asarray(xyz), jnp.asarray(centers), r1, 8, r2, 32)
        for g, w in zip(want, pallas):
            np.testing.assert_array_equal(g, np.asarray(w))


# the reconstruct's five levels (the card's resident warps), a cloud of
# 16384 sources, and small cases
@pytest.mark.parametrize("b, m, resident", [(40, 1024, model.RESIDENT_WARPS),
                                            (40, 512, model.RESIDENT_WARPS),
                                            (40, 256, model.RESIDENT_WARPS),
                                            (40, 64, model.RESIDENT_WARPS),
                                            (40, 16, model.RESIDENT_WARPS),
                                            (4, 1024, model.RESIDENT_WARPS),
                                            (1, 1, 8), (3, 1000, 16), (2, 77, 40)])
def test_ball_blocks_cover_every_centroid_once(b, m, resident):
    per_warp, group, tile, blocks = model.ball_block_shape(b, m, resident)
    assert 1 <= per_warp <= model.MAX_PER_WARP and tile == model.WARPS * per_warp
    assert group in (1, 2, 4) and per_warp % group == 0
    slots = [c for blk in range(blocks) for w in range(model.WARPS)
             for c in model.block_centroids(blk, w, per_warp)]
    assert sorted(c for c in slots if c < m) == list(range(m))
    assert len(slots) - m < tile  # the slots past M are fewer than one block's
    if b * m >= resident * model.MAX_PER_WARP:
        assert per_warp == model.MAX_PER_WARP
    else:  # about one wave: no more warps than the card holds, unless few centroids each
        want = -(-(b * m) // resident)
        assert want <= per_warp < want + group
    if (b, m) == (40, 1024):  # level 1: groups of 4, two per warp
        assert (per_warp, group, blocks) == (8, 4, 16)


def test_kernel_chunk_is_a_warp_multiple():
    for n in (1, 31, 32, 33, 2048, 4095, 4096, 4097, 16384):
        chunk = model.kernel_chunk(n)
        assert chunk % 32 == 0 and chunk >= min(n, model.KERNEL_CHUNK)
        assert chunk <= model.KERNEL_CHUNK
    with pytest.raises(ValueError):
        model.scan_group(np.zeros((4, 3), np.float32), np.zeros((1, 3), np.float32), [True],
                         1.0, 2, 0.0, 0, 48)


def test_radii_in_either_order():
    """The kernel's first ballot is on the larger radius, whichever list it
    fills: r1 > r2 gives the same lists as the plain version too."""
    rng = np.random.default_rng(11)
    xyz = rng.random((2, 200, 3), dtype=np.float32)
    centers = xyz[:, :10].copy()
    got, _ = _model(xyz, centers, 0.4, 12, 0.15, 6, CHUNK, resident_warps=1)
    for g, w in zip(got, _plain(xyz, centers, 0.4, 12, 0.15, 6)):
        np.testing.assert_array_equal(g, w)


# C from 1 to 1030: odd widths, around the float4 walk and the warp's 128 floats
WIDTHS = (1, 2, 3, 4, 5, 7, 8, 12, 31, 33, 64, 127, 128, 129, 255, 256, 511, 512, 513,
          1023, 1024, 1029, 1030)


def _interp_inputs(rng, b, m, n, c, lo=-2, hi=None):
    feats = rng.standard_normal((b, m, c)).astype(np.float32)
    idx = rng.integers(lo, m + 2 if hi is None else hi, (b, n, 3)).astype(np.int32)
    w = rng.random((b, n, 3), dtype=np.float32)
    w /= w.sum(-1, keepdims=True)
    return feats, idx, w


@pytest.mark.parametrize("c", WIDTHS)
def test_interpolation_walk_is_bit_exact(c):
    """Indices below 0 and at or above M (clamped); N = 21 rows, no multiple
    of a block's 8; every misalignment of the bases (the scalar walk)."""
    rng = np.random.default_rng(c)
    feats, idx, w = _interp_inputs(rng, 2, 13, 21, c)
    want = pointops.three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx),
                                      torch.from_numpy(w))
    for f_off, o_off in ((0, 0), (1, 0), (0, 2), (3, 3)):
        got, writes = model.interpolate_model(feats, idx, w, f_off, o_off)
        assert (writes == 1).all()
        assert torch.equal(torch.from_numpy(got), want), (c, f_off, o_off)
    assert model.interp_vectorised(c) == (c % 4 == 0)


@pytest.mark.parametrize("c", [1, 16, 33, 512])
def test_interpolation_walk_matches_jax(c):
    """The JAX package's XLA interpolation and its lane-shuffle Pallas kernel
    (interpret mode) at small sizes, indices in range: within 1e-6."""
    rng = np.random.default_rng(50 + c)
    feats, idx, w = _interp_inputs(rng, 2, 12, 30, c, lo=0, hi=12)
    got, _ = model.interpolate_model(feats, idx, w)
    args = (jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(jops.three_interpolate(*args)), rtol=0, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        shuf = np.asarray(three_interpolate_shuf(*args))
    np.testing.assert_allclose(got, shuf, rtol=0, atol=1e-6)
