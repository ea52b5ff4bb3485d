"""The arithmetic of the three_nn and sa_fused kernels, modelled on the CPU
(caspr_tpu_torch/checks/three_nn_sa_arithmetic.py).

csrc/three_nn.cu splits each query's sources over S lanes (a strided
share each, scanned in index order with a strict insertion), pads each
staged chunk to a multiple of S with NaN coordinates and merges the S
best-three lists by a shuffle butterfly in (distance, index) order.  The
model of that split and merge must give the plain version's indices and
distances identically, and the JAX package's three_nn_xla's, for S from 1
to 32 and several chunk sizes, on uniform clouds, clouds of duplicated
points and clouds on a grid (equal distances everywhere), with Ns from 3
to about 5000 and at (4, 16384) sources.

csrc/sa_fused.cu tiles the flattened B x M balls, runs conv2 and conv3 as
3xTF32 products and takes GroupNorm's statistics in double in a fixed
order.  The model of that arithmetic, tile by tile, must stay within the
kernel's bar of the float64 plain version (1e-4 of each output's largest
magnitude) at every instantiation's shape, with a ragged last tile, balls
of one point (where a group's variance is exactly 0) and balls past the
end of a tile; it must agree with the JAX package's v3 Pallas kernel
(fused_sa_scale3, in interpret mode) at the JAX package's own 2e-4; its
sums of K copies of one value must be exact; and its max-or-min shortcut
for GN3 must equal the max over the ball of GN3's affine bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.ops import pointops as jops
from caspr_tpu.ops import sa_fused2 as jsa2
from caspr_tpu.ops.pointops import ball_query_xla
from caspr_tpu_torch.checks import three_nn_sa_arithmetic as model
from caspr_tpu_torch.ops import pointops, sa_fused

SPLITS = [1, 2, 4, 8, 16, 32]
KINDS = ["uniform", "duplicated", "grid"]


def _cloud(rng, b, n, kind):
    if kind == "uniform":
        return rng.random((b, n, 3), dtype=np.float32)
    if kind == "duplicated":  # every point about four times, shuffled: exact ties
        base = rng.random((b, max(1, n // 4), 3), dtype=np.float32)
        return base[:, rng.integers(0, base.shape[1], n)]
    return (rng.integers(0, 5, (b, n, 3)) / 4.0).astype(np.float32)  # a 1/4 grid


def _three_nn_agrees(q, src, **kw):
    dist, idx = model.three_nn_model(q, src, **kw)
    wd, wi = pointops.three_nn(torch.from_numpy(q), torch.from_numpy(src))
    np.testing.assert_array_equal(idx, wi.numpy())
    np.testing.assert_array_equal(dist.view(np.uint32), wd.numpy().view(np.uint32))
    jd, ji = jops.three_nn_xla(jnp.asarray(q), jnp.asarray(src))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(dist, np.asarray(jd))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", SPLITS)
def test_three_nn_split_and_merge(s, kind):
    """Ns from 3 up, not multiples of S or of the chunk, chunks of 64 and
    the kernel's 2048: identical to the plain version and to JAX."""
    rng = np.random.default_rng(s)
    for ns, chunk in ((3, 64), (5, 64), (37, 64), (300, 64), (2049, model.CHUNK)):
        q = np.concatenate([_cloud(rng, 2, 12, kind),
                            _cloud(rng, 2, ns, kind)[:, : min(ns, 8)]], axis=1)
        _three_nn_agrees(q, _cloud(rng, 2, ns, kind), s=s, chunk=chunk)


@pytest.mark.parametrize("kind", KINDS)
def test_three_nn_at_five_thousand_sources(kind):
    """About 5000 sources in three chunks of 2048, with the split the
    kernel takes for these queries and with S = 1 (one lane scans all)."""
    rng = np.random.default_rng(50)
    q, src = _cloud(rng, 1, 24, kind), _cloud(rng, 1, 4999, kind)
    for s in (model.three_nn_split(1, 24), 1):
        _three_nn_agrees(q, src, s=s)


def test_three_nn_at_sixteen_thousand_sources():
    """(4, 16384) sources, eight chunks, S = 32 (what the kernel takes for
    4 x 1024 queries)."""
    rng = np.random.default_rng(16)
    assert model.three_nn_split(4, 1024) == 32
    _three_nn_agrees(rng.random((4, 16, 3), dtype=np.float32),
                     rng.random((4, 16384, 3), dtype=np.float32), s=32)


@pytest.mark.parametrize("s", [1, 4, 32])
def test_three_nn_ties_across_lanes(s):
    """Several sources at one distance, in the lists of different lanes and
    of one lane, more than three of them: the merge keeps the three lowest
    indices, in order."""
    q = np.zeros((1, 1, 3), np.float32)
    src = np.full((1, 100, 3), 2.0, np.float32)
    src[0, [70, 5, 40, 6, 99, 36]] = [1.0, 0.0, 0.0]  # six sources at distance 1
    dist, idx = model.three_nn_model(q, src, s=s)
    np.testing.assert_array_equal(idx, [[[5, 6, 36]]])
    np.testing.assert_array_equal(dist, [[[1.0, 1.0, 1.0]]])
    _three_nn_agrees(q, src, s=s)


def test_three_nn_padding_never_wins():
    """A chunk padded with NaN coordinates: the padding's key sits above
    every real distance, +inf included, and below no real source, so with
    Ns = 3 and S = 32 the three real sources come out, in order."""
    assert model.PAD.view(np.uint32) == 0x7FFFFFFF
    assert np.float32(np.inf).view(np.uint32) < model.PAD.view(np.uint32) < model.NO_KEY
    q = np.zeros((1, 2, 3), np.float32)
    s = np.array([[[3e19, 0, 0], [1, 0, 0], [2, 0, 0]]], np.float32)  # 9e38 rounds to +inf
    with np.errstate(over="ignore"):
        dist, idx = model.three_nn_model(q, s, s=32)
    np.testing.assert_array_equal(idx, [[[1, 2, 0]] * 2])
    assert np.isinf(dist[..., 2]).all()


def test_three_nn_split_per_level():
    """The reconstruct's five levels (40 clouds): 8 lanes a query at level
    1, 16 at level 2, 32 below; always a power of two within a warp."""
    assert [model.three_nn_split(40, nq) for nq in (2048, 1024, 512, 256, 64)] == [8, 16, 32, 32, 32]
    for b, nq in ((1, 1), (600, 2048), (40, 4096)):
        s = model.three_nn_split(b, nq)
        assert s in SPLITS and (s == 1 or -(-b * nq // model.Q) * (s // 2) < model.WAVE_THREADS)


# ------------------------------------------------------------------- sa_fused


def _sa_inputs(b, n, m, k, dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    d1 = dims[0]
    t = torch.randn((b, n, d1), generator=g)
    u = 0.5 * torch.randn((b, m, d1), generator=g)
    gidx = torch.randint(-2, n + 3, (b, m, k), generator=g, dtype=torch.int32)
    ins = (9,) + tuple(dims)
    sp = {"convs": [{"weight": torch.randn((d, ins[i]), generator=g) / ins[i] ** 0.5,
                     "bias": 0.1 * torch.randn((d,), generator=g)} for i, d in enumerate(dims)],
          "norms": [{"weight": 1.0 + 0.3 * torch.randn((d,), generator=g),
                     "bias": 0.1 * torch.randn((d,), generator=g)} for d in dims]}
    return t, u, gidx, sp


def _float64(sp):
    return {part: [{key: v.double() for key, v in layer.items()} for layer in layers]
            for part, layers in sp.items()}


def _rel_to_float64(got, t, u, gidx, sp):
    want = sa_fused.sa_stack_plain(t.double(), u.double(), gidx, _float64(sp))
    return float((got.double() - want).abs().max() / want.abs().max())


SA_SHAPES = list(model.SHAPES) + [(5, 64, 96, 128), (1, 16, 16, 16), (17, 48, 80, 496)]


@pytest.mark.parametrize("shape", SA_SHAPES)
def test_sa_model_within_the_bar_of_float64(shape):
    """Every instantiation's tiling (2 x 11 centres: a ragged last tile for
    each) within 1e-4 of the float64 plain version's largest output."""
    k, *dims = shape
    args = _sa_inputs(2, 64, 11, k, dims, seed=k)
    assert _rel_to_float64(model.sa_fused_model(*args), *args) <= 1e-4


def test_sa_configs_fit_and_cover_the_encoder():
    """Each of the nine encoder shapes has its instantiation, with at least
    64 rows a tile and room for two blocks an SM where the convs are at
    most 128 wide; every shape fits the block's shared memory, the generic
    one at the widest; GN1's team divides the block."""
    for i, shape in enumerate(model.SHAPES):
        cfg = model.sa_config(*shape)
        assert cfg.instance == i + 1 and cfg.rows >= 64 and cfg.rows % cfg.kp == 0
        assert cfg.smem_bytes <= model.SMEM_LIMIT
        if max(shape[2:]) <= 128:
            assert 2 * (cfg.smem_bytes + 1024) <= 228 * 1024, shape
        assert cfg.team * cfg.balls * 16 == model.THREADS
    generic = model.sa_config(32, 512, 512, 512)
    assert generic.instance == 0 and generic.smem_bytes <= model.SMEM_LIMIT
    for bad in ((33, 16, 16, 16), (16, 24, 16, 16), (16, 16, 16, 528)):
        with pytest.raises(ValueError):
            model.sa_config(*bad)


def test_sa_tiles_are_independent_of_the_tiling():
    """A centre's output does not depend on its tile: the tile-by-tile
    model equals one tile of each single centre, bit for bit, for balls in
    every position of a ragged last tile and across clouds."""
    args = _sa_inputs(3, 40, 7, 16, (16, 16, 32), seed=5)  # 21 balls: tiles of 16 and 5
    t, u, gidx, sp = args
    whole = model.sa_fused_model(*args).reshape(21, -1)
    cfg = model.sa_config(16, 16, 16, 32)
    for c in (0, 6, 7, 15, 16, 20):
        one = model.sa_tile_model(t, u, gidx, sp, cfg, torch.tensor([c]))
        assert torch.equal(one[0], whole[c]), c


@pytest.mark.parametrize("shape", [(16, 16, 16, 32), (32, 32, 32, 64), (5, 64, 96, 128)])
def test_sa_model_balls_of_one_point(shape):
    """Every member of a ball the same source (radius 0.02 at level 1): GN1
    and, at width 16, GN2 see groups of copies of one value, whose sums are
    exact (mean = the value, variance exactly 0); the output stays within
    the bar, and within it also for balls of two points close together."""
    k, *dims = shape
    t, u, gidx, sp = _sa_inputs(2, 64, 11, k, dims, seed=2)
    t = 0.02 * t + t[:, :1]
    one = gidx[..., :1].clamp(0, 63).expand(-1, -1, k).contiguous()
    two = torch.where(torch.arange(k) < max(1, k // 3), one, (one + 1) % 64).contiguous()
    for idx in (one, two):
        assert _rel_to_float64(model.sa_fused_model(t, u, idx, sp), t, u, idx, sp) <= 1e-4
    x = (t[0, one[0, :, 0].long()] - u[0]).double()[:, None, :].expand(-1, k, -1)
    s1, s2 = model.first_norm_stats(x.contiguous(), k, model.sa_config(*shape).team)
    cg = dims[0] // 16
    if cg == 1:
        mean, _ = model._moments(s1, s2, k)
        assert torch.equal(mean, x[:, 0, :].reshape(-1, 16, 1)[..., 0])
        assert torch.equal(s2 / k - mean * mean, torch.zeros_like(mean))


@pytest.mark.parametrize("k", [1, 5, 16, 17, 32])
@pytest.mark.parametrize("d", [16, 32, 48, 96, 512])
def test_sa_statistics_sum_order(k, d):
    """The epilogue's sums (the thread's rows, column pairs, the row-lane
    butterfly, the group's columns): K copies of one float32 value per
    column give the exact sums and a variance of exactly 0 where a group
    is one column; random values agree with math.fsum within a few ulps
    of double."""
    kp = 16 if k <= 16 else 32
    rng = np.random.default_rng(k * d)
    row = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    copies = row.expand(3, kp, d).contiguous()
    s1, s2 = model.group_stats_from_rows(copies, k)
    cg = d // 16
    want1 = row.double().reshape(16, cg).sum(-1) * k if cg <= 2 else None
    if want1 is not None:
        assert torch.equal(s1[0], want1)
    if cg == 1:
        mean, _ = model._moments(s1, s2, k)
        assert torch.equal(s2 / k - mean * mean, torch.zeros_like(mean))
    v = torch.from_numpy(rng.standard_normal((3, kp, d)).astype(np.float32))
    s1, s2 = model.group_stats_from_rows(v, k)
    vals = v[:, :k].double().reshape(3, k, 16, cg)
    for ball in range(3):
        for grp in range(16):
            xs = vals[ball, :, grp].flatten().tolist()
            assert math.isclose(float(s1[ball, grp]), math.fsum(xs), rel_tol=1e-13, abs_tol=1e-13)
            assert math.isclose(float(s2[ball, grp]), math.fsum(x * x for x in xs), rel_tol=1e-13)


def test_sa_gn3_max_or_min_is_the_max_of_the_affine():
    """GN3's affine is monotonic in h, rising or falling with the sign of
    gamma, and every rounded step of it too: f(max h) or f(min h) equals
    the max over the ball of f(h) bit for bit, gamma of either sign or 0."""
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.standard_normal((50, 32, 64)).astype(np.float32))
    gamma = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    gamma[:4] = 0.0
    beta = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    mean = torch.from_numpy(rng.standard_normal((50, 1, 64)))
    rstd = torch.from_numpy(rng.random((50, 1, 64)) * 300 + 0.1)
    consts = model.norm_consts(mean, rstd)
    direct = model._affine(v, *consts, gamma, beta).amax(dim=1)
    ext = torch.where(gamma >= 0, v.amax(dim=1, keepdim=True), v.amin(dim=1, keepdim=True))
    assert torch.equal(model._affine(ext, *consts, gamma, beta)[:, 0], direct)


@pytest.mark.parametrize("din", [16, 64, 256])
def test_sa_conv_tf32x3_is_float32_class(din):
    """The 3xTF32 conv (fresh sum per K-slice of 8) against float64: about
    float32's error, far below a single TF32 pass's."""
    rng = np.random.default_rng(din)
    a = torch.from_numpy(rng.standard_normal((300, din)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, din)) / din ** 0.5).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    exact = a.double() @ w.double().T + bias.double()
    err = float((model.conv_tf32x3(a, w, bias).double() - exact).abs().max() / exact.abs().max())
    f32 = float(((a @ w.T + bias).double() - exact).abs().max() / exact.abs().max())
    assert err <= 4 * max(f32, 2 ** -24), (err, f32)


JAX_CASES = {  # b, n, m, k, features, dims, cloud size, radius
    "generic": (2, 64, 16, 8, 5, (16, 16, 32), 1.0, 0.4),
    "level1_k16": (1, 128, 32, 16, 6, (16, 16, 32), 0.15, 0.05),
    "level1_k32": (1, 128, 32, 32, 6, (32, 32, 64), 0.15, 0.05),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_sa_model_matches_the_jax_v3_kernel(case):
    """The model on the port's factored t and u against the JAX package's
    fused_sa_scale3 in interpret mode, at its own bar (2e-4), on balls from
    its XLA ball query."""
    b, n, m, k, c, dims, size, radius = JAX_CASES[case]
    rng = np.random.default_rng(1)
    xyz = (rng.random((b, n, 3), dtype=np.float32) * size).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, :m])
    gidx = np.asarray(ball_query_xla(jnp.asarray(xyz), jnp.asarray(new_xyz), radius, k))
    all_dims = (3 + c,) + dims
    bound = lambda i: 1.0 / np.sqrt(all_dims[i])
    sp = {"convs": [{"weight": rng.uniform(-bound(i), bound(i), (d, all_dims[i])).astype(np.float32),
                     "bias": rng.uniform(-bound(i), bound(i), (d,)).astype(np.float32)}
                    for i, d in enumerate(dims)],
          "norms": [{"weight": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)} for d in dims]}
    jargs = jax.tree_util.tree_map(jnp.asarray, (sp, xyz, feats, new_xyz, gidx))
    assert jsa2.can_fuse_sa3(jargs[0], n, m, k)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsa2.fused_sa_scale3(*jargs, k, 16))
    tsp, txyz, tfeats, tnew, tgidx = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), (sp, xyz, feats, new_xyz, gidx))
    t, u = sa_fused.factors(tsp, txyz, tfeats, tnew)
    got = model.sa_fused_model(t.contiguous(), u.contiguous(), tgidx, tsp)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_encoder_sa_calls_are_captured_and_checked():
    """checks/encoder_kernels.py, which chip_smoke.py's phase 2 and the A/B
    runs use on the card: an sa_impl="fused" encode makes ten sa_fused
    calls; each is checked against float64 and timed (here the wrapper
    takes the plain version on a CPU tensor, with a stand-in timer)."""
    from caspr_tpu_torch.checks import encoder_kernels
    from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init

    cfg = CaSPRConfig(sa_impl="fused")
    params, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((1, 2, 2048, 4), dtype=np.float32))
    calls = encoder_kernels.capture_sa_calls(params, x)
    assert [tuple(c[2].shape) for c in calls] == [
        (2, m, k) for m in (1024, 512, 256, 64, 16) for k in (16, 32)]
    timer = lambda fn: (fn(), 1.0)[1]
    rates = lambda b, o, s=0.0, tc=0.0: (max(b / 3.35e9, o / 67e9, tc / 495e9), "")
    out = encoder_kernels.measure_sa(calls[-2:], rates, kernel_ms=timer, plain_ms=timer)
    assert out["launches"] == 2 and out["ms_sum"] == 2.0
    assert out["rel_err_vs_float64"] <= 1e-4
    assert out["bound_ms_sum"] < out["f32_bound_ms_sum"]
