"""The port's set-abstraction scales (caspr_tpu_torch/ops/sa_fused.py) and
the encoder's selections (models/pointnet2.py) against the JAX package on
the CPU.  Inputs are numpy arrays from a seed, handed to both packages.

The JAX references run as the JAX package's own tests run them on the CPU: its
``sa_scale_factored`` and ``_xla_reference`` are pure XLA, its Pallas
kernels (``fused_sa_scale3``, v1 ``fused_sa_scale``) run in interpret mode.
On the CPU the port's ``fused_sa_scale`` takes the kernel's plain version.

Tolerances:
  - the port's three forms against the JAX factored scale: 1e-5 abs.  Both
    compute t[idx] - u and the same stack; only the sum orders differ.
    The balls hold several points (radius 0.4 in the unit cube, or 0.05 in
    a 0.15 cube): a ball of copies of one point gives GroupNorm a group whose
    variance is a last-bit rounding residue, which it divides by
    sqrt(var + 1e-5), up to 316x, and XLA and PyTorch sum in other orders;
  - against the Pallas kernels in interpret mode and the unfactored
    composition: 2e-4, the JAX package's own bar (tests/test_sa_fused2.py);
  - the recompute backward against jax.grad of the unfactored composition:
    1e-4 of each leaf's largest magnitude;
  - the backbone (five SA levels, clouds in a 0.15 cube): 1e-4 of the
    output's largest magnitude (2 to 2.6 after the head's conv; the
    unfactored composition of the two packages differs by up to 5e-5 of it
    on these inputs).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import pointnet2 as jpn2
from caspr_tpu.ops import sa_fused as jsa1
from caspr_tpu.ops import sa_fused2 as jsa2
from caspr_tpu.ops.pointops import ball_query_xla
from caspr_tpu_torch.models import pointnet2 as pn2
from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
from caspr_tpu_torch.ops import kernels, sa_fused

CASES = {  # b, n, m, k, features, dims, cloud size, radius
    "features": (2, 64, 16, 8, 5, (16, 16, 32), 1.0, 0.4),
    "no_features": (2, 64, 16, 8, 0, (16, 16, 32), 1.0, 0.4),
    "small_radius": (1, 128, 32, 32, 6, (32, 32, 64), 0.15, 0.05),
}
# The backbone's clouds fill a 0.15 cube (tests/test_torch_port_model.py),
# and its radii start at 0.05, so that every level's balls hold several
# points (see the module docstring): at the default 0.02, a level-1 ball of
# this 128-point cloud holds 1.3 points on average, and the JAX package's
# own factored and fused3 backbones then differ by 2e-3.
CLOUD_SIZE = 0.15
BACKBONE = dict(in_features=6, num_classes=32, max_feat_prop_size=32,
                radii_list=(0.05, 0.08, 0.12, 0.2, 0.4, 0.8),
                sa_points=(64, 32, 16, 8, 8), ball_samples=(16, 32))
BACKBONE_POINTS = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are tiny: on eight threads PyTorch can spend 20x longer in
    its thread pool than in the arithmetic (a backbone 0.9 s against 0.04 s
    on one thread, on an eight-core x86 CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mini_pointnet(rng, c_in, dims):
    all_dims = (c_in,) + tuple(dims)
    bound = lambda i: 1.0 / np.sqrt(all_dims[i])
    return {
        "convs": [{"weight": rng.uniform(-bound(i), bound(i), (d, all_dims[i])).astype(np.float32),
                   "bias": rng.uniform(-bound(i), bound(i), (d,)).astype(np.float32)}
                  for i, d in enumerate(dims)],
        "norms": [{"weight": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)} for d in dims],
    }


def _case(name, seed=0):
    b, n, m, k, c, dims, size, radius = CASES[name]
    rng = np.random.default_rng(seed)
    xyz = (rng.random((b, n, 3), dtype=np.float32) * size).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32) if c else None
    new_xyz = np.ascontiguousarray(xyz[:, :m])
    gidx = np.asarray(ball_query_xla(jnp.asarray(xyz), jnp.asarray(new_xyz), radius, k))
    counts = [len(set(row)) for row in gidx.reshape(-1, k).tolist()]
    assert np.mean(counts) >= 4, counts  # several distinct points per ball
    return _mini_pointnet(rng, 3 + c, dims), xyz, feats, new_xyz, gidx


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(form, sp, xyz, feats, new_xyz, gidx):
    sp, xyz, feats, new_xyz, gidx = _torch((sp, xyz, feats, new_xyz, gidx))
    if form == "stack_plain":
        t, u = sa_fused.factors(sp, xyz, feats, new_xyz)
        return sa_fused.sa_stack_plain(t, u, gidx, sp)
    if form == "factored":
        return sa_fused.sa_scale_factored(sp, xyz, feats, new_xyz, gidx)
    return sa_fused.fused_sa_scale(sp, xyz, feats, new_xyz, gidx)


@functools.lru_cache(maxsize=None)
def _jax_factored(case):
    fn = jax.jit(jsa2.sa_scale_factored, static_argnums=5)
    return np.asarray(fn(*_jax(_case(case)), 16))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", ["stack_plain", "factored", "fused"])
def test_scale_matches_jax_factored(form, case):
    got = _port(form, *_case(case))
    np.testing.assert_allclose(got.numpy(), _jax_factored(case), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case,reference", [
    ("features", "fused3"), ("features", "fused_v1"), ("features", "xla_reference"),
    ("small_radius", "xla_reference"),
])
def test_fused_scale_matches_the_pallas_kernels(case, reference):
    sp, xyz, feats, new_xyz, gidx = args = _case(case)
    k = gidx.shape[-1]
    jargs = _jax(args)
    if reference == "xla_reference":
        want = jax.jit(jsa2._xla_reference, static_argnums=5)(*jargs, 16)
    else:
        fn = jsa2.fused_sa_scale3 if reference == "fused3" else jsa1.fused_sa_scale
        with pltpu.force_tpu_interpret_mode():
            want = fn(*jargs, k, 16)
    got = _port("fused", *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["features", "no_features"])
def test_fused_scale_gradients_match_jax(case):
    """The recompute backward against jax.grad of the unfactored
    composition, for every leaf of sp, xyz, features and the centres."""
    sp, xyz, feats, new_xyz, gidx = _case(case, seed=3)
    cot = np.random.default_rng(4).standard_normal(
        (xyz.shape[0], new_xyz.shape[1], sp["convs"][-1]["weight"].shape[0])).astype(np.float32)

    def loss(p, x, f, nx):
        return jnp.sum(jsa2._xla_reference(p, x, f, nx, jnp.asarray(gidx), 16) * cot)

    diff = (sp, xyz, feats, new_xyz) if feats is not None else (sp, xyz, new_xyz)
    argnums = tuple(range(len(diff)))
    if feats is None:
        want = jax.jit(jax.grad(lambda p, x, nx: loss(p, x, None, nx), argnums=argnums))(*_jax(diff))
    else:
        want = jax.jit(jax.grad(loss, argnums=argnums))(*_jax(diff))
    tsp, txyz, tf, tnew = _torch((sp, xyz, feats, new_xyz))
    leaves = [t.requires_grad_() for t in jax.tree_util.tree_leaves((tsp, txyz, tf, tnew))]
    out = sa_fused.fused_sa_scale(tsp, txyz, tf, tnew, torch.from_numpy(np.array(gidx)))
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    # Where GroupNorm's groups are single channels (width 16), a shift of
    # every row of a ball is removed by it: the bias of such a conv, and the
    # centres when conv1 is one, have gradient 0 in exact arithmetic, so both
    # sides give rounding noise there, held to 1e-4 of the scale's largest.
    zero = [f"{part}[{i}]['bias']" for i, c in enumerate(sp["convs"]) if c["weight"].shape[0] == 16
            for part in ("[0]['convs']",)]
    if sp["convs"][0]["weight"].shape[0] == 16:
        zero.append(f"[{len(diff) - 1}]")
    scale = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
    for g, (path, w) in zip(got, jax.tree_util.tree_flatten_with_path(want)[0]):
        w = np.asarray(w)
        largest = scale if jax.tree_util.keystr(path) in zero else float(np.abs(w).max())
        assert np.abs(g.numpy() - w).max() <= 1e-4 * largest, jax.tree_util.keystr(path)


def _backbone_inputs(seed=0):
    cfg = jpn2.PointNet2Config(**BACKBONE)
    shapes = jax.eval_shape(lambda k: jpn2.pointnet2_init(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s, path=""):
        if isinstance(s, dict):
            return {k: draw(v, f"{path}/{k}") for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return [draw(v, f"{path}/{i}") for i, v in enumerate(s)]
        shape = tuple(s.shape)
        if len(shape) == 2:
            bound = 1.0 / np.sqrt(shape[1])
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if "norm" in path and path.endswith("weight"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    xyz = rng.random((1, BACKBONE_POINTS, 3), dtype=np.float32) * CLOUD_SIZE
    feats = rng.standard_normal((1, BACKBONE_POINTS, 6)).astype(np.float32)
    return draw(shapes), np.concatenate([xyz, feats], -1).astype(np.float32)


def _jax_backbone(params, points, mode=None, env=None, monkeypatch=None):
    """JAX pointnet2_apply: SA scales as ``mode`` ("factored", or "fused3"
    where the v3 kernel takes the scale, in interpret mode, else
    "factored"), or as it picks on the CPU; ``env`` its selections."""
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    if mode is not None:
        def pick(cfg, sp, xyz, new_xyz, k):
            if mode == "fused3" and jsa2.can_fuse_sa3(sp, xyz.shape[1], new_xyz.shape[1], k):
                return "fused3"
            return "factored"
        monkeypatch.setattr(jpn2, "_sa_impl", pick)
    interpret = pltpu.force_tpu_interpret_mode() if mode == "fused3" else contextlib.nullcontext()
    apply = jax.jit(functools.partial(jpn2.pointnet2_apply, cfg=jpn2.PointNet2Config(**BACKBONE)))
    with interpret:
        return np.asarray(apply(_jax(params), points=jnp.asarray(points)))


def _port_backbone(params, points, **options):
    cfg = pn2.PointNet2Config(**BACKBONE, **options)
    return pn2.pointnet2_apply(_torch(params), cfg, torch.from_numpy(points)).numpy()


@pytest.mark.parametrize("sa_impl,jax_mode", [("factored", "factored"), ("fused", "fused3")])
def test_backbone_matches_jax(monkeypatch, sa_impl, jax_mode):
    params, points = _backbone_inputs()
    if jax_mode == "fused3":  # the v3 kernel takes every scale of this config
        cfg = pn2.PointNet2Config(**BACKBONE)
        sps = [sp for lvl in params["set_abstractions"] for sp in lvl["scales"]]
        ks = [k for lvl in cfg.sa_levels() for _, k, _ in lvl.scales]
        ns = [BACKBONE_POINTS] + list(cfg.sa_points[:-1])
        ms = list(cfg.sa_points)
        assert all(jsa2.can_fuse_sa3(_jax(sp), ns[i // 2], ms[i // 2], k)
                   for i, (sp, k) in enumerate(zip(sps, ks)))
    want = _jax_backbone(params, points, jax_mode, monkeypatch=monkeypatch)
    got = _port_backbone(params, points, sa_impl=sa_impl)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_encoder_selections_match_jax(monkeypatch):
    """fps="level", factored_fp=False and bq_pair=False against the JAX
    package with CASPR_TPU_FPS=level, CASPR_TPU_FACTORED_FP=0 and
    CASPR_TPU_BQ_PAIR=0, in one run: each JAX backbone is a compile of
    several seconds."""
    params, points = _backbone_inputs(seed=1)
    env = {"CASPR_TPU_FPS": "level", "CASPR_TPU_FACTORED_FP": "0", "CASPR_TPU_BQ_PAIR": "0"}
    want = _jax_backbone(params, points, env=env, monkeypatch=monkeypatch)
    got = _port_backbone(params, points, fps="level", factored_fp=False, bq_pair=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("option", ["default", "fps", "bq_pair", "factored_fp"])
def test_encoder_selections_take_their_paths(monkeypatch, option):
    """fps="level" runs FPS at every level, bq_pair=False one ball query
    per radius, factored_fp=False interpolates the coarse level's features
    instead of its conv outputs."""
    params, points = _backbone_inputs()
    calls = []
    for name in ("farthest_point_sampling", "ball_query", "ball_query_pair", "three_interpolate"):
        fn = getattr(pn2, name)
        monkeypatch.setattr(pn2, name, lambda *a, _fn=fn, _name=name, **kw:
                            calls.append((_name, a[0].shape[-1])) or _fn(*a, **kw))
    options = {"default": {}, "fps": {"fps": "level"}, "bq_pair": {"bq_pair": False},
               "factored_fp": {"factored_fp": False}}[option]
    _port_backbone(params, points, **options)
    count = lambda name: sum(1 for n, _ in calls if n == name)
    widths = [w for n, w in calls if n == "three_interpolate"]
    assert count("farthest_point_sampling") == (5 if option == "fps" else 1)
    assert (count("ball_query_pair"), count("ball_query")) == ((0, 10) if option == "bq_pair" else (5, 0))
    # the FP levels' interpolated widths: conv outputs (32) when factored,
    # the coarse level's features (SA outputs, then FP outputs) when not
    assert widths == ([1024, 32, 32, 32, 32] if option == "factored_fp" else [32] * 5)


def test_sa_impl_reaches_the_backbone_and_picks_per_scale(monkeypatch):
    assert CaSPRConfig().encoder_config().pointnet2_config().sa_impl == "xla"
    assert pn2.PointNet2Config() == pn2.PointNet2Config(sa_impl="xla", fps="hier",
                                                        factored_fp=True, bq_pair=True)
    for bad in ({"sa_impl": "fused3"}, {"fps": "per_level"}):
        with pytest.raises(ValueError):
            pn2.PointNet2Config(**bad)
    with pytest.raises(ValueError):
        CaSPRConfig(sa_impl="pallas").encoder_config().pointnet2_config()

    cfg = CaSPRConfig(sa_points=(16, 8, 8, 4, 4), ball_samples=(4, 8), local_feat_size=32,
                      latent_feat_size=64, global_feat_size=32, sa_impl="fused")
    seen = []
    real = kernels.sa_fused
    monkeypatch.setattr(kernels, "sa_fused", lambda *a: seen.append(a[2].shape) or real(*a))
    params, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.rand((1, 2, 32, 4)) * CLOUD_SIZE
    z0, _ = CaSPRModel(cfg, device="cpu").encode(params, x)
    assert len(seen) == 10 and bool(torch.isfinite(z0).all())

    rng = np.random.default_rng(0)
    three = _torch(_mini_pointnet(rng, 9, (16, 16, 32)))
    odd = _torch(_mini_pointnet(rng, 9, (24, 16, 32)))
    two = _torch(_mini_pointnet(rng, 9, (16, 32)))
    fused = pn2.PointNet2Config(sa_impl="fused")
    assert pn2._sa_impl(fused, three, 32) == "fused"
    assert pn2._sa_impl(fused, three, 64) == "factored"  # K above the kernel's
    assert pn2._sa_impl(fused, odd, 16) == "factored"
    assert pn2._sa_impl(fused, two, 16) == "xla"
    assert pn2._sa_impl(pn2.PointNet2Config(sa_impl="factored"), three, 16) == "factored"
    assert pn2._sa_impl(pn2.PointNet2Config(sa_impl="fused", use_xyz_feature=False),
                        three, 16) == "xla"
