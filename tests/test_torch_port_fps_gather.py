"""The index arithmetic of the fps and gather kernels, modelled on the CPU
(caspr_tpu_torch/checks/fps_gather_arithmetic.py).

csrc/fps.cu picks a step's point by a per-thread scan, a warp argmax in two
redux.sync instructions over the running minima's float bits (uint32
order) and the lanes' indices, and the same over one partial per warp.  The
model of that reduction must give torch.argmax's first maximum on any
running minima: zeros, +inf, subnormals, ties inside a warp, across warps
and across the padding slots; and a whole FPS built on it must give the
plain version's indices and the JAX package's.

csrc/gather.cu splits flat offsets by a multiply and a shift and writes
16-byte pieces from the output's first 16-byte boundary on: the division
must be exact for every width the path uses (and any other) at the edge
offsets up to 2^31 - 1, and the model of the kernel's layout must write
every output float exactly once, bit-equal to the plain gather, for every
misalignment of the output.

Indices are compared for identity and values bit for bit: the kernels do
no arithmetic on the values they move or compare.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caspr_tpu.ops import pointops as jops
from caspr_tpu_torch.checks import fps_gather_arithmetic as model
from caspr_tpu_torch.ops import pointops

# the widths the reconstruct's gathers take (xyz, [xyz | features] of the
# five SA levels) and a few others
PATH_WIDTHS = (3, 9, 99, 131, 259, 515)
WIDTHS = (1, 2, 3, 4, 9, 99, 131, 259, 515, 1024)
CLOUD_SIZES = (1, 3, 33, 257, 1024, 2048, 4097, 8192, 8193, 9000)
TINY = float(np.finfo(np.float32).smallest_subnormal)


@pytest.mark.parametrize("n", CLOUD_SIZES)
def test_fps_block_covers_the_cloud(n):
    threads, per = model.fps_block_shape(n)
    assert threads % model.WARP == 0 and threads <= model.FPS_MAX_THREADS
    assert threads * per >= n
    if n <= model.FPS_PER_THREAD * model.FPS_MAX_THREADS:
        # every warp's lane 0 owns a point, so no warp offers a padding slot
        assert threads - model.WARP < n


def _running_minima(case, n, rng):
    """Adversarial running minima (N,) float32, all >= 0 or +inf."""
    if case == "zeros":  # every step of a cloud of equal points
        return np.zeros(n, np.float32)
    if case == "inf":
        return np.full(n, np.inf, np.float32)
    if case == "subnormal":
        v = rng.integers(1, 4, n).astype(np.float32) * np.float32(TINY)
        v[rng.integers(0, n, max(1, n // 50))] = 0.0
        return v
    if case == "ties_in_warp":  # the maximum at lanes of one warp, several slots each
        v = rng.random(n, dtype=np.float32) * 0.5
        v[rng.integers(0, n, min(n, 7))] = 0.75
        return v
    if case == "ties_across_warps":  # one value at strided and contiguous spots
        v = rng.random(n, dtype=np.float32) * 0.5
        v[::37] = 1.0
        v[n // 2:] = np.where(v[n // 2:] == 1.0, 0.25, v[n // 2:])
        return v
    if case == "last_only":  # the maximum at the last point, next to the padding
        v = np.zeros(n, np.float32)
        v[-1] = TINY
        return v
    if case == "inf_and_finite":  # inf ties (points never reached) among finite values
        v = rng.random(n, dtype=np.float32)
        v[rng.integers(0, n, max(1, n // 3))] = np.inf
        return v
    if case == "few_values":  # many exact ties at several levels
        return rng.choice(np.array([0.0, TINY, 0.5, 1e30], np.float32), n)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["zeros", "inf", "subnormal", "ties_in_warp",
                                  "ties_across_warps", "last_only", "inf_and_finite",
                                  "few_values"])
def test_fps_pick_is_the_first_maximum(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    for n in CLOUD_SIZES:
        for _ in range(3):
            v = torch.from_numpy(_running_minima(case, n, rng))
            assert model.fps_pick(v) == int(torch.argmax(v)), (case, n)


def test_warp_pick_orders_float_bits_as_uint32():
    """The uint32 order of the bits of values >= 0 is their float order,
    subnormals and +inf included; ties go to the lowest index whatever the
    lane."""
    vals = torch.tensor([0.0, TINY, 2 * TINY, 1e-38, 1.0, 3e38, float("inf")])
    bits = model.float_bits(vals)
    assert torch.equal(torch.argsort(bits), torch.arange(vals.numel()))
    lanes = torch.zeros(model.WARP, dtype=torch.int64)
    lanes[[5, 9, 30]] = model.float_bits(torch.tensor([1.0]))
    index = torch.arange(model.WARP, dtype=torch.int64).flip(0) + 100
    assert int(model.warp_pick(lanes, index)) == 101  # lane 30 holds the lowest index


def _clouds(rng, kind, b, n):
    if kind == "uniform":
        return rng.random((b, n, 3), dtype=np.float32)
    if kind == "duplicated":  # every point twice or more: exact ties
        base = rng.random((b, max(1, n // 3), 3), dtype=np.float32)
        return base[:, rng.integers(0, base.shape[1], n)]
    if kind == "equal":  # every step ties at 0 once the first point is picked
        return np.broadcast_to(rng.random((b, 1, 3), dtype=np.float32), (b, n, 3)).copy()
    if kind == "grid":  # integer coordinates: many equal distances
        return rng.integers(0, 4, (b, n, 3)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "equal", "grid"])
@pytest.mark.parametrize("n, m", [(3, 2), (33, 32), (257, 100), (1030, 64)])
def test_fps_model_matches_plain_and_jax(kind, n, m):
    rng = np.random.default_rng(n + m)
    xyz = _clouds(rng, kind, 2, n)
    got = model.fps_model(torch.from_numpy(xyz), m)
    assert torch.equal(got, pointops.farthest_point_sampling(torch.from_numpy(xyz), m))
    want = np.asarray(jops.farthest_point_sampling_xla(jnp.asarray(xyz), m))
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_offsets(d):
    """Numerators where q // d changes, and the top of the range."""
    top = 2**31 - 1
    k = np.array([0, 1, 2, 3, top // d - 1, top // d], dtype=np.int64)
    q = np.concatenate([k * d - 1, k * d, k * d + 1, np.arange(top - 64, top + 1)])
    return q[(q >= 0) & (q <= top)]


@pytest.mark.parametrize("d", WIDTHS)
def test_fastdiv_exact_for_the_path_widths(d):
    mul, shift = model.fastdiv_params(d)
    assert 0 < mul < 2**32
    q = np.concatenate([np.arange(1 << 20, dtype=np.int64), _edge_offsets(d)])
    np.testing.assert_array_equal(model.fastdiv(q, mul, shift).astype(np.int64), q // d)


def test_fastdiv_exact_for_any_width():
    rng = np.random.default_rng(7)
    divisors = [2**k + e for k in range(31) for e in (-1, 0, 1) if 1 <= 2**k + e < 2**31]
    divisors += [2**31 - 1] + rng.integers(1, 2**31 - 1, 200).tolist()
    for d in divisors:
        mul, shift = model.fastdiv_params(int(d))
        assert 0 < mul < 2**32
        q = np.concatenate([_edge_offsets(int(d)), rng.integers(0, 2**31 - 1, 2000)])
        np.testing.assert_array_equal(model.fastdiv(q, mul, shift).astype(np.int64), q // d)
    with pytest.raises(ValueError):
        model.fastdiv_params(0)


@pytest.mark.parametrize("c", WIDTHS)
def test_gather_layout_writes_each_float_once_bit_exact(c):
    """Odd row counts, indices below 0 and at or above N (clamped), every
    misalignment of the output."""
    rng = np.random.default_rng(c)
    b, n, r = 3, 37, 21
    src = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(-3, n + 3, (b, r)).astype(np.int32)
    want = pointops.gather_points(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    for misaligned in range(4):
        got, writes = model.gather_rows_model(src, idx, misaligned)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if c >= 3:  # a 16-byte piece spans at most two rows: two index reads
        pieces, _ = model.gather_pieces(r * c, 1)
        mul, shift = model.fastdiv_params(c)
        rows = model.fastdiv(pieces, mul, shift).astype(np.int64)
        assert (rows[:, 3] - rows[:, 0] <= 1).all()


@pytest.mark.parametrize("c", PATH_WIDTHS)
def test_gather_model_matches_jax_on_the_path_widths(c):
    """In-range indices (the JAX package's XLA gather wraps negative ones
    where the port and its Pallas gather clamp)."""
    rng = np.random.default_rng(100 + c)
    src = rng.standard_normal((2, 64, c)).astype(np.float32)
    idx = rng.integers(0, 64, (2, 16, 3)).astype(np.int32)
    got, _ = model.gather_rows_model(src, idx.reshape(2, -1))
    want = np.asarray(jops.gather_points(jnp.asarray(src), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("length", [0, 1, 2, 3, 4, 5, 7, 8, 9, 13])
def test_gather_pieces_cover_short_runs(length):
    for misaligned in range(4):
        pieces, singles = model.gather_pieces(length, misaligned)
        flat = np.sort(np.concatenate([pieces.ravel(), singles]))
        np.testing.assert_array_equal(flat, np.arange(length))
        assert ((pieces[:, 0] + misaligned) % 4 == 0).all()


def test_encoder_calls_are_captured_and_checked():
    """caspr_tpu_torch/checks/encoder_kernels.py, which chip_smoke.py's
    phase 2 runs on the card: one encode calls fps once, the ball query,
    three_nn and three_interpolate five times each and the gather eleven
    times; fps="level" adds five FPS calls.  Here each call goes to the plain
    version on both sides (a CPU tensor), with a stand-in timer."""
    from caspr_tpu_torch.checks import encoder_kernels
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init

    cfg = CaSPRConfig(sa_points=(16, 8, 8, 4, 4), ball_samples=(4, 8), local_feat_size=64,
                      latent_feat_size=160, ode_hidden_size=32, motion_feat_size=16,
                      global_feat_size=128, cnf_dims=(32, 32))
    model = CaSPRModel(cfg, device="cpu")
    params, _ = caspr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.random((1, 2, 48, 4), dtype=np.float32) * 0.15
    calls = encoder_kernels.capture_calls(model, params, torch.from_numpy(x))
    assert {k: len(v) for k, v in calls.items()} == {
        "fps": 1, "ball_query": 5, "gather": 11, "three_nn": 5, "three_interpolate": 5,
        "fps_level": 5}
    assert [c[0].shape[-1] for c in calls["gather"]][0] == 3  # the centroids' gather
    timer = lambda fn: (fn(), 1.0)[1]
    out = encoder_kernels.measure(calls, lambda b, o: (b / 3.35e9 + o / 67e9, "bytes"),
                                  kernel_ms=timer, plain_ms=timer)
    assert out["gather"]["ms_per_reconstruct"] == 11.0
    assert all(row["max_abs_err"] == 0.0 for row in out.values())
    assert out["fps"]["calls"][0]["ns_per_step"] == 1e6 / 15
