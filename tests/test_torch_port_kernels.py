"""The port's kernel wrappers (caspr_tpu_torch/ops/kernels.py).

On the CPU a wrapper takes the plain version: these tests check that it
does, that it counts no launch there, and that it refuses what the kernel
does not take.  The kernel-versus-plain tests need the card and skip
without one (the CUDA kernels have no CPU mode); on the card they hold
each kernel to its plain version with the tolerances of chip_smoke.py:
indices identical, gather and interpolation bit-exact (same rounding
order, no FMA), the fused CNF stacks and the VJP within 1e-4 of each
output's max magnitude (float32 sums of 512 terms in another order; the
VJP's weight gradients are sums over every point, in a fixed order: two
launches give the same bits).  The backward of the gather and the
interpolation wrappers is plain PyTorch on both devices: on the card it is
held to the CPU's within 1e-5 of each gradient's max magnitude (atomic
scatter-adds sum in another order).

The bfloat16 variants of the CNF kernels (matmul_dtype="bf16", the VJP's
included) are held to their bfloat16 plain versions within 2e-3 of each
output's max magnitude, and within 1.5x the plain version's distance from
the float64 value without rounding (chip_smoke.py phase 13's bars).

The fused SA kernel is held to its plain version within 1e-4 of each
output's largest magnitude, in float32 (random balls) and against the plain
version in float64 at model-like shapes (chip_smoke.py's bar: GroupNorm
scales the rounding of a group with a variance far below its eps by up to
316); two launches give the same bits.

The EMD cost is held to the float64 value of the plain version, as the JAX
package holds its TPU kernel (tools/hw_exactness.py), in two steps.  The
kernel's body compiled in float64 agrees with that value to 1e-9 (measured:
6e-12), so the body is the algorithm and whatever separates the float32
kernel from it is rounding.  The annealing is iterative, with exponents up
to 16384 * d^2, and amplifies float32 rounding: the kernel and the float32
plain version alike land about 4e-5 in the mean and a few 1e-4 at worst from
the float64 value at 2048 x 2048, and 1e-4 in the mean and up to 1.5e-3 on
single pairs of 100 to 150 points (caspr_tpu_torch/checks/emd_arithmetic.py,
64 pairs).  So the float32 kernel is held pair by pair to 1e-3 at the
protocol's size and 3e-3 on the small ragged pairs, which an error of the
algorithm would exceed, and its mean over the pairs to twice the float32
plain version's own mean (or 2e-4 at the protocol's size, if that is more).
"""

import pytest
import torch

from caspr_tpu_torch.checks.vjp_bf16_agreement import model_like_vjp_inputs
from caspr_tpu_torch.ops import cnf_fused, emd_plain, kernels, pointops, sa_fused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, b=3, n=256, m=64, c=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((b, n, 3), generator=g)
    dup = torch.cat([xyz[:, : n // 2], xyz[:, : n // 2]], dim=1)  # exact ties
    feats = torch.randn((b, n, c), generator=g)
    idx = torch.randint(0, n, (b, m, 8), generator=g, dtype=torch.int32)
    return {k: v.to(device) for k, v in dict(xyz=xyz, dup=dup, feats=feats, idx=idx).items()}


def _cnf_inputs(device, bt=4, n=100, h=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((bt, n, 3), generator=g)
    gb = torch.rand((bt, 8, h), generator=g)
    wf = torch.randn((h, 3), generator=g)
    wh = torch.randn((2, h, h), generator=g) / h ** 0.5
    wl = torch.randn((3, h), generator=g) / h ** 0.5
    return [t.to(device) for t in (y, gb, wf, wh, wl)]


def _sa_inputs(device, b=2, n=256, m=40, k=16, dims=(16, 16, 32), seed=0):
    """sa_fused's arguments: t, u, gidx (random sources, some indices out of
    range for the clamp) and a mini-PointNet's parameters."""
    g = torch.Generator().manual_seed(seed)
    d1 = dims[0]
    t = torch.randn((b, n, d1), generator=g)
    u = 0.5 * torch.randn((b, m, d1), generator=g)
    gidx = torch.randint(-2, n + 3, (b, m, k), generator=g, dtype=torch.int32)
    all_dims = (9,) + tuple(dims)
    sp = {"convs": [{"weight": torch.randn((d, all_dims[i]), generator=g) / all_dims[i] ** 0.5,
                     "bias": 0.1 * torch.randn((d,), generator=g)} for i, d in enumerate(dims)],
          "norms": [{"weight": 1.0 + 0.1 * torch.randn((d,), generator=g),
                     "bias": 0.1 * torch.randn((d,), generator=g)} for d in dims]}
    move = lambda tree: {part: [{key: v.to(device) for key, v in layer.items()} for layer in layers]
                         for part, layers in tree.items()}
    return t.to(device), u.to(device), gidx.to(device), move(sp)


def _float64(sp):
    return {part: [{key: v.double() for key, v in layer.items()} for layer in layers]
            for part, layers in sp.items()}


def _noise(like, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(like.shape, generator=g).to(like.device)


def _calls(x):
    """Every wrapper on one input set: (name, wrapper result, plain result);
    a result is a tensor or a tuple of tensors."""
    xyz, dup, feats, idx = x["xyz"], x["dup"], x["feats"], x["idx"]
    cen = xyz[:, :64].contiguous()
    d2, nn_idx = pointops.three_nn(xyz, cen)
    w = (1.0 / (d2 + 1e-8))
    w = (w / w.sum(-1, keepdim=True)).contiguous()
    cnf = _cnf_inputs(xyz.device)
    return [
        ("fps", kernels.farthest_point_sampling(xyz, 64),
         pointops.farthest_point_sampling(xyz, 64)),
        ("fps", kernels.farthest_point_sampling(dup, 200),
         pointops.farthest_point_sampling(dup, 200)),
        ("ball_query", torch.cat(kernels.ball_query_pair(dup, cen, 0.1, 8, 0.3, 16), -1),
         torch.cat(pointops.ball_query_pair(dup, cen, 0.1, 8, 0.3, 16), -1)),
        ("ball_query", kernels.ball_query(xyz, cen, 0.2, 300),
         pointops.ball_query(xyz, cen, 0.2, 300)),
        ("gather", kernels.gather_points(feats, idx), pointops.gather_points(feats, idx)),
        ("three_nn", torch.cat([t.float() for t in kernels.three_nn(dup, cen)], -1),
         torch.cat([t.float() for t in pointops.three_nn(dup, cen)], -1)),
        ("three_interpolate", kernels.three_interpolate(feats[:, :64].contiguous(), nn_idx, w),
         pointops.three_interpolate(feats[:, :64].contiguous(), nn_idx, w)),
        ("cnf_primal", kernels.cnf_primal(*cnf), cnf_fused.primal_packed(*cnf)),
        ("cnf_dynamics", kernels.cnf_dynamics(cnf[0], _noise(cnf[0]), *cnf[1:]),
         cnf_fused.dynamics_packed(cnf[0], _noise(cnf[0]), *cnf[1:])),
        ("cnf_dynamics_vjp", kernels.cnf_dynamics_vjp(*_vjp_inputs(cnf)),
         cnf_fused.dynamics_vjp_packed(*_vjp_inputs(cnf))),
        # N != M, neither a multiple of the warp; and identical clouds
        ("emd", kernels.approx_match_emd(xyz[:, :100].contiguous(), dup[:, :150].contiguous()),
         emd_plain.emd_plain(xyz[:, :100], dup[:, :150])),
        ("emd", kernels.approx_match_emd(xyz, xyz), emd_plain.emd_plain(xyz, xyz)),
        ("sa_fused", kernels.sa_fused(*_sa_inputs(xyz.device)),
         sa_fused.sa_stack_plain(*_sa_inputs(xyz.device))),
    ]


def _assert_emd_close_to_float64(a, b, pair_tol, mean_floor=0.0):
    ref = emd_plain.emd_plain(a.double(), b.double())
    body_rel = (kernels.approx_match_emd_float64(a.double(), b.double()) - ref).abs() / ref
    assert float(body_rel.max()) <= 1e-9, body_rel
    kernel_rel = (kernels.approx_match_emd(a, b).double() - ref).abs() / ref
    plain_rel = (emd_plain.emd_plain(a, b).double() - ref).abs() / ref
    assert float(kernel_rel.max()) <= pair_tol, (kernel_rel, plain_rel)
    assert float(kernel_rel.mean()) <= max(2.0 * float(plain_rel.mean()), mean_floor), (
        kernel_rel, plain_rel)


def _vjp_inputs(cnf):
    """cnf_dynamics_vjp's arguments from _cnf_inputs, with noise and
    cotangents."""
    y, gb, wf, wh, wl = cnf
    return (y, _noise(y), gb, wf, wh, wl, _noise(y, seed=8), _noise(y[..., 0], seed=9))


def _leaves(result):
    return result if isinstance(result, tuple) else (result,)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    kernels.reset_launches()
    for name, got, want in _calls(_inputs("cpu")):
        for g, w in zip(_leaves(got), _leaves(want)):
            assert torch.equal(g, w), (name, float((g - w).abs().max()))
    assert all(v == 0 for v in kernels.launches.values())


def test_fps_identity_when_sampling_every_point():
    xyz = torch.rand((2, 10, 3))
    want = torch.tensor(list(range(10)) + [0, 0], dtype=torch.int32).expand(2, 12)
    assert torch.equal(kernels.farthest_point_sampling(xyz, 12), want)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device", "batch"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    xyz = torch.rand((2, 16, 3))
    cen = xyz[:, :4].contiguous()
    if bad == "dtype":
        with pytest.raises(TypeError):
            kernels.farthest_point_sampling(xyz.double(), 4)
        with pytest.raises(TypeError):
            kernels.gather_points(xyz, torch.zeros((2, 3), dtype=torch.int64))
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            kernels.three_nn(xyz.transpose(0, 1).contiguous().transpose(0, 1), cen)
    elif bad == "shape":
        with pytest.raises(ValueError):
            kernels.ball_query_pair(xyz[..., :2].contiguous(), cen, 0.1, 4, 0.2, 8)
        y, gb, wf, wh, wl = _cnf_inputs("cpu")
        with pytest.raises(ValueError):
            kernels.cnf_primal(y, gb, wf, wh, wl[:, :10].contiguous())
        with pytest.raises(ValueError):
            kernels.cnf_dynamics(y, y[:, :50].contiguous(), gb, wf, wh, wl)
        with pytest.raises(ValueError):
            kernels.cnf_dynamics_vjp(y, y, gb, wf, wh, wl, y, y[..., 0].T.contiguous())
        with pytest.raises(ValueError):
            kernels.three_nn(xyz, cen[:, :2].contiguous())
    elif bad == "device":  # neither CPU nor CUDA: no silent route
        with pytest.raises(ValueError, match="unsupported device"):
            kernels.farthest_point_sampling(xyz.to("meta"), 4)
    else:
        with pytest.raises(ValueError, match="batch"):
            kernels.three_interpolate(torch.rand((3, 4, 5)), torch.zeros((2, 6, 3), dtype=torch.int32),
                                      torch.rand((2, 6, 3)))


def test_sa_fused_wrapper_checks_and_carries_no_gradient():
    t, u, gidx, sp = _sa_inputs("cpu")
    sp["convs"][1]["weight"].requires_grad_()
    out = kernels.sa_fused(t, u, gidx, sp)
    assert not out.requires_grad and out.shape == (2, 40, 32)
    with pytest.raises(ValueError, match="u "):
        kernels.sa_fused(t, u[:, :, :8].contiguous(), gidx, sp)
    with pytest.raises(ValueError, match="w3 "):
        sp["convs"][2]["weight"] = sp["convs"][2]["weight"][:, :8].contiguous()
        kernels.sa_fused(t, u, gidx, sp)
    with pytest.raises(TypeError):
        kernels.sa_fused(t, u, gidx.long(), sp)
    with pytest.raises(ValueError, match="batch"):
        kernels.sa_fused(t, u[:1].contiguous(), gidx, sp)


@pytest.mark.parametrize("shape", [
    dict(m=1024, k=16, dims=(16, 16, 32), b=4),    # SA level 1, scale 1
    dict(m=16, k=32, dims=(256, 256, 512), b=3),   # SA level 5, scale 2: one ball a block
    dict(m=37, k=5, dims=(64, 96, 128)),           # M odd, K no power of two: padded rows
])
def test_sa_fused_against_float64_on_the_card(cuda, shape):
    """The kernel within 1e-4 of each output's largest magnitude of its
    plain version in float64 (chip_smoke.py's bar), and two launches equal."""
    t, u, gidx, sp = _sa_inputs(cuda, **shape)
    got = kernels.sa_fused(t, u, gidx, sp)
    assert torch.equal(got, kernels.sa_fused(t, u, gidx, sp))
    want = sa_fused.sa_stack_plain(t.double(), u.double(), gidx, _float64(sp))
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-4


def test_sa_fused_refuses_what_the_kernel_does_not_take_on_the_card(cuda):
    with pytest.raises(ValueError, match="sa_fused kernel takes"):
        kernels.sa_fused(*_sa_inputs(cuda, k=33))
    with pytest.raises(ValueError, match="sa_fused kernel takes"):
        kernels.sa_fused(*_sa_inputs(cuda, dims=(24, 16, 32)))


def test_emd_wrapper_carries_no_gradient_and_its_float64_form_needs_the_card():
    """The differentiable EMD is ops.metrics.approx_match_emd; the wrapper
    gives the same non-differentiable cost on either device."""
    a = torch.rand((2, 12, 3), requires_grad=True)
    b = torch.rand((2, 9, 3))
    cost = kernels.approx_match_emd(a, b)
    assert not cost.requires_grad
    assert torch.equal(cost, emd_plain.emd_plain(a.detach(), b))
    with pytest.raises(ValueError, match="only on the card"):
        kernels.approx_match_emd_float64(a.detach().double(), b.double())
    with pytest.raises(TypeError):
        kernels.approx_match_emd_float64(a.detach(), b)


def test_build_needs_nvcc_here(monkeypatch):
    """Without the CUDA toolkit the build says so instead of failing later."""
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda _: False)
    monkeypatch.setattr(kernels, "_library_path", lambda: kernels.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


@pytest.mark.parametrize("kernel", kernels.KERNELS)
def test_kernel_matches_plain_on_the_card(cuda, kernel):
    kernels.reset_launches()
    cases = [(got, want) for name, got, want in _calls(_inputs(cuda)) if name == kernel]
    torch.cuda.synchronize()
    assert cases and kernels.launches[kernel] == len(cases)
    for got, want in cases:
        for g, w in zip(_leaves(got), _leaves(want)):
            if kernel in ("cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp", "sa_fused"):
                assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
            elif kernel == "emd":  # coarse here; the float64 gate is below
                assert torch.allclose(g, w, rtol=5e-3, atol=1e-5)
            else:
                assert torch.equal(g, w)


def test_cnf_kernels_ragged_tile_on_the_card(cuda):
    """N not a multiple of the point tiles (32 and 16), H = 512 as in the
    model."""
    y, gb, wf, wh, wl = _cnf_inputs(cuda, bt=2, n=77, h=512, seed=1)
    got = kernels.cnf_primal(y, gb, wf, wh, wl)
    want = cnf_fused.primal_packed(y, gb, wf, wh, wl)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    e = _noise(y)
    for g, w in zip(kernels.cnf_dynamics(y, e, gb, wf, wh, wl),
                    cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl)):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
    args = _vjp_inputs((y, gb, wf, wh, wl))
    got = kernels.cnf_dynamics_vjp(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.cnf_dynamics_vjp(*args)))
    for g, w in zip(got, cnf_fused.dynamics_vjp_packed(*args)):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("h, n", [(64, 100), (64, 77), (512, 77), (512, 256), (32, 77), (96, 77)])
def test_cnf_forward_kernels_against_float64_on_the_card(cuda, h, n):
    """The tensor-core CNF kernels (3xTF32, csrc/cnf_tc.cuh) held to the
    float64 plain version at chip_smoke.py's phase-2 bar: each output within
    4x the distance the float32 plain version keeps from it, and two launches
    give the same bits.  H = 32, 64 and 96 are no multiples of 128: the
    kernel pads the channels to 128 and computes them right (it refuses no H
    that is a multiple of 32 up to 512)."""
    y, gb, wf, wh, wl = _cnf_inputs(cuda, bt=2, n=n, h=h, seed=2)
    e = _noise(y)
    args64 = [t.double() for t in (y, gb, wf, wh, wl)]
    cases = [
        ("cnf_primal", lambda: (kernels.cnf_primal(y, gb, wf, wh, wl),),
         (cnf_fused.primal_packed(y, gb, wf, wh, wl),), (cnf_fused.primal_packed(*args64),)),
        ("cnf_dynamics", lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl),
         cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl),
         cnf_fused.dynamics_packed(args64[0], e.double(), *args64[1:])),
    ]
    for name, run, plain, exact in cases:
        got = run()
        assert all(torch.equal(a, b) for a, b in zip(got, run())), name
        for g, p, x in zip(got, plain, exact):
            assert _rel(g, x) <= 4.0 * _rel(p, x), (name, _rel(g, x), _rel(p, x))


@pytest.mark.parametrize("h, n", [(64, 100), (512, 77), (512, 256), (32, 77), (96, 77)])
def test_cnf_bf16_kernels_against_their_plain_versions_on_the_card(cuda, h, n):
    """The bfloat16 variants (matmul_dtype="bf16") held to their bfloat16
    plain versions at chip_smoke.py's phase-13 bars: each output within
    2e-3 of its largest magnitude (a bfloat16 rounding of an activation may
    flip by one unit where the sums' order differs), within 1.5x the plain
    version's distance from the float64 field without rounding, two launches
    bit-equal; counted under their own names, the float32 kernels not."""
    y, gb, wf, wh, wl = _cnf_inputs(cuda, bt=3, n=n, h=h, seed=2)
    e = _noise(y)
    args64 = [t.double() for t in (y, gb, wf, wh, wl)]
    cases = [
        ("cnf_primal_bf16", lambda: (kernels.cnf_primal(y, gb, wf, wh, wl, "bf16"),),
         (cnf_fused.primal_packed(y, gb, wf, wh, wl, "bf16"),),
         (cnf_fused.primal_packed(*args64),)),
        ("cnf_dynamics_bf16", lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl, "bf16"),
         cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl, "bf16"),
         cnf_fused.dynamics_packed(args64[0], e.double(), *args64[1:])),
    ]
    for name, run, plain, exact in cases:
        kernels.reset_launches()
        got = run()
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.launches.items() if v} == {name: 1}
        assert all(torch.equal(a, b) for a, b in zip(got, run())), name
        for g, p, x in zip(got, plain, exact):
            assert _rel(g, p.double()) <= 2e-3, (name, _rel(g, p.double()))
            assert _rel(g, x) <= 1.5 * _rel(p, x), (name, _rel(g, x), _rel(p, x))


@pytest.mark.parametrize("h", [32, 128, 512])
@pytest.mark.parametrize("num_hidden, n", [(1, 77), (6, 45)])
def test_cnf_dynamics_vjp_against_float64_on_the_card(cuda, h, num_hidden, n):
    """The tensor-core VJP (csrc/cnf_dynamics_vjp.cu) at ragged point counts
    (77 and 45: no multiple of the 32-point tile), 1 and 6 hidden layers:
    each output within 1e-4 of its largest magnitude of the float64 plain
    version (chip_smoke.py's bar), and two launches give the same bits."""
    g = torch.Generator().manual_seed(h + num_hidden)
    bt = 3
    y = torch.randn((bt, n, 3), generator=g)
    gb = torch.rand((bt, max(8, 2 * (num_hidden + 2)), h), generator=g)
    wf = torch.randn((h, 3), generator=g)
    wh = torch.randn((num_hidden, h, h), generator=g) / h ** 0.5
    wl = torch.randn((3, h), generator=g) / h ** 0.5
    args = [t.to(cuda) for t in _vjp_inputs((y, gb, wf, wh, wl))]
    got = kernels.cnf_dynamics_vjp(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.cnf_dynamics_vjp(*args)))
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    for name, gg, x in zip(("dy", "dgb", "dw_first", "dw_hidden", "dw_last"), got, exact):
        assert _rel(gg, x) <= 1e-4, (name, _rel(gg, x))


@pytest.mark.parametrize("h", [128, 512])
@pytest.mark.parametrize("num_hidden, n", [(2, 77), (1, 256), (2, 256)])
def test_cnf_dynamics_vjp_bf16_against_its_plain_version_on_the_card(cuda, h, num_hidden, n):
    """The VJP's bfloat16 variant (matmul_dtype="bf16") held to its bfloat16
    plain version at chip_smoke.py's phase-13 bars: each output within 2e-3
    of its largest magnitude (a bfloat16 rounding of an activation or of dm
    may flip by one unit where the float32 sums' order differs), within 1.5x
    the plain version's distance from the float64 VJP without rounding, two
    launches bit-equal; counted under its own name, the float32 VJP not.
    One and two hidden layers, the bf16 mode's reach (bf16_takes), and the
    ODEnet drawn as the model draws it, its gates and biases from
    context_gb: caspr_tpu_torch/checks/vjp_bf16_agreement.py prints how far
    two correct bf16 VJPs lie apart for these and for other inputs."""
    args = [t.to(cuda) for t in model_like_vjp_inputs(h, num_hidden, n, seed=h + num_hidden)]
    kernels.reset_launches()
    got = kernels.cnf_dynamics_vjp(*args, "bf16")
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launches.items() if v} == {"cnf_dynamics_vjp_bf16": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.cnf_dynamics_vjp(*args, "bf16")))
    plain = cnf_fused.dynamics_vjp_packed(*args, "bf16")
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    for name, gg, p, x in zip(("dy", "dgb", "dw_first", "dw_hidden", "dw_last"), got, plain,
                              exact):
        assert _rel(gg, p.double()) <= 2e-3, (name, _rel(gg, p.double()))
        assert _rel(gg, x) <= 1.5 * _rel(p, x), (name, _rel(gg, x), _rel(p, x))


@pytest.mark.parametrize("op", ["gather", "three_interpolate"])
def test_wrapper_gradients_on_the_card_match_the_cpu(cuda, op):
    x = _inputs("cpu")
    d2, nn_idx = pointops.three_nn(x["xyz"], x["xyz"][:, :64].contiguous())

    def grads(dev):
        if op == "gather":
            feats = x["feats"].to(dev).requires_grad_()
            inputs, out = (feats,), kernels.gather_points(feats, x["idx"].to(dev))
        else:
            feats = x["feats"][:, :64].contiguous().to(dev).requires_grad_()
            w = (1.0 / (d2 + 1e-8)).to(dev).requires_grad_()
            inputs, out = (feats, w), kernels.three_interpolate(feats, nn_idx.to(dev), w)
        cot = _noise(out.detach().cpu()).to(dev)
        return torch.autograd.grad((out * cot).sum(), inputs)

    for g, w in zip(grads(cuda), grads("cpu")):
        assert float((g.cpu() - w).abs().max() / w.abs().max()) <= 1e-5


def test_emd_protocol_size_on_the_card(cuda):
    """2048 x 2048 as the evaluation protocol runs it, ragged small pairs,
    and N + M = 16384, past what one block's shared memory held before the
    kernel streamed the clouds (N != M: a cluster of 8 on one pair)."""
    g = torch.Generator().manual_seed(3)
    a = torch.rand((8, 2048, 3), generator=g).to(cuda)
    b = torch.rand((8, 2048, 3), generator=g).to(cuda)
    _assert_emd_close_to_float64(a, b, 1e-3, mean_floor=2e-4)
    c = torch.rand((64, 100, 3), generator=g).to(cuda)  # N != M, not warp multiples
    d = torch.rand((64, 150, 3), generator=g).to(cuda)
    _assert_emd_close_to_float64(c, d, 3e-3)
    big = torch.rand((1, 12000, 3), generator=g).to(cuda)
    other = torch.rand((1, 4384, 3), generator=g).to(cuda)
    _assert_emd_close_to_float64(big, other, 1e-3, mean_floor=2e-4)


@pytest.mark.parametrize("pairs", [1, 12, 40])
def test_emd_cluster_sizes_on_the_card(cuda, pairs):
    """A pair's cluster of CTAs (the card picks its size per launch: 2 or
    more here, so the launch spans more SMs than pairs); N != M; two launches
    give the same bits (the column sums are reduced across the cluster in
    rank order, no atomics)."""
    assert kernels.emd_cluster_size(pairs, 1000, device=cuda) >= 2
    g = torch.Generator().manual_seed(4 + pairs)
    a = torch.rand((pairs, 1000, 3), generator=g).to(cuda)
    b = torch.rand((pairs, 1536, 3), generator=g).to(cuda)
    assert torch.equal(kernels.approx_match_emd(a, b), kernels.approx_match_emd(a, b))
    _assert_emd_close_to_float64(a, b, 1e-3, mean_floor=2e-4)


def test_fps_past_shared_memory_on_the_card(cuda):
    """N = 16384: the cloud and the running minima in device memory, the
    indices those of the plain version."""
    g = torch.Generator().manual_seed(5)
    xyz = torch.rand((3, 16384, 3), generator=g).to(cuda)
    xyz[1, 8000:] = xyz[1, :8384].clone()  # exact ties across the old limit
    got = kernels.farthest_point_sampling(xyz, 700)
    assert torch.equal(got, pointops.farthest_point_sampling(xyz, 700))


@pytest.mark.parametrize("n", [3, 33, 257, 1024, 2048, 4097, 8192, 8193])
def test_fps_sizes_and_ties_on_the_card(cuda, n):
    """Each block shape of the fps kernel (and its device-memory path past
    8192 points), M from 2 to N - 1, on a uniform cloud, a cloud of
    duplicated points and one of all-equal points, where every step ties:
    indices identical to the plain version."""
    g = torch.Generator().manual_seed(n)
    xyz = torch.rand((3, n, 3), generator=g)
    half = (n + 1) // 2
    xyz[1, half:] = xyz[1, : n - half].clone()
    xyz[2] = xyz[2, :1].clone()
    xyz = xyz.to(cuda)
    for m in sorted({2, max(2, n // 3), n - 1}):
        got = kernels.farthest_point_sampling(xyz, m)
        assert torch.equal(got, pointops.farthest_point_sampling(xyz, m)), m


@pytest.mark.parametrize("c", [1, 3, 4, 9, 99, 131, 259, 515, 1024])
def test_gather_widths_on_the_card(cuda, c):
    """Odd row counts, indices below 0 and at or above N (clamped), and a
    source at no 16-byte alignment: bit-exact against the plain version."""
    g = torch.Generator().manual_seed(c)
    flat = torch.randn(3 * 50 * c + 1, generator=g).to(cuda)
    for pts in (flat[: 3 * 50 * c].view(3, 50, c), flat[1:].view(3, 50, c)):
        for shape in ((3, 1), (3, 7), (3, 13, 3), (3, 31, 5)):
            idx = torch.randint(-4, 54, shape, generator=g, dtype=torch.int32).to(cuda)
            got = kernels.gather_points(pts, idx)
            assert torch.equal(got, pointops.gather_points(pts, idx)), (shape, pts.data_ptr() % 16)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 2047, 2049, 4095, 4097, 16384])
def test_ball_query_sizes_on_the_card(cuda, n):
    """The warp scan at N around a step of 32 and a shared-memory chunk of
    4096, with radii where some balls fill early and some never do, on a
    uniform cloud and one of duplicated points (equal distances): indices
    identical to the plain version, both radii and the one-radius form."""
    g = torch.Generator().manual_seed(100 + n)
    xyz = torch.rand((3, n, 3), generator=g)
    half = (n + 1) // 2
    xyz[1, half:] = xyz[1, : n - half].clone()
    xyz = xyz.to(cuda)
    cen = torch.cat([xyz[:, : min(n, 40)], torch.rand((3, 24, 3), generator=g).to(cuda)], 1)
    for r1, r2 in ((0.05, 0.1), (0.3, 0.6)):
        got = kernels.ball_query_pair(xyz, cen, r1, 16, r2, 32)
        want = pointops.ball_query_pair(xyz, cen, r1, 16, r2, 32)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (r1, r2)
        assert torch.equal(kernels.ball_query(xyz, cen, r2, 40), pointops.ball_query(xyz, cen, r2, 40))


def test_ball_query_boundaries_on_the_card(cuda):
    """Sources exactly at r (out: the compare is strict) and one float
    inside, empty balls, K > N, and the level-1 shape with balls that fill
    in their first steps (r .2 / .4): indices identical to the plain
    version."""
    r = 0.25
    inside = float(torch.nextafter(torch.tensor(r), torch.tensor(0.0)))
    pts = torch.tensor([[r, 0, 0], [0, -r, 0], [inside, 0, 0], [0, 0, -inside], [0.5, 0.5, 0.5]])
    xyz = pts.repeat(2, 20, 1).contiguous().to(cuda)
    cen = torch.zeros((2, 3, 3), device=cuda)
    cen[1] = 9.0  # empty balls
    for k1, k2 in ((6, 12), (50, 150)):
        got = kernels.ball_query_pair(xyz, cen, r, k1, 0.5, k2)
        want = pointops.ball_query_pair(xyz, cen, r, k1, 0.5, k2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (k1, k2)
    g = torch.Generator().manual_seed(6)
    cloud = torch.rand((4, 2048, 3), generator=g).to(cuda)
    got = kernels.ball_query_pair(cloud, cloud[:, :1024].contiguous(), 0.2, 16, 0.4, 32)
    want = pointops.ball_query_pair(cloud, cloud[:, :1024].contiguous(), 0.2, 16, 0.4, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("c", [1, 3, 4, 5, 33, 128, 512, 1029, 1030])
def test_three_interpolate_widths_on_the_card(cuda, c):
    """The float4 walk (C % 4 == 0, aligned) and the scalar one (other C,
    or features at no 16-byte boundary), indices below 0 and at or above M
    (clamped), N no multiple of the block's 8 rows: bit-exact."""
    g = torch.Generator().manual_seed(200 + c)
    flat = torch.randn(3 * 40 * c + 1, generator=g).to(cuda)
    idx = torch.randint(-3, 43, (3, 77, 3), generator=g, dtype=torch.int32).to(cuda)
    w = torch.rand((3, 77, 3), generator=g).to(cuda)
    for feats in (flat[: 3 * 40 * c].view(3, 40, c), flat[1:].view(3, 40, c)):
        got = kernels.three_interpolate(feats, idx, w)
        assert torch.equal(got, pointops.three_interpolate(feats, idx, w)), feats.data_ptr() % 16


# the five FP levels of the batch-4 reconstruct: (queries, sources) per cloud
THREE_NN_LEVELS = [(2048, 1024), (1024, 512), (512, 256), (256, 64), (64, 16)]


@pytest.mark.parametrize("nq, ns", THREE_NN_LEVELS)
def test_three_nn_reconstruct_shapes_on_the_card(cuda, nq, ns):
    """Each level's shape with the reconstruct's 40 clouds (and so its
    split of the sources over lanes): indices identical, distances exact."""
    g = torch.Generator().manual_seed(nq + ns)
    q = torch.rand((40, nq, 3), generator=g).to(cuda)
    s = torch.rand((40, ns, 3), generator=g).to(cuda)
    gd, gi = kernels.three_nn(q, s)
    wd, wi = pointops.three_nn(q, s)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("kind", ["duplicated", "grid"])
@pytest.mark.parametrize("b, nq, ns", [(3, 50, 3), (3, 50, 5), (40, 2048, 1024), (3, 70, 2049),
                                       (2, 33, 4097), (4, 1024, 16384)])
def test_three_nn_ties_on_the_card(cuda, kind, b, nq, ns):
    """Equal distances (every point several times; coordinates on a 1/4
    grid), Ns = 3, Ns at and past a staged chunk of 2048 and at (4, 16384)
    sources: the lower index first, as the plain version's stable sort."""
    g = torch.Generator().manual_seed(ns)
    if kind == "duplicated":
        base = torch.rand((b, max(1, ns // 3), 3), generator=g)
        s = base[:, torch.randint(0, base.shape[1], (ns,), generator=g)]
    else:
        s = torch.randint(0, 5, (b, ns, 3), generator=g).float() / 4
    q = torch.cat([s[:, : min(ns, nq // 2)],
                   torch.randint(0, 5, (b, nq - min(ns, nq // 2), 3), generator=g).float() / 4], 1)
    q, s = q.contiguous().to(cuda), s.contiguous().to(cuda)
    gd, gi = kernels.three_nn(q, s)
    wd, wi = pointops.three_nn(q, s)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_three_nn_split_follows_the_model(cuda):
    from caspr_tpu_torch.checks import three_nn_sa_arithmetic as model

    for b, nq in [(40, 2048), (40, 1024), (40, 512), (40, 256), (40, 64), (1, 1), (600, 2048)]:
        assert kernels.three_nn_split(b, nq) == model.three_nn_split(b, nq)


@pytest.mark.parametrize("shape", [
    (16, 16, 16, 32), (32, 32, 32, 64), (16, 32, 32, 64), (16, 64, 64, 128), (32, 64, 96, 128),
    (16, 128, 256, 256), (32, 128, 256, 256), (16, 256, 256, 512), (32, 256, 256, 512),
    (5, 64, 96, 128), (32, 512, 512, 512), (1, 16, 16, 16), (17, 48, 80, 496),
])
def test_sa_fused_instantiations_against_float64_on_the_card(cuda, shape):
    """Every instantiation (the encoder's nine (K; d1, d2, d3) and the
    generic one) on 3 x 37 centres, a ragged last tile for each: within
    1e-4 of each output's largest magnitude of the float64 plain version,
    two launches equal, and the instantiation the host picks is the one
    the CPU model names."""
    from caspr_tpu_torch.checks import three_nn_sa_arithmetic as model

    k, *dims = shape
    assert kernels.sa_fused_instance(*shape) == model.sa_config(*shape).instance
    t, u, gidx, sp = _sa_inputs(cuda, b=3, n=300, m=37, k=k, dims=tuple(dims))
    got = kernels.sa_fused(t, u, gidx, sp)
    assert torch.equal(got, kernels.sa_fused(t, u, gidx, sp))
    want = sa_fused.sa_stack_plain(t.double(), u.double(), gidx, _float64(sp))
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", [(16, 16, 16, 32), (32, 32, 32, 64), (5, 64, 96, 128)])
def test_sa_fused_balls_of_one_or_two_points_on_the_card(cuda, shape):
    """Balls of copies of one point, or of two, at the scale of radius
    0.02 (GroupNorm divides a spread far below its eps): within 1e-4 of
    each output's largest magnitude of the float64 plain version."""
    k, *dims = shape
    t, u, gidx, sp = _sa_inputs(cuda, b=3, n=300, m=37, k=k, dims=tuple(dims))
    g = torch.Generator().manual_seed(k)
    pick = torch.randint(0, 300, (3, 37, 2), generator=g, dtype=torch.int32)
    two = torch.where(torch.arange(k) < k // 3, pick[..., :1], pick[..., 1:]).to(cuda)
    t = (0.02 * t + t[:, :1]).contiguous()  # every row close to one value
    for idx in (pick[..., :1].expand(3, 37, k).contiguous().to(cuda), two.contiguous()):
        got = kernels.sa_fused(t, u, idx, sp)
        want = sa_fused.sa_stack_plain(t.double(), u.double(), idx, _float64(sp))
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-4
