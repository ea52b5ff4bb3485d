"""The bf16 mode's reach and its backward against the JAX package on the CPU.

Where the bf16 matmul mode applies is the JAX package's rule, its
``can_fuse`` (``ops.cnf_fused.bf16_takes`` in the port): the JAX package
runs its Pallas kernels, and so their bf16 products, only there
(caspr_tpu/models/cnf.py::_dynamics_kernel_mode).  Its backward is the
float32 VJP by default and, with ``CNFConfig.bwd_matmul_dtype="bf16"``, the
VJP kernel with every product's operands rounded to bfloat16
(caspr_tpu/ops/cnf_fused.py::_fused_bwd_call with matmul_dtype="bf16", the
JAX package's CASPR_TPU_CNF_BWD=pallas under CASPR_TPU_CNF_MATMUL=bf16).
The JAX side runs its Pallas kernels in interpret mode, with its
environment set by the test alone (monkeypatch).  Inputs come from numpy
seeds and JAX's ``odenet_init`` and go to both sides.

Tolerances, each relative to the JAX value's largest magnitude:
  - the field where the JAX package runs float32 (its composition): 1e-5,
    float32 sums in another order;
  - the field where it rounds: 2e-3 (two sums on either side of a bfloat16
    rounding boundary move a value by one unit, 2^-8 relative, and the next
    layer carries it on);
  - the bf16 VJP against ``_fused_bwd_call(..., "bf16")``: 2e-3 for each
    output, within 1.5x JAX's distance from the float64 VJP without
    rounding (the port rounds where JAX does, not more), and nearer to
    JAX's bf16 VJP than to the port's float32 one (the mode is on);
  - gradients through the bf16 backward: 2e-3 per leaf; through the
    default backward at widths past the kernels: 1e-5 (both float32 VJPs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu_torch.models import cnf
from caspr_tpu_torch.models.caspr import CaSPRConfig
from caspr_tpu_torch.ops import cnf_fused, kernels
from test_torch_port_cnf_layers import _t, _to_torch
from test_torch_port_model import torch_threads  # noqa: F401  (one PyTorch thread)

F32_TOL, BF16_TOL, VS64_RATIO = 1e-5, 2e-3, 1.5
ZDIM, CLOUDS, POINTS = 16, 2, 200


def _rel(got, want):
    """Largest error over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _params(dims, seed):
    jparams = jcnf.odenet_init(jax.random.PRNGKey(seed),
                               jcnf.CNFConfig(input_dim=3, dims=dims, zdim=ZDIM))
    return jparams, _to_torch(jax.tree_util.tree_map(np.asarray, jparams))


def _field_inputs(seed):
    rng = np.random.default_rng(seed)
    ctx = (0.5 * rng.standard_normal((CLOUDS, ZDIM))).astype(np.float32)
    y, e = rng.standard_normal((2, CLOUDS, POINTS, 3)).astype(np.float32)
    ct_dx = rng.standard_normal((CLOUDS, POINTS, 3)).astype(np.float32)
    ct_div = rng.standard_normal((CLOUDS, POINTS)).astype(np.float32)
    return ctx, y, e, ct_dx, ct_div


# (dims, whether the JAX package rounds: its can_fuse)
FIELD_DIMS = [((32, 32), False), ((96, 96), False), ((128,) * 5, False),
              ((1024, 1024), True), ((128, 128), True)]


@pytest.mark.parametrize("dims,rounds", FIELD_DIMS, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_bf16_reaches_where_the_jax_package_rounds(dims, rounds, monkeypatch):
    """The field (primal, and with the divergence) of CNFConfig(dims,
    matmul_dtype="bf16") against the JAX package's dynamics under
    CASPR_TPU_CNF_KERNEL=pallas and CASPR_TPU_CNF_MATMUL=bf16: float32 where
    can_fuse is false (and then the port's bf16 config gives the float32
    config's bits), rounded where it holds."""
    monkeypatch.setenv("CASPR_TPU_CNF_KERNEL", "pallas")
    monkeypatch.setenv("CASPR_TPU_CNF_MATMUL", "bf16")
    jcfg = jcnf.CNFConfig(input_dim=3, dims=dims, zdim=ZDIM)
    assert jcnf_fused.can_fuse(jcfg) is rounds
    jparams, params = _params(dims, 3)
    ctx, y, e, _, _ = _field_inputs(3)
    t = 0.3
    args = {"params": jparams, "context": jnp.asarray(ctx), "e": jnp.asarray(e)}
    flat = jnp.asarray(y.reshape(CLOUDS, -1))
    with pltpu.force_tpu_interpret_mode():
        want_primal = jcnf._make_dynamics(jcfg, reverse=False, with_div=False)(t, flat, args)
        want_dx, want_div = jcnf._make_dynamics(jcfg, reverse=False, with_div=True)(
            t, (flat, jnp.zeros((CLOUDS, POINTS))), args)
    tc = torch.cat([torch.full((CLOUDS, 1), t), _t(ctx)], dim=1)
    runs = {}
    for mode in ("f32", "bf16"):
        ccfg = cnf.CNFConfig(input_dim=3, dims=dims, zdim=ZDIM, matmul_dtype=mode)
        runs[mode] = (cnf.odenet_primal(params, ccfg, tc, _t(y)),
                      *cnf.odenet_dynamics(params, ccfg, tc, _t(y), _t(e)))
    assert cnf_fused.bf16_takes(ccfg) is rounds
    got = runs["bf16"]
    wants = (np.asarray(want_primal).reshape(CLOUDS, POINTS, 3),
             np.asarray(want_dx).reshape(CLOUDS, POINTS, 3), -np.asarray(want_div))
    tol = BF16_TOL if rounds else F32_TOL
    for name, g, w in zip(("primal", "dx", "div"), got, wants):
        assert _rel(g.detach(), w) <= tol, (name, _rel(g.detach(), w))
    for name, a, b in zip(("primal", "dx", "div"), runs["f32"], got):
        if rounds:  # the mode is on
            assert not torch.equal(a, b), name
        else:  # bf16 is not read: the float32 bits
            assert torch.equal(a, b), name


@pytest.mark.parametrize("direction", ["primal", "dynamics"])
def test_default_gradient_past_the_kernels_is_the_float32_vjp(direction, monkeypatch):
    """At (1024, 1024), where the JAX package runs its bf16 kernel and the
    port the rounded composition, the default backward is the float32 VJP
    at the inputs in both (_fused_primal_bwd, and _fused_bwd under the
    default CASPR_TPU_CNF_BWD): every leaf within 1e-5 of jax.grad's."""
    monkeypatch.setenv("CASPR_TPU_CNF_KERNEL", "pallas")
    monkeypatch.setenv("CASPR_TPU_CNF_MATMUL", "bf16")
    monkeypatch.delenv("CASPR_TPU_CNF_BWD", raising=False)
    dims = (1024, 1024)
    jparams, params = _params(dims, 5)
    ctx, y, e, ct_dx, ct_div = _field_inputs(5)
    tc = np.concatenate([np.full((CLOUDS, 1), 0.3, np.float32), ctx], axis=1)

    def jloss(p, c, yy):
        with pltpu.force_tpu_interpret_mode():
            if direction == "primal":
                return jnp.sum(jcnf_fused.fused_concatsquash_primal(p, c, yy, "bf16") * ct_dx)
            dx, div = jcnf_fused.fused_concatsquash_dynamics(p, c, yy, jnp.asarray(e), "bf16")
        return jnp.sum(dx * ct_dx) + jnp.sum(div * ct_div)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jparams, jnp.asarray(tc), jnp.asarray(y))
    got = _port_grads(params, cnf.CNFConfig(input_dim=3, dims=dims, zdim=ZDIM,
                                            matmul_dtype="bf16"),
                      tc, y, e, ct_dx, ct_div, direction)
    wants = jax.tree_util.tree_leaves(want[0]) + [want[1], want[2]]
    assert len(got) == len(wants)
    for g, w in zip(got, wants):
        assert _rel(g, w) <= F32_TOL, (tuple(w.shape), _rel(g, w))


def _port_grads(params, ccfg, tc, y, e, ct_dx, ct_div, direction="dynamics"):
    """Every leaf's gradient of the port's loss, then tc's and y's."""
    leaves = jax.tree_util.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    c, points = _t(tc).requires_grad_(), _t(y).requires_grad_()
    if direction == "primal":
        loss = (cnf.odenet_primal(params, ccfg, c, points) * _t(ct_dx)).sum()
    else:
        dx, div = cnf.odenet_dynamics(params, ccfg, c, points, _t(e))
        loss = (dx * _t(ct_dx)).sum() + (div * _t(ct_div)).sum()
    loss.backward()
    return [leaf.grad for leaf in leaves] + [c.grad, points.grad]


@pytest.mark.parametrize("dims", [(128, 128), (128, 128, 128), (512, 512, 512)],
                         ids=lambda d: "x".join(map(str, d)))
def test_bf16_plain_vjp_matches_the_jax_bf16_vjp_kernel(dims):
    """dynamics_vjp_packed(..., "bf16") against _fused_bwd_call(...,
    matmul_dtype="bf16") in interpret mode on the same packed inputs (seed
    9, the gradient test's).  The two round the same values where their
    float32 sums agree; where a sum in the other order crosses a bfloat16
    rounding boundary, the operand moves by a unit and the layers below
    carry it on.  dy, per point a sum over the channels of terms that
    largely cancel, feels that most: at (512, 512, 512) with seed 7 its
    distance is 2.04e-3, above the bar, while the port and JAX stay 6.69e-3
    from the float64 VJP, equal to three digits (dgb and the dW within
    4e-4 there)."""
    jparams, params = _params(dims, 9)
    ctx, y, e, ct_dx, ct_div = _field_inputs(9)
    tc = np.concatenate([np.full((CLOUDS, 1), 0.4, np.float32), ctx], axis=1)
    jw = jcnf_fused._pack_weights(jparams)
    with pltpu.force_tpu_interpret_mode():
        want = jcnf_fused._fused_bwd_call(
            *jw, jcnf_fused._context_gb(jparams, jnp.asarray(tc)), jnp.asarray(y),
            jnp.asarray(e), jnp.asarray(ct_dx), jnp.asarray(ct_div), matmul_dtype="bf16")
    want = [np.asarray(w) for w in want]
    want[2], want[4] = want[2][:, :3], want[4][:3]  # the JAX package pads D to 8
    gb, w = cnf_fused.context_gb(params, _t(tc)), cnf_fused.pack_weights(params)
    args = (_t(y), _t(e), gb, *w, _t(ct_dx), _t(ct_div))
    got = cnf_fused.dynamics_vjp_packed(*args, "bf16")
    f32 = cnf_fused.dynamics_vjp_packed(*args)
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    for name, g, wnt, f, x in zip(("dy", "dgb", "dw_first", "dw_hidden", "dw_last"), got, want,
                                  f32, exact):
        err, ours, theirs = _rel(g, wnt), _rel(g, x), _rel(wnt, x)
        assert err <= BF16_TOL, (name, err)
        assert ours <= VS64_RATIO * theirs, (name, "from float64: port", ours, "JAX", theirs)
        assert err < _rel(f, wnt), (name, "nearer the float32 VJP", err, _rel(f, wnt))


@pytest.mark.parametrize("dims", [(128, 128), (1024, 1024)], ids=lambda d: "x".join(map(str, d)))
def test_gradient_through_the_bf16_backward_matches_jax(dims, monkeypatch):
    """The gradient of a loss through the dynamics with
    bwd_matmul_dtype="bf16" -- the VJP kernel's plain version at (128, 128),
    the rounded composition's at (1024, 1024) -- against jax.grad through
    fused_concatsquash_dynamics(..., "bf16") under CASPR_TPU_CNF_BWD=pallas."""
    monkeypatch.setenv("CASPR_TPU_CNF_BWD", "pallas")
    jparams, params = _params(dims, 9)
    ctx, y, e, ct_dx, ct_div = _field_inputs(9)
    tc = np.concatenate([np.full((CLOUDS, 1), 0.2, np.float32), ctx], axis=1)

    def jloss(p, c, yy):
        dx, div = jcnf_fused.fused_concatsquash_dynamics(p, c, yy, jnp.asarray(e), "bf16")
        return jnp.sum(dx * ct_dx) + jnp.sum(div * ct_div)

    with pltpu.force_tpu_interpret_mode():  # the forward's and the backward's kernels
        want = jax.grad(jloss, argnums=(0, 1, 2))(jparams, jnp.asarray(tc), jnp.asarray(y))
    ccfg = cnf.CNFConfig(input_dim=3, dims=dims, zdim=ZDIM, matmul_dtype="bf16",
                         bwd_matmul_dtype="bf16")
    assert cnf.matmul_mode(ccfg) == ("bf16", "bf16")
    got = _port_grads(params, ccfg, tc, y, e, ct_dx, ct_div)
    wants = jax.tree_util.tree_leaves(want[0]) + [want[1], want[2]]
    assert len(got) == len(wants)
    for g, w in zip(got, wants):
        assert _rel(g, w) <= BF16_TOL, (tuple(w.shape), _rel(g, w))


# --------------------------------- pins -----------------------------------


@pytest.mark.parametrize("kw", [
    dict(dims=(512, 512, 512)), dict(dims=(128, 128)), dict(dims=(1024, 1024)),
    dict(dims=(32, 32)), dict(dims=(96, 96)), dict(dims=(128,) * 5), dict(dims=(128,)),
    dict(dims=(256, 128)), dict(dims=(128, 128), layer_type="concat"),
    dict(dims=(128, 128), nonlinearity="tanh"), dict(dims=(128, 128), input_dim=9),
], ids=str)
def test_bf16_takes_is_can_fuse(kw):
    """The port's copy of the JAX package's rule, read from the same config."""
    assert cnf_fused.bf16_takes(cnf.CNFConfig(**kw)) is jcnf_fused.can_fuse(jcnf.CNFConfig(**kw))


def test_bwd_matmul_dtype_defaults_and_refusals():
    assert cnf.CNFConfig().bwd_matmul_dtype == "f32"
    assert CaSPRConfig().cnf_bwd_matmul_dtype == "f32"
    assert CaSPRConfig().cnf_config().bwd_matmul_dtype == "f32"
    cfg = CaSPRConfig(cnf_matmul_dtype="bf16", cnf_bwd_matmul_dtype="bf16").cnf_config()
    assert (cfg.matmul_dtype, cfg.bwd_matmul_dtype) == ("bf16", "bf16")
    assert cnf.matmul_mode(cfg) == ("bf16", "bf16")
    assert cnf.matmul_mode(CaSPRConfig(cnf_matmul_dtype="bf16").cnf_config()) == ("bf16", "f32")
    # the mode is not read where the JAX package would not round
    assert cnf.matmul_mode(cnf.CNFConfig(dims=(32, 32), matmul_dtype="bf16",
                                         bwd_matmul_dtype="bf16")) == ("f32", "f32")
    with pytest.raises(ValueError, match="matmul_dtype"):
        cnf.CNFConfig(matmul_dtype="bf16", bwd_matmul_dtype="fp16")
    with pytest.raises(ValueError, match="needs matmul_dtype='bf16'"):
        cnf.CNFConfig(bwd_matmul_dtype="bf16")
    with pytest.raises(ValueError, match="needs matmul_dtype='bf16'"):
        CaSPRConfig(cnf_bwd_matmul_dtype="bf16").cnf_config()


def test_cpu_vjp_wrapper_takes_the_bf16_plain_version():
    g = torch.Generator().manual_seed(4)
    y, e, ct_dx = torch.randn((3, 2, 40, 3), generator=g)
    ct_div = torch.randn((2, 40), generator=g)
    gb = torch.rand((2, 8, 64), generator=g)
    w = (torch.randn((64, 3), generator=g), torch.randn((2, 64, 64), generator=g) / 8,
         torch.randn((3, 64), generator=g) / 8)
    kernels.reset_launches()
    got = kernels.cnf_dynamics_vjp(y, e, gb, *w, ct_dx, ct_div, "bf16")
    for a, b in zip(got, cnf_fused.dynamics_vjp_packed(y, e, gb, *w, ct_dx, ct_div, "bf16")):
        assert torch.equal(a, b)
    # the float32 VJP is untouched by the mode's code
    for a, b in zip(kernels.cnf_dynamics_vjp(y, e, gb, *w, ct_dx, ct_div), got):
        assert not torch.equal(a, b)
    assert not any(kernels.launches.values())
    with pytest.raises(ValueError, match="matmul_dtype"):
        kernels.cnf_dynamics_vjp(y, e, gb, *w, ct_dx, ct_div, "fp16")
    with pytest.raises(ValueError, match="matmul_dtype"):
        kernels.cnf_dynamics(y, e, gb, *w, "bf16", "fp16")


def test_backward_dtype_reaches_the_vjp_wrapper(monkeypatch):
    """The forward and backward dtypes are separate: the bf16 forward keeps
    the float32 VJP by default, and bwd_matmul_dtype="bf16" sends the bf16
    one, through cnf_dynamics's autograd (the adjoint's and the discrete
    backward's route)."""
    calls = []
    real = kernels.cnf_dynamics_vjp
    monkeypatch.setattr(kernels, "cnf_dynamics_vjp",
                        lambda *a: calls.append(a[8:]) or real(*a))
    g = torch.Generator().manual_seed(6)
    y, e = torch.randn((2, 2, 30, 3), generator=g)
    gb = torch.rand((2, 8, 32), generator=g)
    w = (torch.randn((32, 3), generator=g), torch.randn((1, 32, 32), generator=g) / 6,
         torch.randn((3, 32), generator=g) / 6)
    for fwd, bwd in (("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")):
        points = y.clone().requires_grad_()
        dx, div = kernels.cnf_dynamics(points, e, gb, *w, fwd, bwd)
        (dx.sum() + div.sum()).backward()
    assert calls == [("f32",), ("f32",), ("bf16",)]
