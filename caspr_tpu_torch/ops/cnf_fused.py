"""The CNF dynamics: the ODEnet of every diffeq layer type and nonlinearity,
and the fused concatsquash kernels around it.

The ODEnet (the paper's 3 -> 512 -> 512 -> 512 -> 3) runs once per solver
step of every CNF solve.  Each layer is one of the seven context-conditioned
layer types of the JAX package (caspr_tpu/models/cnf.py::_layer_apply),
applied to y with tc = [t, context]:

  ignore        L(y)
  concat        L([y, tc])        (computed as y W_y^T + (tc W_c^T + b))
  concat_v2     L(y) + H_b(tc)
  squash        L(y) * sigmoid(H(tc))
  scale         L(y) * H(tc)
  concatsquash  L(y) * sigmoid(H_g(tc)) + H_b(tc)
  concatscale   L(y) * H_g(tc) + H_b(tc)

with L the layer's own linear map and H, H_g, H_b the hyper layers
(``_hyper``, ``_hyper_gate``, ``_hyper_bias``; H_b without bias), and one
of tanh, relu, softplus, elu, square, identity or swish (``v *
sigmoid(beta_i v)``, beta_i the layer's learned ``swish_beta``) between
layers (``odenet_apply``).  ``reference_primal`` computes f(y),
``reference_dynamics`` (f(y), e^T J_f(y) e) with an analytic tangent: the
gate and the additive terms do not depend on y, so a layer's tangent is
``(e W^T) * gate`` (only y's columns of concat's weight; no gate for the
types without one), times the activation's derivative at the primal
pre-activation, the slope JAX's own functions give (relu's 0 at 0, elu's
exp below 0).  Autograd through it is the adjoint's VJP.

For concatsquash with softplus the context-dependent part of each layer --
a sigmoid gate and an effective bias per (cloud, channel) -- is computed
here in plain PyTorch, a (BT, 1+zdim) x (1+zdim, H) product per layer, and
where the config fits them (``kernel_takes``) the per-point work goes to a
kernel that keeps every activation on chip: ``ops.kernels.cnf_primal`` for
the points alone, ``ops.kernels.cnf_dynamics`` for the points and the
Hutchinson tangent J e, giving e^T J e.  The JAX package has a kernel for
that config alone (caspr_tpu/ops/cnf_fused.py::can_fuse), and so does the
port, at its own widths: any other config runs the composition on either
device.

The fused kernels have two arithmetic modes, ``matmul_dtype`` "f32" (the
default: every product at float32 accuracy) and "bf16", the JAX package's
CASPR_TPU_CNF_MATMUL=bf16 (caspr_tpu/ops/cnf_fused.py ``mm``): both operands
of every layer product -- the points and the Hutchinson noise into the first
layer, the activations into the others, and every weight -- are rounded to
bfloat16 (nearest, ties to even) and the product accumulates in float32; the
gates, biases, softplus, its sigmoid and the divergence's sum stay float32.
The composition has one mode, float32, as the JAX package's
``odenet_apply``, but for the bf16 configs past the kernels' widths below.

Where bf16 applies is the JAX package's rule, ``bf16_takes`` (its
``can_fuse``: widths a multiple of 128, two or three layers of them), not
the kernels' reach: a config the kernels take but ``can_fuse`` does not
runs the kernels in float32, and a config ``can_fuse`` takes but the kernels
do not (widths of 640 and up) runs ``primal_packed`` / ``dynamics_packed``
with their products rounded (``rounded_primal``, ``rounded_dynamics``).
The VJP is float32 by default, the JAX package's default backward, and
with ``bwd_matmul_dtype="bf16"`` the bf16 form of ``dynamics_vjp_packed``
(its CASPR_TPU_CNF_BWD=pallas under CASPR_TPU_CNF_MATMUL=bf16).
"""

from __future__ import annotations

import torch

from ..nn import linear


# What the fused kernels take (csrc/cnf_tc.cuh, csrc/cnf_dynamics_vjp.cu): the
# point dimension, the hidden width (a multiple of KERNEL_WIDTH_STEP up to
# KERNEL_MAX_WIDTH) and the number of hidden-to-hidden layers.
KERNEL_MAX_DIM = 8
KERNEL_WIDTH_STEP = 32
KERNEL_MAX_WIDTH = 512
KERNEL_HIDDEN_LAYERS = (1, 6)
MATMUL_DTYPES = ("f32", "bf16")
BF16_WIDTH_STEP = 128  # the JAX package's lane width (can_fuse)


def kernel_takes(cfg) -> bool:
    """Whether the ODEnet of a CNF config runs in the fused kernels: the
    port's counterpart of caspr_tpu/ops/cnf_fused.py::can_fuse, read from
    the config alone.  Concatsquash layers with softplus, D <= 8, every
    hidden width equal, a multiple of 32 and at most 512, and 1-6
    hidden-to-hidden layers (the training VJP's range).  Any other config
    runs the unfused composition (``reference_primal``,
    ``reference_dynamics``) on either device, as the JAX package runs
    ``odenet_apply`` for a config its kernel does not take."""
    dims = tuple(cfg.dims)
    lo, hi = KERNEL_HIDDEN_LAYERS
    return (
        cfg.layer_type == "concatsquash"
        and cfg.nonlinearity == "softplus"
        and 1 <= cfg.input_dim <= KERNEL_MAX_DIM
        and len(set(dims)) == 1
        and dims[0] % KERNEL_WIDTH_STEP == 0
        and dims[0] <= KERNEL_MAX_WIDTH
        and lo <= len(dims) - 1 <= hi
    )


def bf16_takes(cfg) -> bool:
    """Whether the bf16 matmul mode applies to a CNF config: the port's copy
    of caspr_tpu/ops/cnf_fused.py::can_fuse, the JAX package's rule for
    running its kernels (and so their bf16 products).  Concatsquash layers
    with softplus, D <= 8, two or three hidden widths (its 2L gate and bias
    rows fill at most 8), all equal and a multiple of 128."""
    dims = tuple(cfg.dims)
    return (
        cfg.layer_type == "concatsquash"
        and cfg.nonlinearity == "softplus"
        and cfg.input_dim <= KERNEL_MAX_DIM
        and len(dims) in (2, 3)
        and len(set(dims)) == 1
        and dims[0] % BF16_WIDTH_STEP == 0
    )


def check_matmul_dtype(matmul_dtype: str) -> str:
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}, got {matmul_dtype!r}")
    return matmul_dtype


def _operand(matmul_dtype: str):
    """What a layer product does to each operand: nothing in "f32", a
    rounding to bfloat16 in "bf16" (a product of two bfloat16 values is exact
    in float32, so the float32 product of the rounded operands is the
    bfloat16 product with float32 accumulation)."""
    if check_matmul_dtype(matmul_dtype) == "bf16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    return lambda t: t


def softplus(x):
    """logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), the form of
    jax.nn.softplus (torch's F.softplus switches to x above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def context_gb(params, tc):
    """Gates and effective biases of every layer from tc = [t, context].

    params: odenet params {"layers": [...]}; tc: (BT, 1+zdim).  Returns
    (BT, max(8, 2L), H): rows 0..L-1 are sigmoid gates, rows L..2L-1 are
    bias*gate + hyper_bias, and the last layer's rows are zero past its
    output channels."""
    layers = params["layers"]
    h = layers[0]["_layer"]["weight"].shape[0]
    gates, beffs = [], []
    for lp in layers:
        g = torch.sigmoid(linear(lp["_hyper_gate"], tc))
        be = lp["_layer"]["bias"] * g + linear(lp["_hyper_bias"], tc)
        pad = h - g.shape[-1]
        gates.append(torch.nn.functional.pad(g, (0, pad)))
        beffs.append(torch.nn.functional.pad(be, (0, pad)))
    gb = torch.stack(gates + beffs, dim=1)
    if gb.shape[1] < 8:
        gb = torch.nn.functional.pad(gb, (0, 0, 0, 8 - gb.shape[1]))
    return gb.contiguous()


def pack_weights(params):
    """(w_first (H, D), w_hidden (L-2, H, H), w_last (D, H)) in the stored
    (out, in) layout."""
    layers = params["layers"]
    w_first = layers[0]["_layer"]["weight"].contiguous()
    w_hidden = torch.stack([lp["_layer"]["weight"] for lp in layers[1:-1]])
    w_last = layers[-1]["_layer"]["weight"].contiguous()
    return w_first, w_hidden.contiguous(), w_last


def primal_packed(y, gb, w_first, w_hidden, w_last, matmul_dtype: str = "f32"):
    """The kernel's function in plain PyTorch: per layer
    ``(z @ W^T) * gate + beff``, softplus on all but the last, the products'
    operands as ``matmul_dtype`` says.  y: (BT, N, D) -> dx (BT, N, D)."""
    rnd = _operand(matmul_dtype)
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    z = y
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        z = torch.matmul(rnd(z), rnd(w).T) * gate + beff
        if i < num_layers - 1:
            z = softplus(z)
    return z


def _act(name: str, beta=None):
    """(f, f') of a nonlinearity between layers, with the slope of JAX's own
    function (the tangent jax.jvp takes through it)."""
    if name == "tanh":
        return torch.tanh, lambda v: 1.0 - torch.tanh(v) ** 2
    if name == "relu":
        return torch.relu, lambda v: (v > 0).to(v.dtype)
    if name == "softplus":
        return softplus, torch.sigmoid
    if name == "elu":
        # jax.nn.elu: where(v > 0, v, expm1(where(v > 0, 0, v)))
        safe = lambda v: torch.where(v > 0, torch.zeros_like(v), v)
        return (lambda v: torch.where(v > 0, v, torch.expm1(safe(v))),
                lambda v: torch.where(v > 0, torch.ones_like(v), torch.exp(safe(v))))
    if name == "square":
        return torch.square, lambda v: 2.0 * v
    if name == "identity":
        return (lambda v: v), torch.ones_like
    if name == "swish":
        def grad(v):
            s = torch.sigmoid(beta * v)
            return s + v * (beta * (s * (1.0 - s)))
        return (lambda v: v * torch.sigmoid(beta * v)), grad
    raise ValueError(f"unknown nonlinearity {name!r}")


def _acts(params, nonlinearity: str):
    """(f, f') of each layer but the last."""
    n = len(params["layers"]) - 1
    if nonlinearity == "swish":
        return [_act("swish", params["swish_beta"][i]) for i in range(n)]
    return [_act(nonlinearity)] * n


def _layer_terms(lp, layer_type: str, tc):
    """A layer as (weight on the points, its (out, in) columns of y; the map
    of y, ``z -> z W^T + inner``; the gate or None; the bias after the gate
    or None), the last three from tc."""
    w = lp["_layer"]["weight"]
    if layer_type == "concat":
        # [y, tc] W^T + b split into y's columns and tc's: the context part
        # is one (BT, 1+zdim) product, not a (BT, N, 1+zdim) broadcast
        d_in = w.shape[1] - tc.shape[1]
        ctx = (torch.matmul(tc, w[:, d_in:].T) + lp["_layer"]["bias"])[:, None, :]
        return w[:, :d_in], lambda z: torch.matmul(z, w[:, :d_in].T) + ctx, None, None
    apply = lambda z: linear(lp["_layer"], z)
    if layer_type == "ignore":
        return w, apply, None, None
    if layer_type == "concat_v2":
        return w, apply, None, linear(lp["_hyper_bias"], tc)[:, None, :]
    if layer_type == "squash":
        return w, apply, torch.sigmoid(linear(lp["_hyper"], tc))[:, None, :], None
    if layer_type == "scale":
        return w, apply, linear(lp["_hyper"], tc)[:, None, :], None
    if layer_type == "concatsquash":
        gate = torch.sigmoid(linear(lp["_hyper_gate"], tc))[:, None, :]
        return w, apply, gate, linear(lp["_hyper_bias"], tc)[:, None, :]
    if layer_type == "concatscale":
        gate = linear(lp["_hyper_gate"], tc)[:, None, :]
        return w, apply, gate, linear(lp["_hyper_bias"], tc)[:, None, :]
    raise ValueError(f"unknown diffeq layer type {layer_type!r}")


def _primal_layer(terms, z):
    _, apply, gate, bias = terms
    z = apply(z)
    if gate is not None:
        z = z * gate
    return z if bias is None else z + bias


def reference_primal(params, tc, y, layer_type: str = "concatsquash",
                     nonlinearity: str = "softplus"):
    """The unfused ODEnet f(y) of a layer type and nonlinearity
    (caspr_tpu/models/cnf.py::odenet_apply; for concatsquash with softplus
    caspr_tpu/ops/cnf_fused.py::_reference_primal)."""
    acts = _acts(params, nonlinearity)
    dx = y
    for i, lp in enumerate(params["layers"]):
        dx = _primal_layer(_layer_terms(lp, layer_type, tc), dx)
        if i < len(acts):
            dx = acts[i][0](dx)
    return dx


def dynamics_packed(y, e, gb, w_first, w_hidden, w_last, matmul_dtype: str = "f32"):
    """The with-divergence kernel's function in plain PyTorch.  Per layer
    ``m = z @ W^T`` for both streams, primal ``zp = m_p * gate + beff``,
    tangent ``zt = m_t * gate``; on all but the last layer ``zt *=
    sigmoid(zp)`` (the pre-activation) and ``zp = softplus(zp)``; the
    products' operands as ``matmul_dtype`` says (the divergence's e stays
    float32).  y, e: (BT, N, D) -> (dx (BT, N, D), div (BT, N) = sum_d (J
    e)_d e_d)."""
    rnd = _operand(matmul_dtype)
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    zp, zt = y, e
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        wt = rnd(w).T
        zp = torch.matmul(rnd(zp), wt) * gate + beff
        zt = torch.matmul(rnd(zt), wt) * gate
        if i < num_layers - 1:
            zt = zt * torch.sigmoid(zp)
            zp = softplus(zp)
    return zp, (zt * e).sum(dim=-1)


def dynamics_vjp_packed(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div,
                        matmul_dtype: str = "f32"):
    """The VJP of ``dynamics_packed`` with respect to y, gb and the
    weights, in plain PyTorch: the function of the cnf_dynamics_vjp kernel
    (caspr_tpu/ops/cnf_fused.py::_fused_bwd_kernel, in the stream-stacked
    form of ``_manual_dynamics_vjp``).  e is a constant: no d/de.
    ``matmul_dtype="bf16"`` rounds both operands of its three products as
    that kernel's ``mm`` does -- the forward recompute z W^T (so m, s and
    t_pre are the bf16 forward's), the weight gradient dm^T z and the input
    cotangent dm W -- and keeps the gates, sigmoids, dppre, dtpre and the
    dgb sums float32.

    The forward is recomputed keeping each layer's input z_l and pre-gate
    product m_l = z_l @ W_l^T of both streams, stacked along the points
    (primal rows 0..N-1, tangent rows N..2N-1).  The reverse sweep, from
    cotangents cp = ct_dx on the primal output and ct = ct_div * e on the
    tangent output, runs per layer
      dppre = cp * s + ct * t_pre * s * (1 - s),  dtpre = ct * s
    (s the sigmoid of the primal pre-activation, t_pre the gated tangent;
    on the last layer dppre = cp, dtpre = ct), then
      d beff = sum_points dppre,  d gate = sum_points (dppre m_p + dtpre m_t),
      dm = [dppre; dtpre] * gate,  dW = dm^T z,  [cp; ct] = dm W.
    Returns (dy (BT, N, D), dgb (BT, G, H) laid out as gb, dw_first (H, D),
    dw_hidden (L-2, H, H), dw_last (D, H)); dgb and the dW are summed over
    the points (and the dW over the clouds)."""
    rnd = _operand(matmul_dtype)
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    n = y.shape[1]
    z = torch.cat([y, e], dim=1)
    zs, ms = [], []
    for i, w in enumerate(weights):
        zs.append(z)
        m = torch.matmul(rnd(z), rnd(w).T)
        ms.append(m)
        if i < num_layers - 1:
            d_out = w.shape[0]
            pre_p = m[:, :n] * gb[:, i, None, :d_out] + gb[:, num_layers + i, None, :d_out]
            pre_t = m[:, n:] * gb[:, i, None, :d_out]
            z = torch.cat([softplus(pre_p), pre_t * torch.sigmoid(pre_p)], dim=1)
    cp, ct = ct_dx, ct_div[..., None] * e
    dgb = torch.zeros_like(gb)
    dws = [None] * num_layers
    for i in range(num_layers - 1, -1, -1):
        w, m = weights[i], ms[i]
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        if i == num_layers - 1:
            dppre, dtpre = cp, ct
        else:
            pre_p = m[:, :n] * gate + gb[:, num_layers + i, None, :d_out]
            pre_t = m[:, n:] * gate
            s = torch.sigmoid(pre_p)
            dppre = cp * s + ct * pre_t * s * (1.0 - s)
            dtpre = ct * s
        dgb[:, num_layers + i, :d_out] = dppre.sum(dim=1)
        dgb[:, i, :d_out] = (dppre * m[:, :n] + dtpre * m[:, n:]).sum(dim=1)
        dm = rnd(torch.cat([dppre, dtpre], dim=1) * gate)
        dws[i] = torch.matmul(dm.reshape(-1, d_out).T, rnd(zs[i]).reshape(-1, w.shape[1]))
        dz = torch.matmul(dm, rnd(w))
        cp, ct = dz[:, :n], dz[:, n:]
    return cp, dgb, dws[0], torch.stack(dws[1:-1]), dws[-1]


class _RoundedPrimal(torch.autograd.Function):
    """``primal_packed`` with its products in bf16; its backward the float32
    VJP at the inputs, as the JAX package's _fused_primal_bwd differentiates
    the float32 composition (autograd through the rounding would round the
    cotangents too)."""

    @staticmethod
    def forward(ctx, y, gb, w_first, w_hidden, w_last):
        ctx.save_for_backward(y, gb, w_first, w_hidden, w_last)
        return primal_packed(y, gb, w_first, w_hidden, w_last, "bf16")

    @staticmethod
    def backward(ctx, ct):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = primal_packed(*inputs)
        return torch.autograd.grad(out, inputs, ct)


class _RoundedDynamics(torch.autograd.Function):
    """``dynamics_packed`` with its products in bf16; its backward
    ``dynamics_vjp_packed`` in ``bwd_matmul_dtype`` (e is a constant)."""

    @staticmethod
    def forward(ctx, y, e, gb, w_first, w_hidden, w_last, bwd_matmul_dtype):
        ctx.save_for_backward(y, e, gb, w_first, w_hidden, w_last)
        ctx.bwd_matmul_dtype = bwd_matmul_dtype
        return dynamics_packed(y, e, gb, w_first, w_hidden, w_last, "bf16")

    @staticmethod
    def backward(ctx, ct_dx, ct_div):
        dy, dgb, dwf, dwh, dwl = dynamics_vjp_packed(*ctx.saved_tensors, ct_dx, ct_div,
                                                     ctx.bwd_matmul_dtype)
        return dy, None, dgb, dwf, dwh, dwl, None


def rounded_primal(y, gb, w_first, w_hidden, w_last):
    """The bf16 field of a config ``bf16_takes`` but the kernels do not
    (widths of 640 and up), on either device: the JAX package runs its bf16
    kernel there, the port the composition with the kernel's roundings.  No
    kernel is launched."""
    return _RoundedPrimal.apply(y, gb, w_first, w_hidden, w_last)


def rounded_dynamics(y, e, gb, w_first, w_hidden, w_last, bwd_matmul_dtype: str = "f32"):
    """``rounded_primal``'s counterpart with the divergence: (dx, div) with
    the products in bf16, its VJP float32 or, with ``bwd_matmul_dtype="bf16"``,
    ``dynamics_vjp_packed`` in bf16."""
    check_matmul_dtype(bwd_matmul_dtype)
    return _RoundedDynamics.apply(y, e, gb, w_first, w_hidden, w_last, bwd_matmul_dtype)


def reference_dynamics(params, tc, y, e, layer_type: str = "concatsquash",
                       nonlinearity: str = "softplus"):
    """The unfused ODEnet with its analytic tangent: (f(y), e^T J_f(y) e)
    (for concatsquash with softplus
    caspr_tpu/ops/cnf_fused.py::_reference_dynamics)."""
    acts = _acts(params, nonlinearity)
    zp, zt = y, e
    for i, lp in enumerate(params["layers"]):
        terms = _layer_terms(lp, layer_type, tc)
        zp = _primal_layer(terms, zp)
        zt = torch.matmul(zt, terms[0].T)
        if terms[2] is not None:
            zt = zt * terms[2]
        if i < len(acts):
            f, df = acts[i]
            zt = zt * df(zp)
            zp = f(zp)
    return zp, (zt * e).sum(dim=-1)
