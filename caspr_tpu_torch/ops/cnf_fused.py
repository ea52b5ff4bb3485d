"""The CNF dynamics around the fused concatsquash kernels.

The concatsquash ODEnet (4 layers 3 -> 512 -> 512 -> 512 -> 3 with
softplus between them) runs once per solver step of every CNF solve.  As
in the JAX package (caspr_tpu/ops/cnf_fused.py), the context-dependent
part of each layer -- a sigmoid gate and an effective bias per (cloud,
channel) -- is computed here in plain PyTorch, a (BT, 1+zdim) x (1+zdim, H)
product per layer, and the per-point work goes to a kernel that keeps
every activation on chip: ``ops.kernels.cnf_primal`` for the sampling
direction (points alone), ``ops.kernels.cnf_dynamics`` for the likelihood
direction (points and the Hutchinson tangent J e, giving e^T J e).

The tangent is analytic for concatsquash + softplus: gate and bias do not
depend on y, so the tangent of ``L(y) * gate + b`` is ``L(e) * gate``, and
softplus' derivative is the sigmoid of its pre-activation.
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


def primal_packed(y, gb, w_first, w_hidden, w_last):
    """The kernel's function in plain PyTorch: per layer
    ``(z @ W^T) * gate + beff``, softplus on all but the last.
    y: (BT, N, D) -> dx (BT, N, D)."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    z = y
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        z = torch.matmul(z, w.T) * gate + beff
        if i < num_layers - 1:
            z = softplus(z)
    return z


def reference_primal(params, tc, y):
    """The unfused concatsquash stack, ``(y @ W^T + b) * gate + hyper_bias``
    per layer (caspr_tpu/ops/cnf_fused.py::_reference_primal)."""
    layers = params["layers"]
    dx = y
    for i, lp in enumerate(layers):
        gate = torch.sigmoid(linear(lp["_hyper_gate"], tc))[:, None, :]
        bias = linear(lp["_hyper_bias"], tc)[:, None, :]
        dx = linear(lp["_layer"], dx) * gate + bias
        if i < len(layers) - 1:
            dx = softplus(dx)
    return dx


def dynamics_packed(y, e, gb, w_first, w_hidden, w_last):
    """The with-divergence kernel's function in plain PyTorch.  Per layer
    ``m = z @ W^T`` for both streams, primal ``zp = m_p * gate + beff``,
    tangent ``zt = m_t * gate``; on all but the last layer ``zt *=
    sigmoid(zp)`` (the pre-activation) and ``zp = softplus(zp)``.
    y, e: (BT, N, D) -> (dx (BT, N, D), div (BT, N) = sum_d (J e)_d e_d)."""
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    zp, zt = y, e
    for i, w in enumerate(weights):
        d_out = w.shape[0]
        gate = gb[:, i, None, :d_out]
        beff = gb[:, num_layers + i, None, :d_out]
        zp = torch.matmul(zp, w.T) * gate + beff
        zt = torch.matmul(zt, w.T) * gate
        if i < num_layers - 1:
            zt = zt * torch.sigmoid(zp)
            zp = softplus(zp)
    return zp, (zt * e).sum(dim=-1)


def dynamics_vjp_packed(y, e, gb, w_first, w_hidden, w_last, ct_dx, ct_div):
    """The VJP of ``dynamics_packed`` with respect to y, gb and the
    weights, in plain PyTorch: the function of the cnf_dynamics_vjp kernel
    (caspr_tpu/ops/cnf_fused.py::_fused_bwd_kernel, in the stream-stacked
    form of ``_manual_dynamics_vjp``).  e is a constant: no d/de.

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
    weights = [w_first, *w_hidden.unbind(0), w_last]
    num_layers = len(weights)
    n = y.shape[1]
    z = torch.cat([y, e], dim=1)
    zs, ms = [], []
    for i, w in enumerate(weights):
        zs.append(z)
        m = torch.matmul(z, w.T)
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
        dm = torch.cat([dppre, dtpre], dim=1) * gate
        dws[i] = torch.matmul(dm.reshape(-1, d_out).T, zs[i].reshape(-1, w.shape[1]))
        dz = torch.matmul(dm, w)
        cp, ct = dz[:, :n], dz[:, n:]
    return cp, dgb, dws[0], torch.stack(dws[1:-1]), dws[-1]


def reference_dynamics(params, tc, y, e):
    """The unfused composition with its analytic tangent
    (caspr_tpu/ops/cnf_fused.py::_reference_dynamics): (dx, e^T J e)."""
    layers = params["layers"]
    zp, zt = y, e
    for i, lp in enumerate(layers):
        gate = torch.sigmoid(linear(lp["_hyper_gate"], tc))[:, None, :]
        bias = linear(lp["_hyper_bias"], tc)[:, None, :]
        zp = linear(lp["_layer"], zp) * gate + bias
        zt = torch.matmul(zt, lp["_layer"]["weight"].T) * gate
        if i < len(layers) - 1:
            zt = zt * torch.sigmoid(zp)
            zp = softplus(zp)
    return zp, (zt * e).sum(dim=-1)
