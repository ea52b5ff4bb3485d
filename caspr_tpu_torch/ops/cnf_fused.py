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
