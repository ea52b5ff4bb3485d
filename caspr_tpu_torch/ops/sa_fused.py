"""One set-abstraction (SA) scale of PointNet++: grouping, the mini-PointNet
(3 x (1x1 conv + GroupNorm(16) [+ ReLU])) and the max over the K ball
members, in the three forms the encoder chooses between (counterpart of
caspr_tpu/ops/sa_fused2.py and caspr_tpu/ops/sa_fused.py):

  - ``sa_reference``: the unfactored composition, group_points then
    ``mini_pointnet_apply`` (the JAX package's ``_xla_reference``);
  - ``sa_scale_factored``: conv1 factored through the gather.  With W1
    split into its relative-xyz block Wx and its feature block Wf,

        h1[m, k] = t[idx[m, k]] - u[m],  t = xyz @ Wx^T + b1 + feat @ Wf^T,
                                         u = centre @ Wx^T,

    so the gather moves d1 channels instead of 3 + C, and conv1 runs over
    the N source points instead of the M*K grouped rows.  Plain PyTorch
    around the gather, differentiable by autograd;
  - ``fused_sa_scale``: the same t and u, then the rest of the scale (the
    gather, the subtraction, the three GroupNorms, conv2, conv3 and the
    max) in one kernel, ``kernels.sa_fused`` (csrc/sa_fused.cu).  Its
    backward differentiates ``sa_reference``, a rematerialisation, as the
    JAX package's custom VJPs do (sa_fused2.py::_fused_sa2_bwd).

``sa_stack_plain`` is that kernel's plain version: what a CPU tensor
takes, and what chip_smoke.py holds the kernel to.

t and u are plain matrix products outside the kernel (the JAX package
leaves them to XLA at HIGHEST precision): the factored form is a
difference of O(1) quantities standing in for the O(radius) relative
coordinates, so they are float32 products without TF32.
"""

from __future__ import annotations

import torch

from ..nn import conv1x1, group_norm
from . import kernels, pointops

NUM_GROUPS = 16  # GroupNorm groups of the mini-PointNet, and of the kernel
MAX_K = 32  # ball size the kernel takes
MAX_WIDTH = 512  # conv width the kernel takes: at most 32 channels per group


def mini_pointnet_apply(params, x, first_conv: bool = True):
    """x: (B', K, C) -> (B', d_out): conv + GroupNorm on every layer, ReLU
    on all but the last, max over the K ball members.  ``first_conv=False``
    says that x holds the first conv's output already (the factored forms)."""
    n = len(params["convs"])
    for i in range(n):
        if i or first_conv:
            x = conv1x1(params["convs"][i], x)
        x = group_norm(params["norms"][i], x, NUM_GROUPS)
        if i < n - 1:
            x = torch.relu(x)
    return x.amax(dim=1)


def can_fuse(sp, k: int) -> bool:
    """Whether the kernel takes this scale: three convs whose widths divide
    into the 16 groups, up to MAX_WIDTH, and balls of at most MAX_K."""
    if len(sp["convs"]) != 3:
        return False
    widths = [c["weight"].shape[0] for c in sp["convs"]]
    return 1 <= k <= MAX_K and all(d % NUM_GROUPS == 0 and d <= MAX_WIDTH for d in widths)


def factors(sp, xyz, features, new_xyz):
    """The factored conv1: (t (B, N, d1) over the source points, u (B, M,
    d1) over the centres), in the JAX package's order of sums."""
    w1 = sp["convs"][0]["weight"]  # (d1, 3 + C)
    wx = w1[:, :3].T
    t = torch.matmul(xyz, wx) + sp["convs"][0]["bias"]
    if features is not None:
        t = t + torch.matmul(features, w1[:, 3:].T)
    return t, torch.matmul(new_xyz, wx)


def sa_stack_plain(t, u, gidx, sp, gather=pointops.gather_points):
    """The fused kernel's plain version: t (B, N, d1), u (B, M, d1), gidx
    (B, M, K) int -> (B, M, d3).  GroupNorm (+ ReLU) of t[idx] - u[m]
    (indices clamped to [0, N)), conv2 + GroupNorm + ReLU, conv3 +
    GroupNorm, max over K; sp's conv weights are (out, in), the first
    conv's only through t and u."""
    b, m, k = gidx.shape
    h = (gather(t, gidx) - u[:, :, None, :]).reshape(b * m, k, -1)
    return mini_pointnet_apply(sp, h, first_conv=False).reshape(b, m, -1)


def sa_scale_factored(sp, xyz, features, new_xyz, gidx, gather=None):
    """One SA scale with conv1 factored through the gather (the JAX
    package's sa_scale_factored, its row form): xyz (B, N, 3), features
    (B, N, C) or None, new_xyz (B, M, 3), gidx (B, M, K) int32 -> (B, M,
    d3).  Differentiable by autograd; ``gather`` is the row gather to use
    (default: the dispatching wrapper ``kernels.gather_points``)."""
    t, u = factors(sp, xyz, features, new_xyz)
    return sa_stack_plain(t, u, gidx, sp, gather=gather or kernels.gather_points)


def sa_reference(sp, xyz, features, new_xyz, gidx, gather=None):
    """The unfactored composition: group_points (relative xyz first) and
    the mini-PointNet -> (B, M, d3); ``gather`` as in sa_scale_factored."""
    grouped = pointops.group_points(xyz, new_xyz, features, gidx, True,
                                    gather=gather or kernels.gather_points)
    b, m, k, c = grouped.shape
    return mini_pointnet_apply(sp, grouped.reshape(b * m, k, c)).reshape(b, m, -1)


def _sp_leaves(sp):
    return [layer[key] for part in ("convs", "norms") for layer in sp[part]
            for key in ("weight", "bias")]


def _sp_tree(leaves):
    layers = [{"weight": w, "bias": b} for w, b in zip(leaves[::2], leaves[1::2])]
    half = len(layers) // 2
    return {"convs": layers[:half], "norms": layers[half:]}


def fused_sa_scale(sp, xyz, features, new_xyz, gidx):
    """One SA scale through the fused kernel: arguments and result as
    ``sa_scale_factored``.  Differentiable in sp, xyz, features and
    new_xyz: the backward recomputes ``sa_reference`` under autograd."""
    return _FusedSAScale.apply(xyz, features, new_xyz, gidx, *_sp_leaves(sp))


class _FusedSAScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, features, new_xyz, gidx, *leaves):
        ctx.save_for_backward(xyz, features, new_xyz, gidx, *leaves)
        sp = _sp_tree(leaves)
        t, u = factors(sp, xyz, features, new_xyz)
        return kernels.sa_fused(t, u, gidx, sp)

    @staticmethod
    def backward(ctx, grad):
        xyz, features, new_xyz, gidx, *leaves = ctx.saved_tensors
        inputs = [xyz, features, new_xyz, None, *leaves]  # gidx takes no gradient
        needs = [need and x is not None for need, x in zip(ctx.needs_input_grad, inputs)]
        with torch.enable_grad():
            live = [x.detach().requires_grad_(need) if x is not None else None
                    for x, need in zip(inputs, needs)]
            out = sa_reference(_sp_tree(live[4:]), live[0], live[1], live[2], gidx)
            wanted = [x for x, need in zip(live, needs) if need]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return tuple(next(grads) if need else None for need in needs)
