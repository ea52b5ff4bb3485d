"""Global space-time PointNet (counterpart of caspr_tpu/models/pointnet.py):
three 1x1 convs with GroupNorm(16), then a max over all points."""

from __future__ import annotations

import torch

from ..nn import conv1x1, group_norm

NUM_GROUPS = 16


def pointnetfeat_param_shapes(input_dim: int = 4, out_size: int = 1024,
                              layer_sizes=(64, 128)):
    d0, d1 = layer_sizes
    conv = lambda i, o: {"weight": (o, i), "bias": (o,)}
    norm = lambda c: {"weight": (c,), "bias": (c,)}
    return {
        "conv1": conv(input_dim, d0),
        "conv2": conv(d0, d1),
        "conv3": conv(d1, out_size),
        "bn1": norm(d0),
        "bn2": norm(d1),
        "bn3": norm(out_size),
    }


def pointnetfeat_apply_split(params, x):
    """x: (B, L, input_dim) -> (global (B, out_size), point_feat (B, L, d0))."""
    h = torch.relu(group_norm(params["bn1"], conv1x1(params["conv1"], x), NUM_GROUPS))
    point_feat = h
    h = torch.relu(group_norm(params["bn2"], conv1x1(params["conv2"], h), NUM_GROUPS))
    h = group_norm(params["bn3"], conv1x1(params["conv3"], h), NUM_GROUPS)
    return h.amax(dim=1), point_feat


def pointnetfeat_apply(params, x):
    """x: (B, L, input_dim) -> (B, L, out_size + d0): the global feature
    broadcast to every point, then the per-point features."""
    global_feat, point_feat = pointnetfeat_apply_split(params, x)
    b, n, _ = point_feat.shape
    global_rep = global_feat[:, None, :].expand(b, n, global_feat.shape[-1])
    return torch.cat([global_rep, point_feat], dim=-1)
