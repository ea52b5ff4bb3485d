"""Plain PyTorch versions of the point-cloud primitives.

These are the oracles the CUDA kernels are held to (``ops/kernels.py``)
and the path a CPU tensor takes.  Semantics follow the JAX package's XLA
versions (caspr_tpu/ops/pointops.py), which replicate Kaolin's CUDA ops:

  - farthest_point_sampling : seed index 0, lowest index wins a tie
  - gather_points           : row gather with indices clamped to [0, N)
  - ball_query              : first K sources inside the radius, in index
                              order, padded with the first hit (0 if none)
  - three_nn                : 3 smallest SQUARED distances, lowest index
                              first on a tie
  - three_interpolate       : weighted sum of 3 gathered rows

Squared distances are written out as ``(dx*dx + dy*dy) + dz*dz`` with one
eager op per term, so each product and sum is rounded on its own; the
kernels use the same order with FMA contraction switched off, which keeps
FPS, ball query and three-NN index-identical to these versions.
"""

from __future__ import annotations

import numpy as np
import torch


def _sqnorm3(diff):
    """(..., 3) -> (...): (dx*dx + dy*dy) + dz*dz, no fused multiply-add."""
    dx, dy, dz = diff.unbind(-1)
    return dx * dx + dy * dy + dz * dz


def pairwise_sqdist(a, b):
    """Exact squared distances by explicit differences (not the
    |a|^2+|b|^2-2ab expansion, which cancels catastrophically for
    near-duplicate points).  a: (..., M, 3), b: (..., N, 3) -> (..., M, N)."""
    return _sqnorm3(a[..., :, None, :] - b[..., None, :, :])


def fps_identity(b: int, n: int, num_samples: int, device):
    """FPS for num_samples >= N: every point, in index order, zero-padded.
    Every consumer treats the centroids as a set, so the order is free."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if num_samples > n:
        pad = torch.zeros(num_samples - n, dtype=torch.int32, device=device)
        idx = torch.cat([idx, pad])
    return idx.expand(b, num_samples).contiguous()


def farthest_point_sampling(xyz, num_samples: int):
    """Greedy farthest point sampling. xyz: (B, N, 3) -> (B, M) int32.

    Index 0 first; each later pick maximises the running minimum squared
    distance to the picked set (torch.argmax returns the first maximum,
    so the lowest index wins a tie)."""
    b, n, _ = xyz.shape
    if num_samples >= n:
        return fps_identity(b, n, num_samples, xyz.device)
    rows = torch.arange(b, device=xyz.device)
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=xyz.device)
    min_d = torch.full((b, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, num_samples):
        d = _sqnorm3(xyz - xyz[rows, last][:, None, :])
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


def gather_points(points, idx):
    """points: (B, N, C), idx: (B, ...) int -> (B, ..., C); indices are
    clamped to [0, N)."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1).long().clamp(0, n - 1)
    out = torch.gather(points, 1, flat[:, :, None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def radius_sq(radius: float) -> float:
    """radius**2 rounded to float32, the threshold both the plain version
    and the kernel compare against."""
    return float(np.float32(radius * radius))


def ball_query(xyz, new_xyz, radius: float, num_samples: int):
    """First ``num_samples`` indices of ``xyz`` inside ``radius`` of each
    centroid, in index order, padded with the first hit (all 0 if the ball
    is empty).  xyz: (B, N, 3), new_xyz: (B, M, 3) -> (B, M, K) int32."""
    n = xyz.shape[-2]
    inside = pairwise_sqdist(new_xyz, xyz) < radius_sq(radius)
    # key N - position for points inside, 0 outside: the K largest keys are
    # the K earliest hits, in order.  Keys inside are distinct, so topk's
    # unspecified tie order only touches slots that are overwritten below.
    pos_key = torch.arange(n, 0, -1, dtype=torch.int32, device=xyz.device)
    keys = torch.where(inside, pos_key, torch.zeros_like(pos_key))
    k_eff = min(num_samples, n)
    top_vals, top_idx = torch.topk(keys, k_eff, dim=-1, sorted=True)
    if k_eff < num_samples:
        pad = top_vals.new_zeros(top_vals.shape[:-1] + (num_samples - k_eff,))
        top_vals = torch.cat([top_vals, pad], dim=-1)
        top_idx = torch.cat([top_idx, pad.long()], dim=-1)
    valid = top_vals > 0
    idx = torch.where(valid, top_idx, top_idx[..., :1])
    idx = torch.where(valid[..., :1], idx, torch.zeros_like(idx))
    return idx.to(torch.int32)


def ball_query_pair(xyz, new_xyz, radius1, k1, radius2, k2):
    """Both grouping scales of one SA level on the same sources and
    centroids: (ball_query(r1, k1), ball_query(r2, k2))."""
    return (
        ball_query(xyz, new_xyz, radius1, k1),
        ball_query(xyz, new_xyz, radius2, k2),
    )


def group_points(xyz, new_xyz, features, idx, use_xyz_feature: bool = True,
                 gather=gather_points):
    """Grouped neighbourhoods with centred coordinates first.

    xyz: (B, N, 3); new_xyz: (B, M, 3); features: (B, N, C) or None;
    idx: (B, M, K) -> (B, M, K, 3 + C).  ``gather`` is the row gather to
    use (the model passes the dispatching wrapper of ``ops.kernels``)."""
    if features is None:
        return gather(xyz, idx) - new_xyz[:, :, None, :]
    grouped = gather(torch.cat([xyz, features], dim=-1), idx)
    rel_xyz = grouped[..., :3] - new_xyz[:, :, None, :]
    if use_xyz_feature:
        return torch.cat([rel_xyz, grouped[..., 3:]], dim=-1)
    return grouped[..., 3:]


def three_nn(query_xyz, source_xyz):
    """query (B, N, 3), source (B, M, 3), M >= 3 -> (dist2 (B, N, 3),
    idx (B, N, 3) int32), nearest first.  A stable sort keeps the lower
    index first on equal distances (torch.topk promises no tie order)."""
    d2 = pairwise_sqdist(query_xyz, source_xyz)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :3].contiguous(), idx[..., :3].to(torch.int32).contiguous()


def three_interpolate(features, idx, weights):
    """features (B, M, C), idx (B, N, 3), weights (B, N, 3) -> (B, N, C):
    ``(w0*F[i0] + w1*F[i1]) + w2*F[i2]`` in float32."""
    g = gather_points(features, idx)  # (B, N, 3, C)
    w = weights[..., None]
    return g[..., 0, :] * w[..., 0, :] + g[..., 1, :] * w[..., 1, :] + g[..., 2, :] * w[..., 2, :]
