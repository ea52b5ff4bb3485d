"""The approxmatch earth mover's distance in plain PyTorch, one pair at a
time (counterpart of caspr_tpu/ops/metrics.py::_approx_match, _match_cost
and the constant-match gradient of its approx_match_emd).

This is the oracle of the CUDA kernel (``csrc/emd.cu``), the route a CPU
tensor takes through ``ops.kernels.approx_match_emd``, and the backward of
``ops.metrics.approx_match_emd`` on either device.  It works in the dtype
of its inputs, so the same functions give the float64 value that the
kernel is held to.
"""

from __future__ import annotations

import torch

from . import pointops

EMD_LEVELS = tuple(-(4.0 ** k) for k in range(7, -2, -1)) + (0.0,)


def _approx_match(xyz1, xyz2):
    """The annealed soft matching between two clouds.
    xyz1 (N, 3), xyz2 (M, 3) -> match (N, M), rows the points of xyz1.

    Temperatures anneal from -4^7 (nearly nearest-neighbour assignment) to
    0 (uniform).  At each level every left point spreads its remaining
    mass over the right points in proportion to exp(level * d^2) times
    their remaining capacity, and the flows into a right point are scaled
    down to that capacity.  Capacities are max(N, M) / N on the left and
    max(N, M) / M on the right, so the total mass matches."""
    n, m = xyz1.shape[0], xyz2.shape[0]
    d2 = pointops.pairwise_sqdist(xyz1, xyz2)
    big = float(max(n, m))
    match = torch.zeros_like(d2)
    sat_l = torch.full((n,), big / n, dtype=d2.dtype, device=d2.device)
    sat_r = torch.full((m,), big / m, dtype=d2.dtype, device=d2.device)
    for level in EMD_LEVELS:
        w = torch.exp(level * d2) * sat_r[None, :]
        w = w * (sat_l[:, None] / (w.sum(dim=1, keepdim=True) + 1e-9))
        scale = torch.clamp_max(sat_r / (w.sum(dim=0) + 1e-9), 1.0)
        w = w * scale[None, :]
        match = match + w
        sat_l = torch.clamp_min(sat_l - w.sum(dim=1), 0.0)
        sat_r = torch.clamp_min(sat_r - w.sum(dim=0), 0.0)
    return match


def _match_cost(xyz1, xyz2, match):
    """sum_ij match_ij * |xyz1_i - xyz2_j| (euclidean, not squared)."""
    d2 = pointops.pairwise_sqdist(xyz1, xyz2)
    return (match * torch.sqrt(torch.clamp_min(d2, 1e-20))).sum()


def emd_plain(xyz1, xyz2):
    """Approxmatch EMD cost per pair, one pair at a time:
    xyz1 (P, N, 3), xyz2 (P, M, 3) -> (P,)."""
    costs = [_match_cost(a, b, _approx_match(a, b)) for a, b in zip(xyz1, xyz2)]
    return torch.stack(costs) if costs else xyz1.new_zeros((0,))


def emd_backward(xyz1, xyz2):
    """Gradients of the EMD cost with the match held constant, one pair at
    a time: (d cost / d xyz1 (P, N, 3), -d cost / d xyz2 (P, M, 3)), i.e.
    sum_j and sum_i of match_ij * (a_i - b_j) / |a_i - b_j|."""
    g1, g2 = [], []
    for a, b in zip(xyz1, xyz2):
        match = _approx_match(a, b)
        diff = a[:, None, :] - b[None, :, :]  # (N, M, 3)
        dist = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=-1), 1e-20))
        pair = (match / dist)[..., None] * diff
        g1.append(pair.sum(dim=1))
        g2.append(pair.sum(dim=0))
    return torch.stack(g1), torch.stack(g2)
