"""Point-cloud metrics: Chamfer distance and the approxmatch earth mover's
distance (counterparts of caspr_tpu/ops/metrics.py).

``chamfer_distance`` is plain PyTorch around the gather wrapper: the JAX
package computes it outside its kernels too.  ``approx_match_emd`` is the
differentiable EMD: its forward goes through ``ops.kernels.approx_match_emd``
(the CUDA kernel of ``csrc/emd.cu`` for a CUDA tensor, the plain version of
``ops/emd_plain.py`` for a CPU tensor), its backward is the constant-match
gradient in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import kernels
# the plain EMD is read through this module too, as in the JAX package's metrics
from .emd_plain import _approx_match, _match_cost, emd_backward, emd_plain  # noqa: F401

# Pairs per chunk of the Chamfer distance: bounds the (chunk, N, M) distance
# tensor (16 MB per pair at 2048 x 2048).
CHAMFER_CHUNK = 4


def chamfer_distance(pred, gt):
    """Two-way squared nearest-neighbour distances.

    pred (B, N, 3), gt (B, M, 3) -> (dist1 (B, N), dist2 (B, M)):
    dist1[i] = min_j |pred_i - gt_j|^2 and the other way round; the caller
    takes per-cloud means and adds the two directions.

    Select, then refine: the neighbour's index comes from the
    |a|^2 + |b|^2 - 2ab expansion (one batched float32 product), the value
    from the exact difference form to the selected neighbour, so the
    expansion's rounding can only change which of two near-equal
    neighbours is picked, never cancel digits of the distance."""
    d1, d2 = [], []
    for lo in range(0, pred.shape[0], CHAMFER_CHUNK):
        p = pred[lo:lo + CHAMFER_CHUNK].contiguous()
        g = gt[lo:lo + CHAMFER_CHUNK].contiguous()
        ab = torch.matmul(p, g.transpose(1, 2))  # (chunk, N, M)
        sq = (p * p).sum(dim=-1)[:, :, None] + (g * g).sum(dim=-1)[:, None, :] - 2.0 * ab
        nn1 = kernels.gather_points(g, torch.argmin(sq, dim=2).to(torch.int32))  # (chunk, N, 3)
        nn2 = kernels.gather_points(p, torch.argmin(sq, dim=1).to(torch.int32))  # (chunk, M, 3)
        d1.append(((p - nn1) ** 2).sum(dim=-1))
        d2.append(((g - nn2) ** 2).sum(dim=-1))
    return torch.cat(d1), torch.cat(d2)


class _ApproxMatchEMD(torch.autograd.Function):
    """Forward through ``kernels.approx_match_emd``; backward is the
    constant-match gradient in plain PyTorch on either device, as the JAX
    package has no kernel there either.  The match is recomputed in the
    backward, one pair at a time, instead of being kept: the kernel never
    forms it, and it is 16 MB per pair at 2048 x 2048."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        ctx.save_for_backward(xyz1, xyz2)
        return kernels.approx_match_emd(xyz1, xyz2)

    @staticmethod
    def backward(ctx, grad):
        xyz1, xyz2 = ctx.saved_tensors
        g1, g2 = emd_backward(xyz1, xyz2)
        return grad[:, None, None] * g1, -grad[:, None, None] * g2


def approx_match_emd(xyz1, xyz2):
    """Approxmatch EMD cost per cloud pair: xyz1 (P, N, 3), xyz2 (P, M, 3)
    float32, contiguous -> (P,).  The gradient treats the match as
    constant."""
    return _ApproxMatchEMD.apply(xyz1, xyz2)
