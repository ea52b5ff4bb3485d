"""Random sampling on explicit ``torch.Generator``s (counterparts of
caspr_tpu/ops/sampling.py).  The two frameworks draw different numbers
from the same seed; tests that compare them hand both sides the same
samples instead."""

from __future__ import annotations

import math

import torch


def standard_normal_logprob(z):
    """Elementwise log N(z; 0, 1)."""
    return -0.5 * math.log(2 * math.pi) - torch.square(z) / 2.0


def _normal_cdf(v: float) -> float:
    return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))


def truncated_normal(generator, shape, trunc_std: float = 2.0, device=None):
    """Standard normal truncated to +-trunc_std, sampled exactly by the
    inverse CDF (the same law as the JAX package's truncated_normal)."""
    lo, hi = _normal_cdf(-trunc_std), _normal_cdf(trunc_std)
    u = torch.rand(shape, generator=generator, device=device)
    p = lo + u * (hi - lo)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return z.clamp(-trunc_std, trunc_std)


def sample_gaussian(generator, shape, truncate_std=None, device=None):
    """N(0, 1) samples, truncated to +-truncate_std when it is given."""
    if truncate_std is not None:
        return truncated_normal(generator, shape, truncate_std, device)
    return torch.randn(shape, generator=generator, device=device)


def sphere_surface_points(generator, num_points: int, radius: float = 0.5,
                          device=None):
    """Points on a sphere of ``radius`` by normalising uniform cube samples."""
    cube = torch.rand((num_points, 3), generator=generator, device=device) * 2.0 - 1.0
    norm = torch.linalg.vector_norm(cube, dim=1, keepdim=True)
    return cube / norm.clamp_min(1e-12) * radius
