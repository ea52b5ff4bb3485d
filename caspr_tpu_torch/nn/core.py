"""Functional layers over parameter dicts, channels-last.

Parameters are plain nested dicts of tensors with weights in the
``(out, in)`` layout of ``torch.nn.Linear``, so a JAX checkpoint of
``caspr_tpu`` loads with no transposes (``caspr_tpu_torch.weights``).
Feature maps are channels-last, ``(..., N, C)``, as in the JAX package.
"""

from __future__ import annotations

import math

import torch


def linear(params, x):
    """y = x @ W^T (+ b) over the last axis. x: (..., in) -> (..., out)."""
    y = torch.matmul(x, params["weight"].T)
    if "bias" in params:
        y = y + params["bias"]
    return y


# A kernel-size-1 Conv1d is a per-point dense layer.
conv1x1 = linear


def group_norm(params, x, num_groups: int, eps: float = 1e-5):
    """GroupNorm over channels-last input ``(B, ..., C)``: statistics per
    (batch, group) over every spatial position and the C/G channels of the
    group, biased variance (torch.nn.GroupNorm on the channels-first
    mirror).  The per-channel mean is taken first and the groups are
    formed on the small (B, C) tensor, the order the JAX package uses."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    spatial = int(math.prod(shape[1:-1])) if len(shape) > 2 else 1
    cg = c // num_groups
    x3 = x.reshape(b, spatial, c)

    def group_mean(t3):
        per_channel = t3.mean(dim=1)  # (B, C)
        grp = per_channel.reshape(b, num_groups, cg).mean(dim=-1)  # (B, G)
        return grp.repeat_interleave(cg, dim=-1).reshape(b, 1, c)

    mean = group_mean(x3)
    var = group_mean(torch.square(x3 - mean))
    out = ((x3 - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return out * params["weight"] + params["bias"]
