"""Weights made from the seed on the device, for configurations that name no
checkpoint: one uniform draw for every linear layer, carved into leaves.

Linear and 1x1-conv layers (a dict whose "weight" is 2-D) take
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, torch.nn.Linear's
law; normalisation layers (1-D "weight") take weight 1 and bias 0.  The
tree's layout is the reference's ``param_shapes``; program and reference
are handed the same tensors.
"""

from __future__ import annotations

import math

import torch


def _linear_size(shapes) -> int:
    """Scalars in the linear layers of a shape tree."""
    if isinstance(shapes, list):
        return sum(_linear_size(v) for v in shapes)
    if "weight" in shapes and len(shapes["weight"]) == 2:
        return sum(math.prod(s) for s in shapes.values())
    return sum(_linear_size(v) for v in shapes.values() if isinstance(v, (dict, list)))


def seeded_weights(gen, shapes, device):
    """A tree of float32 tensors with the layout of ``shapes``."""
    flat = 2.0 * torch.rand(_linear_size(shapes), generator=gen, device=device) - 1.0
    at = [0]

    def build(tree):
        if isinstance(tree, list):
            return [build(v) for v in tree]
        linear = "weight" in tree and len(tree["weight"]) == 2
        out = {}
        for name, shape in tree.items():
            if isinstance(shape, (dict, list)):
                out[name] = build(shape)
            elif linear:
                size = math.prod(shape)
                bound = 1.0 / math.sqrt(tree["weight"][1])
                out[name] = (flat[at[0]:at[0] + size] * bound).reshape(shape)
                at[0] += size
            else:
                out[name] = (torch.ones if name == "weight" else torch.zeros)(shape, device=device)
        return out

    return build(shapes)
