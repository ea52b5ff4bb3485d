"""Checkpoints of the JAX package as the port's tensors.

A JAX checkpoint (caspr_tpu/train/checkpoint.py) is a pickle of numpy
arrays: {"params", "state", "epoch", "extra"}, params in the nested
dict/list layout of ``caspr_init`` with weights already in the
``(out, in)`` layout of torch.nn.Linear.  Loading it needs no JAX and no
transposes: every leaf becomes a float32 tensor at the same place in the
tree.  ``params_from_jax`` holds the tree to the shapes the config implies
(``models.caspr.caspr_param_shapes``) and raises on a missing, unexpected
or misshapen leaf.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .models.caspr import CaSPRConfig, caspr_param_shapes

DEMO_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", "demo_trained.pkl")


def load_checkpoint(path: str):
    """The checkpoint dict, arrays as numpy.  Unpickles: load only files
    this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _convert(tree, shapes, device, path, problems):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict):
            problems.append(f"{path or '<root>'}: expected a dict, got {type(tree).__name__}")
            return None
        for key in tree.keys() - shapes.keys():
            problems.append(f"{path}{key}: unexpected")
        for key in shapes.keys() - tree.keys():
            problems.append(f"{path}{key}: missing")
        return {k: _convert(tree[k], shapes[k], device, f"{path}{k}.", problems)
                for k in shapes if k in tree}
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            problems.append(f"{path}: expected a list of {len(shapes)}")
            return None
        return [_convert(t, s, device, f"{path}{i}.", problems)
                for i, (t, s) in enumerate(zip(tree, shapes))]
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(shapes):
        problems.append(f"{path[:-1]}: shape {tuple(arr.shape)}, expected {tuple(shapes)}")
        return None
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def params_from_jax(params, state, cfg: CaSPRConfig, device="cpu"):
    """JAX (params, state) trees of numpy arrays -> the port's (params,
    state) on ``device``.  Raises ValueError listing every leaf that is
    missing, unexpected or of the wrong shape."""
    want_params, want_state = caspr_param_shapes(cfg)
    problems = []
    out_params = _convert(params, want_params, device, "params.", problems)
    out_state = _convert(state, want_state, device, "state.", problems)
    if problems:
        raise ValueError("checkpoint does not fit the config:\n  " + "\n  ".join(problems))
    return out_params, out_state


def load_demo(cfg: CaSPRConfig = CaSPRConfig(), device="cpu", path: str = DEMO_CHECKPOINT):
    """The trained full-width demo weights (artifacts/demo_trained.pkl)."""
    ck = load_checkpoint(path)
    return params_from_jax(ck["params"], ck["state"], cfg, device)
