"""Checkpoints of the JAX package as the port's tensors.

A JAX checkpoint (caspr_tpu/train/checkpoint.py) is a pickle of numpy
arrays: {"params", "state", "epoch", "extra"}, params in the nested
dict/list layout of ``caspr_init`` with weights already in the
``(out, in)`` layout of torch.nn.Linear.  Loading it needs no JAX and no
transposes: every leaf becomes a float32 tensor at the same place in the
tree.  ``params_from_jax`` holds the tree to the shapes the config implies
(``models.caspr.caspr_param_shapes``) and raises on a missing, unexpected
or misshapen leaf.  ``load_weights`` and ``load_encoder_weights_from_full``
are the tolerant partial loads of the evaluation script (counterparts of
caspr_tpu/train/checkpoint.py): they merge what fits into an existing
parameter tree and warn about the rest.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .models.caspr import CaSPRConfig, caspr_param_shapes, resolve_device

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


def params_from_jax(params, state, cfg: CaSPRConfig, device=None):
    """JAX (params, state) trees of numpy arrays -> the port's (params,
    state) on ``device`` (default: the card).  Raises ValueError listing
    every leaf that is missing, unexpected or of the wrong shape."""
    device = resolve_device(device)
    want_params, want_state = caspr_param_shapes(cfg)
    problems = []
    out_params = _convert(params, want_params, device, "params.", problems)
    out_state = _convert(state, want_state, device, "state.", problems)
    if problems:
        raise ValueError("checkpoint does not fit the config:\n  " + "\n  ".join(problems))
    return out_params, out_state


def load_demo(cfg: CaSPRConfig = CaSPRConfig(), device=None, path: str = DEMO_CHECKPOINT):
    """The trained full-width demo weights (artifacts/demo_trained.pkl)."""
    ck = load_checkpoint(path)
    return params_from_jax(ck["params"], ck["state"], cfg, device)


def _flatten(tree, prefix=""):
    """{dotted path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _merge(target, flat, prefix=""):
    if isinstance(target, dict):
        return {k: _merge(v, flat, f"{prefix}{k}.") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return [_merge(v, flat, f"{prefix}{i}.") for i, v in enumerate(target)]
    if prefix[:-1] in flat:
        arr = np.array(flat[prefix[:-1]], dtype=np.float32)
        return torch.from_numpy(arr).to(device=target.device, dtype=target.dtype)
    return target


def load_weights(target_params, loaded_params):
    """Tolerant merge of a checkpoint's params (numpy arrays) into a tree of
    tensors: a leaf the checkpoint lacks keeps its value, with a warning; a
    leaf the target lacks, or whose shape differs, is ignored, with a
    warning.  Returns the merged tree on the target leaves' devices."""
    tgt_flat = _flatten(target_params)
    src_flat = _flatten(loaded_params)
    missing = [k for k in tgt_flat if k not in src_flat]
    unexpected = [k for k in src_flat if k not in tgt_flat]
    mismatched = [k for k in src_flat
                  if k in tgt_flat and tuple(np.shape(src_flat[k])) != tuple(tgt_flat[k].shape)]
    if missing:
        print("WARNING: keys not found in the given checkpoint - ignoring...")
        print(missing)
    if unexpected or mismatched:
        print("WARNING: checkpoint keys not in the current model - ignoring...")
        print(unexpected + mismatched)
    usable = {k: v for k, v in src_flat.items() if k in tgt_flat and k not in mismatched}
    return _merge(target_params, usable)


def load_encoder_weights_from_full(target_params, loaded_params):
    """Take only the encoder's weights out of a full-model checkpoint."""
    if "encoder" not in loaded_params:
        raise KeyError("checkpoint has no 'encoder' subtree")
    new_params = dict(target_params)
    new_params["encoder"] = load_weights(target_params["encoder"], loaded_params["encoder"])
    return new_params
