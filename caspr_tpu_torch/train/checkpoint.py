"""Checkpoints: the port's own copy of caspr_tpu/train/checkpoint.py.

A checkpoint is a pickle of numpy trees, ``{"params", "state", "epoch"}``
and optionally ``"opt_state"`` and ``"extra"``, params in the nested
dict / list layout of ``caspr_init`` with weights in the (out, in) layout of
torch.nn.Linear: the JAX package's files and the port's are the same kind.

The optimizer state differs.  The JAX package pickles its optax state, a
tuple holding optax's ``ScaleByAdamState(count, mu, nu)`` and
``EmptyState()``s; the port writes the plain dict ``{"count", "mu", "nu"}``
with mu and nu trees shaped as the params.  ``load_checkpoint`` reads
either without importing JAX or optax: it unpickles through a restricted
unpickler that admits numpy's array classes and stands in for those two
optax classes, and returns the optimizer state as that plain dict.  (The
JAX package's train.py, given a port checkpoint, resumes params and state
and restarts Adam with a logged message, since the dict is not its optax
tree.)

``load_weights`` and ``load_encoder_weights_from_full`` are the tolerant
partial loads of the evaluation and train scripts: they merge what fits
into an existing tree of tensors and warn about the rest.  ``load_state``
(the MovingBatchNorm state) and ``restore_adam_state`` (the optimizer's
moments) are strict: a tree that does not fit raises.
"""

from __future__ import annotations

import os
import pickle
from collections import namedtuple
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.odeint import flatten_tree

# stand-ins for optax's state classes (optax._src.transform / base)
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = namedtuple("EmptyState", [])
_OPTAX_STANDINS = {"ScaleByAdamState": ScaleByAdamState, "EmptyState": EmptyState}
_NUMPY_GLOBALS = {"dtype", "ndarray", "_reconstruct", "_frombuffer", "scalar"}
_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric"}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in _OPTAX_STANDINS:
            return _OPTAX_STANDINS[name]
        if module in _NUMPY_MODULES and name in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, which is not admitted")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def adam_state(params, optimizer: torch.optim.Adam):
    """{"count", "mu", "nu"} of an optimizer made by ``Adam.init(params)``:
    the step count and the two moments as numpy trees shaped as params
    (zeros before the first step)."""
    leaves, rebuild = flatten_tree(params)
    states = [optimizer.state.get(p, {}) for p in leaves]
    moment = lambda key: rebuild([s[key] if key in s else torch.zeros_like(p)
                                  for s, p in zip(states, leaves)])
    count = float(states[0]["step"]) if leaves and "step" in states[0] else 0.0
    return {"count": np.asarray(count, np.int32), "mu": _to_numpy(moment("exp_avg")),
            "nu": _to_numpy(moment("exp_avg_sq"))}


def save_checkpoint(path: str, params, state, opt_state=None, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None):
    """Write the checkpoint of ``params`` and ``state`` (trees of tensors or
    arrays); ``opt_state`` is the optimizer of ``Adam.init(params)`` or an
    already plain {"count", "mu", "nu"} dict.  Atomic: written beside, then
    renamed."""
    payload = {"params": _to_numpy(params), "state": _to_numpy(state), "epoch": epoch}
    if opt_state is not None:
        payload["opt_state"] = (adam_state(params, opt_state)
                                if isinstance(opt_state, torch.optim.Optimizer)
                                else _to_numpy(opt_state))
    if extra:
        payload["extra"] = extra
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """The checkpoint dict, arrays as numpy; an optax optimizer state comes
    back as {"count", "mu", "nu"}.  Admits only numpy arrays and the optax
    state classes: any other class in the file raises.  A reference
    PyTorch checkpoint (.pth / .pt) is converted on the fly
    (``compat.torch_convert``) into {"params", "state", "epoch": 0}."""
    if path.endswith(".pth") or path.endswith(".pt"):
        from ..compat.torch_convert import convert_torch_checkpoint

        params, state = convert_torch_checkpoint(path)
        return {"params": params, "state": state, "epoch": 0}
    with open(path, "rb") as f:
        ck = _CheckpointUnpickler(f).load()
    opt = ck.get("opt_state")
    if isinstance(opt, (list, tuple)) and not isinstance(opt, dict):
        adam = [s for s in opt if isinstance(s, ScaleByAdamState)]
        if len(adam) != 1:
            raise ValueError(f"optimizer state holds {len(adam)} Adam states, expected 1")
        ck["opt_state"] = {"count": adam[0].count, "mu": adam[0].mu, "nu": adam[0].nu}
    return ck


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


def _strict_leaves(target, loaded, what):
    """(target's tensor leaves, the loaded arrays at the same dotted paths);
    raises ValueError unless the two trees have the same paths and shapes."""
    tgt_flat, src_flat = _flatten(target), _flatten(loaded)
    if tgt_flat.keys() != src_flat.keys():
        raise ValueError(f"{what}: missing {sorted(tgt_flat.keys() - src_flat.keys())}, "
                         f"unexpected {sorted(src_flat.keys() - tgt_flat.keys())}")
    arrays = [np.asarray(src_flat[k]) for k in tgt_flat]
    for k, t, a in zip(tgt_flat, tgt_flat.values(), arrays):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(a.shape)}, expected {tuple(t.shape)}")
    return list(tgt_flat.values()), arrays


def load_state(target_state, loaded_state):
    """A checkpoint's MovingBatchNorm state (numpy) as tensors in the layout,
    dtypes and devices of ``target_state``; raises ValueError on any leaf
    missing, unexpected or misshapen."""
    _strict_leaves(target_state, loaded_state, "state")
    return _merge(target_state, _flatten(loaded_state))


def restore_adam_state(params, optimizer: torch.optim.Adam, opt_state):
    """Set the moments and step count of an optimizer made by
    ``Adam.init(params)`` from a checkpoint's {"count", "mu", "nu"}, the
    inverse of ``adam_state``; raises ValueError when mu or nu do not fit
    params (the optimizer is then unchanged)."""
    leaves, mu = _strict_leaves(params, opt_state["mu"], "optimizer state mu")
    _, nu = _strict_leaves(params, opt_state["nu"], "optimizer state nu")
    count = float(np.asarray(opt_state["count"]))
    as_leaf = lambda a, p: torch.from_numpy(np.array(a, dtype=np.float32)).to(p.device, p.dtype)
    for p, m, v in zip(leaves, mu, nu):
        optimizer.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": as_leaf(m, p), "exp_avg_sq": as_leaf(v, p)}
