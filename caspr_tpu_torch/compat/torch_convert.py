"""Reference PyTorch checkpoint -> the port's parameter tree: the port's own
copy of caspr_tpu/compat/torch_convert.py.

Maps the reference model's state-dict layout (reference caspr/models/*.py)
onto the parameter tree of ``models.caspr.caspr_param_shapes``, numpy
arrays that ``train.checkpoint.load_weights`` merges into a model's
tensors.  Handles:

  - DataParallel 'module.' prefix stripping
  - Conv1d(k=1) (out,in,1) -> dense (out,in)
  - MovingBatchNorm running stats/step -> the mutable state tree
  - solver/NFE buffers (no parameters) dropped

Key-map summary (reference name -> ours):
  encoder.local_extract.set_abstractions.{i}.pointnet_modules.{s}
      .conv_layers.{j} / .bn_layers.{j}
    -> encoder.local_extract.set_abstractions[i].scales[s].convs[j]/norms[j]
  encoder.local_extract.feature_propagators.{i}.unit_pointnet.{3j}/{3j+1}
    -> ...feature_propagators[i].convs[j]/norms[j]
  encoder.local_extract.final_layers.{0,1,3}
    -> final_conv1 / final_norm / final_conv2
  encoder.global_extract.conv{k}/bn{k} -> same names
  encoder.conv{1,2,3}/bn{1,2}          -> same names
  latent_ode.ode_func.dynamics_net.{2k} -> latent_ode.layer{k}
  point_cnf.chain.{c}...               -> point_cnf[c]...
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _strip_module_prefix(sd: Dict[str, "np.ndarray"]):
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    return sd


def _to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_w(arr):
    arr = _to_np(arr)
    if arr.ndim == 3:  # Conv1d kernel-size-1
        if arr.shape[-1] != 1:
            raise ValueError(f"unexpected conv kernel {arr.shape}")
        arr = arr[..., 0]
    return arr


def convert_torch_state_dict(sd: Dict) -> Tuple[dict, dict]:
    """Convert a reference state dict to (params, state) pytrees (numpy).

    Only the keys present in the checkpoint are emitted — pass the result
    through ``train.checkpoint.load_weights`` to merge into an initialized
    model (which also reports any mismatches).
    """
    sd = _strip_module_prefix(sd)

    params: dict = {}
    state: dict = {}

    def ensure(d, *path):
        for p in path:
            d = d.setdefault(p, {})
        return d

    def put(tree_path, leaf_name, value):
        node = ensure(params, *tree_path)
        node[leaf_name] = value

    # list-like subtrees are dicts keyed by int during assembly; fixed below
    for key, val in sd.items():
        parts = key.split(".")

        # ---- encoder ----
        if key.startswith("encoder.local_extract.set_abstractions."):
            i, kind, s = int(parts[3]), parts[4], int(parts[5])
            j = int(parts[7])
            leaf = parts[8]
            if kind != "pointnet_modules":
                raise KeyError(f"unhandled set-abstraction key {key}")
            group = "convs" if parts[6] == "conv_layers" else "norms"
            value = _conv_w(val) if group == "convs" and leaf == "weight" else _to_np(val)
            put(
                ("encoder", "local_extract", "set_abstractions", i, "scales", s, group, j),
                leaf,
                value,
            )
        elif key.startswith("encoder.local_extract.feature_propagators."):
            i = int(parts[3])
            seq_idx = int(parts[5])
            leaf = parts[6]
            if seq_idx % 3 == 0:
                put(
                    ("encoder", "local_extract", "feature_propagators", i, "convs", seq_idx // 3),
                    leaf,
                    _conv_w(val) if leaf == "weight" else _to_np(val),
                )
            elif seq_idx % 3 == 1:
                put(
                    ("encoder", "local_extract", "feature_propagators", i, "norms", seq_idx // 3),
                    leaf,
                    _to_np(val),
                )
            else:
                raise KeyError(f"unexpected FP layer index in {key}")
        elif key.startswith("encoder.local_extract.final_layers."):
            seq_idx = int(parts[3])
            leaf = parts[4]
            name = {0: "final_conv1", 1: "final_norm", 3: "final_conv2"}[seq_idx]
            value = (
                _conv_w(val)
                if name.startswith("final_conv") and leaf == "weight"
                else _to_np(val)
            )
            node = ensure(params, "encoder", "local_extract", name)
            node[leaf] = value
        elif key.startswith("encoder.global_extract."):
            name, leaf = parts[2], parts[3]
            value = (
                _conv_w(val)
                if name.startswith("conv") and leaf == "weight"
                else _to_np(val)
            )
            node = ensure(params, "encoder", "global_extract", name)
            node[leaf] = value
        elif re.match(r"encoder\.(conv[123]|bn[12])\.", key):
            name, leaf = parts[1], parts[2]
            value = (
                _conv_w(val)
                if name.startswith("conv") and leaf == "weight"
                else _to_np(val)
            )
            node = ensure(params, "encoder", name)
            node[leaf] = value

        # ---- latent ODE ----
        elif key.startswith("latent_ode.ode_func.dynamics_net."):
            seq_idx = int(parts[3])
            leaf = parts[4]
            if seq_idx % 2:
                raise KeyError(f"non-linear layer has params: {key}")
            node = ensure(params, "latent_ode", f"layer{seq_idx // 2}")
            node[leaf] = _to_np(val)
        elif key.startswith("latent_ode.ode_func._num_evals"):
            continue  # NFE buffer: solver state, not a parameter

        # ---- point CNF chain ----
        elif key.startswith("point_cnf.chain."):
            c = int(parts[2])
            rest = parts[3:]
            if rest[0] in ("weight", "bias"):
                node = ensure(params, "point_cnf", c)
                node[rest[0]] = _to_np(val)
            elif rest[0] in ("running_mean", "running_var", "step"):
                node = ensure(state, "point_cnf", c)
                node[rest[0]] = _to_np(val).reshape(-1) if rest[0] == "step" else _to_np(val)
            elif rest[0] == "sqrt_end_time":
                node = ensure(params, "point_cnf", c)
                node["sqrt_end_time"] = _to_np(val).reshape(())
            elif rest[0] == "odefunc":
                if rest[1] == "_num_evals":
                    continue
                if rest[1] != "diffeq" or rest[2] != "layers":
                    raise KeyError(f"unhandled CNF key {key}")
                j = int(rest[3])
                sub = rest[4]  # _layer | _hyper_bias | _hyper_gate
                leaf = rest[5]
                node = ensure(params, "point_cnf", c, "odenet", "layers", j, sub)
                node[leaf] = _to_np(val)
            else:
                raise KeyError(f"unhandled CNF key {key}")
        else:
            print(f"WARNING: unhandled checkpoint key {key} - skipping")

    def listify(tree):
        """Turn int-keyed dicts into lists recursively, keeping positional
        gaps as empty dicts (e.g. the CNF chain holds running stats only at
        the MovingBatchNorm slots 0 and 2)."""
        if isinstance(tree, dict):
            if tree and all(isinstance(k, int) for k in tree):
                return [listify(tree.get(k, {})) for k in range(max(tree) + 1)]
            return {k: listify(v) for k, v in tree.items()}
        return tree

    return listify(params), listify(state)


def convert_torch_checkpoint(path: str) -> Tuple[dict, dict]:
    """Load a reference .pth checkpoint (tensors only: ``weights_only``)
    and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_torch_state_dict(sd)
