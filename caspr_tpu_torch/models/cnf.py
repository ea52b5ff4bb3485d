"""Conditional CNF decoder, sampling direction (counterpart of
caspr_tpu/models/cnf.py): the chain MovingBatchNorm -> CNF block ->
MovingBatchNorm inverted back to front, mapping base samples to points.

The CNF block integrates the points alone (no log-density channel: decode
never reads it) from 0 to t_end = sqrt_end_time^2 with the time-reflected
reverse dynamics, t_phys = t_end - s and the field negated, so the solver
always runs forward.  The dynamics are the concatsquash ODEnet with
softplus, whose per-point work runs in the fused kernel
(``ops.kernels.cnf_primal``) for CUDA tensors.

The forward direction (log-likelihood, Hutchinson divergence, MBN
statistics) belongs to training and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import cnf_primal, odeint
from ..ops.cnf_fused import context_gb, pack_weights


@dataclass(frozen=True)
class CNFConfig:
    input_dim: int = 3
    dims: Tuple[int, ...] = (512, 512, 512)
    zdim: int = 512
    num_blocks: int = 1
    layer_type: str = "concatsquash"
    nonlinearity: str = "softplus"
    time_length: float = 0.5
    train_T: bool = True
    atol: float = 1e-5
    rtol: float = 1e-5
    batch_norm: bool = True
    bn_eps: float = 1e-4
    bn_decay: float = 0.1

    def chain(self) -> Tuple[str, ...]:
        blocks = ("cnf",) * self.num_blocks
        if self.batch_norm:
            return ("mbn",) + blocks + ("mbn",)
        return blocks


def _check_supported(cfg: CNFConfig):
    if cfg.layer_type != "concatsquash" or cfg.nonlinearity != "softplus":
        raise NotImplementedError(
            f"the port runs concatsquash + softplus, got {cfg.layer_type} + {cfg.nonlinearity}")


def flow_param_shapes(cfg: CNFConfig):
    """(params, state) shape trees of the chain."""
    _check_supported(cfg)
    params, state = [], []
    for kind in cfg.chain():
        if kind == "mbn":
            params.append({"weight": (cfg.input_dim,), "bias": (cfg.input_dim,)})
            state.append({"running_mean": (cfg.input_dim,), "running_var": (cfg.input_dim,),
                          "step": (1,)})
            continue
        layers = []
        d_in = cfg.input_dim
        for d_out in tuple(cfg.dims) + (cfg.input_dim,):
            layers.append({
                "_layer": {"weight": (d_out, d_in), "bias": (d_out,)},
                "_hyper_bias": {"weight": (d_out, 1 + cfg.zdim)},
                "_hyper_gate": {"weight": (d_out, 1 + cfg.zdim), "bias": (d_out,)},
            })
            d_in = d_out
        block = {"odenet": {"layers": layers}}
        if cfg.train_T:
            block["sqrt_end_time"] = ()
        params.append(block)
        state.append({})
    return params, state


def fused_concatsquash_primal(params, tc, y):
    """The ODEnet through the fused kernel: gates and effective biases from
    tc = [t, context] in plain PyTorch, the per-point layers in the kernel."""
    return cnf_primal(y, context_gb(params, tc), *pack_weights(params))


def cnf_block_apply(params, cfg: CNFConfig, x, context):
    """One CNF block, reverse (sampling) direction, on the points alone.
    x: (BT, N, D), context (BT, zdim) -> (y (BT, N, D), nfe)."""
    _check_supported(cfg)
    if cfg.train_T:
        t_end = np.float32((params["sqrt_end_time"] * params["sqrt_end_time"]).item())
    else:
        t_end = np.float32(cfg.time_length)
    bt, n, d = x.shape
    odenet = params["odenet"]

    def dynamics(s, x_flat):
        # time-reflected: solver time s runs 0 -> t_end, the flow's time is
        # t_end - s, and the field is negated.  The state rides flattened
        # (BT, N*D) as in the JAX package.
        tc = torch.cat([torch.full((bt, 1), float(t_end - s), dtype=x.dtype, device=x.device),
                        context], dim=1)
        return -fused_concatsquash_primal(odenet, tc, x_flat.reshape(bt, n, d)).reshape(bt, -1)

    ts = np.array([0.0, t_end], np.float32)
    xs, nfe = odeint(dynamics, x.reshape(bt, n * d), ts, rtol=cfg.rtol, atol=cfg.atol)
    return xs[1].reshape(bt, n, d), nfe


def mbn_reverse(params, state, cfg: CNFConfig, x):
    """Inverse of the MovingBatchNorm with its running statistics."""
    y = (x - params["bias"]) * torch.exp(-params["weight"])
    return y * torch.sqrt(state["running_var"] + cfg.bn_eps) + state["running_mean"]


def flow_reverse(params, state, cfg: CNFConfig, y, context):
    """Base samples y (BT, N, D) -> points, visiting the chain back to
    front.  Returns (x, nfe)."""
    kinds = cfg.chain()
    nfe = 0.0
    for i in range(len(kinds) - 1, -1, -1):
        if kinds[i] == "mbn":
            y = mbn_reverse(params[i], state[i], cfg, y)
        else:
            y, block_nfe = cnf_block_apply(params[i], cfg, y, context)
            nfe += block_nfe
    return y, nfe
