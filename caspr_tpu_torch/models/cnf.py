"""Conditional CNF over points (counterpart of caspr_tpu/models/cnf.py):
the chain MovingBatchNorm -> CNF block -> MovingBatchNorm, in both
directions, with running statistics (inference).

Sampling (``flow_reverse``) visits the chain back to front and maps base
samples to points.  The CNF block integrates the points alone (no
log-density channel: decode never reads it) from 0 to t_end =
sqrt_end_time^2 with the time-reflected reverse dynamics, t_phys = t_end -
s and the field negated, so the solver always runs forward.

Likelihood (``flow_forward``) visits the chain front to back and maps
points to the base space together with the change of their log-density.
The CNF block integrates the two-leaf state (points, log-density) with the
Hutchinson estimate of the divergence, -e^T J e per point, for one noise
tensor e drawn per solve and held fixed across evaluations.

The dynamics are the concatsquash ODEnet with softplus, whose per-point
work runs in the fused kernels (``ops.kernels.cnf_primal`` and
``cnf_dynamics``) for CUDA tensors.  The update of the MovingBatchNorm
statistics belongs to training and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import cnf_dynamics, cnf_primal, odeint
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


def fused_concatsquash_dynamics(params, tc, y, e):
    """(f(y), e^T J_f(y) e) through the fused with-divergence kernel."""
    return cnf_dynamics(y, e, context_gb(params, tc), *pack_weights(params))


def _end_time(params, cfg: CNFConfig) -> np.float32:
    if cfg.train_T:
        return np.float32((params["sqrt_end_time"] * params["sqrt_end_time"]).item())
    return np.float32(cfg.time_length)


def _time_context(t, context):
    """tc = [t, context]: (BT, 1 + zdim)."""
    col = torch.full((context.shape[0], 1), float(t), dtype=context.dtype, device=context.device)
    return torch.cat([col, context], dim=1)


def cnf_block_apply(params, cfg: CNFConfig, x, context):
    """One CNF block, reverse (sampling) direction, on the points alone.
    x: (BT, N, D), context (BT, zdim) -> (y (BT, N, D), nfe)."""
    _check_supported(cfg)
    t_end = _end_time(params, cfg)
    bt, n, d = x.shape
    odenet = params["odenet"]

    def dynamics(s, x_flat):
        # time-reflected: solver time s runs 0 -> t_end, the flow's time is
        # t_end - s, and the field is negated.  The state rides flattened
        # (BT, N*D) as in the JAX package.
        tc = _time_context(t_end - s, context)
        return -fused_concatsquash_primal(odenet, tc, x_flat.reshape(bt, n, d)).reshape(bt, -1)

    ts = np.array([0.0, t_end], np.float32)
    xs, nfe = odeint(dynamics, x.reshape(bt, n * d), ts, rtol=cfg.rtol, atol=cfg.atol)
    return xs[1].reshape(bt, n, d), nfe


def cnf_block_forward(params, cfg: CNFConfig, x, context, logpx, e):
    """One CNF block, forward (likelihood) direction, on (points,
    log-density).  x, e: (BT, N, D); context (BT, zdim); logpx (BT, N, 1)
    -> (y (BT, N, D), logpy (BT, N, 1), nfe).  e is the Hutchinson noise,
    fixed for the whole solve."""
    _check_supported(cfg)
    t_end = _end_time(params, cfg)
    bt, n, d = x.shape
    odenet = params["odenet"]

    def dynamics(t, state):
        # the state rides flattened, (BT, N*D) and (BT, N), as in the JAX
        # package: the solver's error norm is taken per leaf
        dx, div = fused_concatsquash_dynamics(
            odenet, _time_context(t, context), state[0].reshape(bt, n, d), e)
        return dx.reshape(bt, -1), -div

    ts = np.array([0.0, t_end], np.float32)
    (xs, lps), nfe = odeint(dynamics, (x.reshape(bt, n * d), logpx.reshape(bt, n)), ts,
                            rtol=cfg.rtol, atol=cfg.atol)
    return xs[1].reshape(bt, n, d), lps[1].reshape(bt, n, 1), nfe


def mbn_forward(params, state, cfg: CNFConfig, x, logpx):
    """The MovingBatchNorm with its running statistics and its log-det:
    (y, logpx - sum_c(weight_c - log(var_c + eps) / 2))."""
    half_log_var = -0.5 * torch.log(state["running_var"] + cfg.bn_eps)
    y = (x - state["running_mean"]) * torch.exp(half_log_var)
    y = y * torch.exp(params["weight"]) + params["bias"]
    return y, logpx - (half_log_var + params["weight"]).sum()


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


def flow_forward(params, state, cfg: CNFConfig, x, context, logpx, generator=None, e=None):
    """Points x (BT, N, D) with log-density channel logpx (BT, N, 1) ->
    (y, logpy, nfe), visiting the chain front to back.

    Each CNF block draws its Hutchinson noise (BT, N, D) from ``generator``;
    ``e``, a tensor for a chain of one block or a sequence with one tensor
    per block, replaces the draw (and ``generator`` is not used)."""
    noise = None if e is None else ([e] if isinstance(e, torch.Tensor) else list(e))
    nfe, block = 0.0, 0
    for kind, p, st in zip(cfg.chain(), params, state):
        if kind == "mbn":
            x, logpx = mbn_forward(p, st, cfg, x, logpx)
            continue
        if noise is None:
            cur = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        else:
            cur = noise[block]
        x, logpx, block_nfe = cnf_block_forward(p, cfg, x, context, logpx, cur)
        nfe += block_nfe
        block += 1
    return x, logpx, nfe
