"""Conditional CNF over points (counterpart of caspr_tpu/models/cnf.py):
the chain MovingBatchNorm -> CNF block -> MovingBatchNorm, in both
directions, with running statistics, and the likelihood direction's
training form.

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

The dynamics are the concatsquash ODEnet with softplus.  For a config the
fused kernels take (``ops.cnf_fused.kernel_takes``: equal hidden widths, a
multiple of 32 up to 512, 1-6 hidden-to-hidden layers) its per-point work
runs in them (``ops.kernels.cnf_primal`` and ``cnf_dynamics``, their plain
versions for CPU tensors); any other config runs the unfused composition
(``reference_primal``, ``reference_dynamics``) on either device, with
autograd as its VJP in training, as the JAX package runs ``odenet_apply``
where ``can_fuse`` is false.

Training (``training=True`` of the likelihood direction) solves each block
through ``odeint_adjoint`` with the ODEnet's parameters, the context and
t_end as its args (each evaluation of the adjoint's augmented dynamics
runs ``cnf_dynamics`` and its VJP kernel ``cnf_dynamics_vjp``, or the
composition and autograd); t_end = sqrt_end_time^2 enters as the last
request time, so its gradient is the adjoint's dL/dts.  With
``ode_backward="discrete"`` the block is solved by ``odeint_discrete``
under autograd instead: each evaluation's ``cnf_dynamics`` saves its
inputs, and the backward runs ``cnf_dynamics_vjp`` once per evaluation
that reaches the loss; t_end's gradient comes through the dense output.  The
MovingBatchNorms update their running statistics
from the batch (PointFlow's transpose-reshape statistics) and normalise
with the statistics from before the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import cnf_dynamics, cnf_primal, odeint
from ..ops.cnf_fused import (context_gb, kernel_takes, pack_weights, reference_dynamics,
                              reference_primal)
from ..ops.odeint import DISCRETE_STEPS, nfe_add, odeint_train


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


def odenet_primal(params, cfg: CNFConfig, tc, y):
    """f(y): the fused kernel where the config fits it, else the composition."""
    if kernel_takes(cfg):
        return fused_concatsquash_primal(params, tc, y)
    return reference_primal(params, tc, y)


def odenet_dynamics(params, cfg: CNFConfig, tc, y, e):
    """(f(y), e^T J_f(y) e): the fused kernel where the config fits it, else
    the composition."""
    if kernel_takes(cfg):
        return fused_concatsquash_dynamics(params, tc, y, e)
    return reference_dynamics(params, tc, y, e)


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
        return -odenet_primal(odenet, cfg, tc, x_flat.reshape(bt, n, d)).reshape(bt, -1)

    ts = np.array([0.0, t_end], np.float32)
    xs, nfe = odeint(dynamics, x.reshape(bt, n * d), ts, rtol=cfg.rtol, atol=cfg.atol)
    return xs[1].reshape(bt, n, d), nfe


def cnf_block_forward(params, cfg: CNFConfig, x, context, logpx, e, *, training: bool = False,
                      nfe_sink=None, ode_backward: str = "adjoint",
                      ode_steps: int = DISCRETE_STEPS):
    """One CNF block, forward (likelihood) direction, on (points,
    log-density).  x, e: (BT, N, D); context (BT, zdim); logpx (BT, N, 1)
    -> (y (BT, N, D), logpy (BT, N, 1), nfe).  e is the Hutchinson noise,
    fixed for the whole solve and a constant of the adjoint (as in the TPU
    kernel's VJP and the reference).  ``training=True`` solves through
    ``odeint_train``: the adjoint, reporting its backward NFE to
    ``nfe_sink``, or with ``ode_backward="discrete"`` autograd through at
    most ``ode_steps`` solver steps."""
    _check_supported(cfg)
    bt, n, d = x.shape

    def dynamics(t, state, args):
        # the state rides flattened, (BT, N*D) and (BT, N), as in the JAX
        # package: the solver's error norm is taken per leaf
        odenet, ctx = args[0], args[1]
        dx, div = odenet_dynamics(odenet, cfg, _time_context(t, ctx), state[0].reshape(bt, n, d), e)
        return dx.reshape(bt, -1), -div

    state0 = (x.reshape(bt, n * d), logpx.reshape(bt, n))
    if training:
        # the adjoint's args: every raw parameter leaf of the ODEnet, the
        # context and t_end (whose own adjoint leaf stays 0 here: the
        # forward dynamics do not read it), the leaves of the JAX args
        t_end = (params["sqrt_end_time"] * params["sqrt_end_time"] if cfg.train_T
                 else torch.tensor(cfg.time_length, dtype=x.dtype, device=x.device))
        ts = torch.stack([torch.zeros_like(t_end), t_end])
        (xs, lps), nfe = odeint_train(dynamics, state0, ts, (params["odenet"], context, t_end),
                                      rtol=cfg.rtol, atol=cfg.atol, backward=ode_backward,
                                      num_steps=ode_steps, nfe_sink=nfe_sink)
    else:
        ts = np.array([0.0, _end_time(params, cfg)], np.float32)
        args = (params["odenet"], context)
        (xs, lps), nfe = odeint(lambda t, state: dynamics(t, state, args), state0, ts,
                                rtol=cfg.rtol, atol=cfg.atol)
    return xs[1].reshape(bt, n, d), lps[1].reshape(bt, n, 1), nfe


def _mbn_batch_stats(x):
    """PointFlow's running-statistics update reads x transposed to
    (N, BT, C) and reshaped to (C, -1) -- not a per-channel reduction; kept
    as the JAX package keeps it (caspr_tpu/models/cnf.py::_mbn_batch_stats).
    Returns (mean, unbiased variance) over each row."""
    xt = x.transpose(0, 1).reshape(x.shape[-1], -1)
    return xt.mean(dim=1), xt.var(dim=1, correction=1)


def mbn_forward(params, state, cfg: CNFConfig, x, logpx, training: bool = False):
    """The MovingBatchNorm with its running statistics and its log-det:
    (y, logpx - sum_c(weight_c - log(var_c + eps) / 2), new_state).  It
    normalises with the statistics from before the update; with
    ``training`` the new state moves them bn_decay of the way to the
    batch's (no gradient) and counts the step, else it is ``state``."""
    new_state = state
    if training:
        with torch.no_grad():
            bmean, bvar = _mbn_batch_stats(x)
            mean, var = state["running_mean"], state["running_var"]
            new_state = {"running_mean": mean - cfg.bn_decay * (mean - bmean),
                         "running_var": var - cfg.bn_decay * (var - bvar),
                         "step": state["step"] + 1.0}
    half_log_var = -0.5 * torch.log(state["running_var"] + cfg.bn_eps)
    y = (x - state["running_mean"]) * torch.exp(half_log_var)
    y = y * torch.exp(params["weight"]) + params["bias"]
    return y, logpx - (half_log_var + params["weight"]).sum(), new_state


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


def flow_forward(params, state, cfg: CNFConfig, x, context, logpx, generator=None, e=None, *,
                 training: bool = False, nfe_sink=None, ode_backward: str = "adjoint",
                 ode_steps: int = DISCRETE_STEPS):
    """Points x (BT, N, D) with log-density channel logpx (BT, N, 1) ->
    (y, logpy, new_state, nfe), visiting the chain front to back.

    Each CNF block draws its Hutchinson noise (BT, N, D) from ``generator``;
    ``e``, a tensor for a chain of one block or a sequence with one tensor
    per block, replaces the draw (and ``generator`` is not used).
    ``training`` updates the MovingBatchNorm statistics (new_state) and
    solves the blocks for their gradient (``cnf_block_forward``)."""
    noise = None if e is None else ([e] if isinstance(e, torch.Tensor) else list(e))
    new_state = list(state)
    nfe, block = 0.0, 0
    for i, (kind, p) in enumerate(zip(cfg.chain(), params)):
        if kind == "mbn":
            x, logpx, new_state[i] = mbn_forward(p, state[i], cfg, x, logpx, training)
            continue
        if noise is None:
            cur = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        else:
            cur = noise[block]
        x, logpx, block_nfe = cnf_block_forward(p, cfg, x, context, logpx, cur,
                                                training=training, nfe_sink=nfe_sink,
                                                ode_backward=ode_backward, ode_steps=ode_steps)
        nfe = nfe_add(nfe, block_nfe)
        block += 1
    return x, logpx, new_state, nfe
