"""Conditional CNF over points (counterpart of caspr_tpu/models/cnf.py):
the chain MovingBatchNorm -> CNF block(s) -> MovingBatchNorm, in both
directions, with running statistics, and the likelihood direction's
training form.

Sampling (``flow_reverse``) visits the chain back to front and maps base
samples to points.  The CNF block integrates from 0 to t_end =
sqrt_end_time^2 with the time-reflected reverse dynamics, t_phys = t_end -
s and the field negated, so the solver always runs forward.  By default it
integrates the points alone (no log-density channel: decode never reads
it).  With ``sample_div=True`` it integrates the reference's two-leaf state
instead, the points and a log-density from zero with the field (-dx,
e^T J e) for one Hutchinson noise e held for the solve: dopri5's error norm
then has the log-density's term, so the decode takes the reference's
accepted steps and NFE (reference cnf.py:85-99; the JAX package's
CASPR_TPU_SAMPLE_DIV=1).  The log-density is discarded.

Likelihood (``flow_forward``) visits the chain front to back and maps
points to the base space together with the change of their log-density.
The CNF block integrates the two-leaf state (points, log-density) with the
Hutchinson estimate of the divergence, -e^T J e per point, for one noise
tensor e drawn per solve and held fixed across evaluations.

The ODEnet is any of the JAX package's layer types (ignore, concat,
concat_v2, squash, scale, concatsquash, concatscale) with any of its
nonlinearities (tanh, relu, softplus, elu, square, identity, swish with a
learned beta per layer, ``odenet.swish_beta``), chosen by ``CNFConfig``.
For a config the fused kernels take (``ops.cnf_fused.kernel_takes``:
concatsquash with softplus, equal hidden widths, a multiple of 32 up to
512, 1-6 hidden-to-hidden layers) its per-point work runs in them
(``ops.kernels.cnf_primal`` and ``cnf_dynamics``, their plain versions for
CPU tensors); any other config runs the unfused composition
(``reference_primal``, ``reference_dynamics``) on either device, with
autograd as its VJP in training, as the JAX package runs ``odenet_apply``
where ``can_fuse`` is false.

``CNFConfig.matmul_dtype`` is the ODEnet's arithmetic: "f32" (the
default, the JAX package's choice on any backend but a TPU) or "bf16", every
layer product's operands rounded to bfloat16 with float32 accumulation, the
JAX package's CASPR_TPU_CNF_MATMUL=bf16 (its default on a TPU at the default
--matmul-precision), which the port takes as this field and not from the
environment.  It applies where the JAX package runs its kernels,
``ops.cnf_fused.bf16_takes`` (its ``can_fuse``: widths a multiple of 128, two
or three of them), and is read nowhere else (``matmul_mode``): there the
ODEnet runs in float32, the fused kernels included.  Where both rules hold,
bf16 reaches ``cnf_primal`` and ``cnf_dynamics``; where only ``bf16_takes``
holds (widths of 640 and up) the composition runs with the kernels'
roundings (``rounded_primal``, ``rounded_dynamics``).  The VJP is float32,
as the JAX package's default backward differentiates the float32
composition; ``CNFConfig.bwd_matmul_dtype="bf16"`` (only with
``matmul_dtype="bf16"``) runs it with its products in bf16, the JAX
package's CASPR_TPU_CNF_BWD=pallas in that mode: the ``cnf_dynamics_vjp``
kernel's bf16 variant, or ``dynamics_vjp_packed(..., "bf16")`` past the
kernels' widths.

Training (``training=True`` of the likelihood direction) solves each block
through ``odeint_adjoint`` with the ODEnet's parameters (swish_beta among
them), the context and t_end as its args (each evaluation of the
adjoint's augmented dynamics runs ``cnf_dynamics`` and its VJP kernel
``cnf_dynamics_vjp``, or the composition and autograd); t_end =
sqrt_end_time^2 enters as the last request time, so its gradient is the
adjoint's dL/dts.  With ``ode_backward="discrete"`` the block is solved by
``odeint_discrete`` under autograd instead: each evaluation's
``cnf_dynamics`` saves its inputs, and the backward runs
``cnf_dynamics_vjp`` once per evaluation that reaches the loss; t_end's
gradient comes through the dense output.  The MovingBatchNorms update
their running statistics from the batch (PointFlow's transpose-reshape
statistics) and normalise with the statistics from before the update.

Sharded over ranks (``groups=``, ``parallel.mesh.Groups``), a rank holds
its rows of the batch and, with sp, its range of each cloud's points: the
solvers' error norms run over the whole group, the Hutchinson noise is
drawn at the global shape and cut, the MovingBatchNorm statistics are
taken on the gathered global batch, and the context's cotangent, a sum
over points, is summed over the point group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import cnf_dynamics, cnf_primal, odeint
from ..ops.cnf_fused import (bf16_takes, check_matmul_dtype, context_gb, kernel_takes,
                              pack_weights, reference_dynamics, reference_primal,
                              rounded_dynamics, rounded_primal)
from ..ops.odeint import DISCRETE_STEPS, REPLICATED, ROWS, flatten_tree, nfe_add, odeint_train
from ..parallel.mesh import all_gather_cat, global_draw, sum_grad
from ..utils.profiling import annotate


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
    matmul_dtype: str = "f32"  # "f32" | "bf16": the ODEnet's products (bf16_takes)
    bwd_matmul_dtype: str = "f32"  # "f32" | "bf16" (with matmul_dtype "bf16"): its VJP's

    def __post_init__(self):
        check_matmul_dtype(self.matmul_dtype)
        check_matmul_dtype(self.bwd_matmul_dtype)
        if self.bwd_matmul_dtype == "bf16" and self.matmul_dtype != "bf16":
            raise ValueError("bwd_matmul_dtype='bf16' needs matmul_dtype='bf16': the VJP's "
                             "bf16 products are those of the bf16 forward")

    def chain(self) -> Tuple[str, ...]:
        blocks = ("cnf",) * self.num_blocks
        if self.batch_norm:
            return ("mbn",) + blocks + ("mbn",)
        return blocks


def _layer_shapes(layer_type: str, d_in: int, d_out: int, zdim: int):
    """The leaves of one layer, as caspr_tpu/models/cnf.py::_layer_init
    makes them, in the (out, in) layout."""
    lin = lambda n_in: {"weight": (d_out, n_in), "bias": (d_out,)}
    if layer_type == "ignore":
        return {"_layer": lin(d_in)}
    if layer_type == "concat":
        return {"_layer": lin(d_in + 1 + zdim)}
    if layer_type == "concat_v2":
        return {"_layer": lin(d_in), "_hyper_bias": {"weight": (d_out, 1 + zdim)}}
    if layer_type in ("squash", "scale"):
        return {"_layer": lin(d_in), "_hyper": lin(1 + zdim)}
    if layer_type in ("concatsquash", "concatscale"):
        return {"_layer": lin(d_in), "_hyper_bias": {"weight": (d_out, 1 + zdim)},
                "_hyper_gate": lin(1 + zdim)}
    raise ValueError(f"unknown diffeq layer type {layer_type!r}")


def flow_param_shapes(cfg: CNFConfig):
    """(params, state) shape trees of the chain."""
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
            layers.append(_layer_shapes(cfg.layer_type, d_in, d_out, cfg.zdim))
            d_in = d_out
        block = {"odenet": {"layers": layers}}
        if cfg.nonlinearity == "swish":
            block["odenet"]["swish_beta"] = (len(cfg.dims),)
        if cfg.train_T:
            block["sqrt_end_time"] = ()
        params.append(block)
        state.append({})
    return params, state


def fused_concatsquash_primal(params, tc, y, matmul_dtype: str = "f32"):
    """The ODEnet through the fused kernel: gates and effective biases from
    tc = [t, context] in plain PyTorch, the per-point layers in the kernel,
    its products in ``matmul_dtype``."""
    return cnf_primal(y, context_gb(params, tc), *pack_weights(params), matmul_dtype)


def fused_concatsquash_dynamics(params, tc, y, e, matmul_dtype: str = "f32",
                                bwd_matmul_dtype: str = "f32"):
    """(f(y), e^T J_f(y) e) through the fused with-divergence kernel, its VJP
    kernel's products in ``bwd_matmul_dtype``."""
    return cnf_dynamics(y, e, context_gb(params, tc), *pack_weights(params), matmul_dtype,
                        bwd_matmul_dtype)


def matmul_mode(cfg: CNFConfig) -> Tuple[str, str]:
    """(forward, backward) products of the ODEnet: the config's where
    ``bf16_takes`` holds, else float32 (the JAX package's rule:
    caspr_tpu/models/cnf.py::_dynamics_kernel_mode runs its kernels, and so
    their bf16 mode, only where ``can_fuse`` holds)."""
    if bf16_takes(cfg):
        return cfg.matmul_dtype, cfg.bwd_matmul_dtype
    return "f32", "f32"


def odenet_primal(params, cfg: CNFConfig, tc, y):
    """f(y): the fused kernel where the config fits it, else the
    composition, in ``matmul_mode``'s arithmetic."""
    mode = matmul_mode(cfg)[0]
    if kernel_takes(cfg):
        return fused_concatsquash_primal(params, tc, y, mode)
    if mode == "bf16":
        return rounded_primal(y, context_gb(params, tc), *pack_weights(params))
    return reference_primal(params, tc, y, cfg.layer_type, cfg.nonlinearity)


def odenet_dynamics(params, cfg: CNFConfig, tc, y, e):
    """(f(y), e^T J_f(y) e): the fused kernel where the config fits it, else
    the composition, in ``matmul_mode``'s arithmetic."""
    mode, bwd = matmul_mode(cfg)
    if kernel_takes(cfg):
        return fused_concatsquash_dynamics(params, tc, y, e, mode, bwd)
    if mode == "bf16":
        return rounded_dynamics(y, e, context_gb(params, tc), *pack_weights(params), bwd)
    return reference_dynamics(params, tc, y, e, cfg.layer_type, cfg.nonlinearity)


def _end_time(params, cfg: CNFConfig) -> np.float32:
    if cfg.train_T:
        end = params["sqrt_end_time"] * params["sqrt_end_time"]
        with annotate("caspr::host_read"):
            return np.float32(end.item())
    return np.float32(cfg.time_length)


def _time_context(t, context):
    """tc = [t, context]: (BT, 1 + zdim)."""
    col = torch.full((context.shape[0], 1), float(t), dtype=context.dtype, device=context.device)
    return torch.cat([col, context], dim=1)


def cnf_block_apply(params, cfg: CNFConfig, x, context, groups=None, *, sample_div: bool = False,
                    e=None):
    """One CNF block, reverse (sampling) direction.  x: (BT, N, D), context
    (BT, zdim) -> (y (BT, N, D), nfe).  By default it integrates the points
    alone.  ``sample_div=True`` integrates (points, log-density from 0) with
    the field (-dx, e^T J e) for the Hutchinson noise e (BT, N, D), as the
    reference decodes, and discards the log-density.  ``groups``: the
    process groups over which the rows and points are sharded; the solver's
    norms run over the whole group (``ops.odeint``)."""
    t_end = _end_time(params, cfg)
    bt, n, d = x.shape
    odenet = params["odenet"]
    ts = np.array([0.0, t_end], np.float32)
    # time-reflected: solver time s runs 0 -> t_end, the flow's time is
    # t_end - s, and the field is negated.  The state rides flattened
    # (BT, N*D) as in the JAX package.
    if sample_div:
        def dynamics(s, state):
            tc = _time_context(t_end - s, context)
            dx, div = odenet_dynamics(odenet, cfg, tc, state[0].reshape(bt, n, d), e)
            return -dx.reshape(bt, -1), div

        (xs, _), nfe = odeint(dynamics, (x.reshape(bt, n * d), x.new_zeros((bt, n))), ts,
                              rtol=cfg.rtol, atol=cfg.atol, group=_whole(groups))
        return xs[1].reshape(bt, n, d), nfe

    def dynamics(s, x_flat):
        tc = _time_context(t_end - s, context)
        return -odenet_primal(odenet, cfg, tc, x_flat.reshape(bt, n, d)).reshape(bt, -1)

    xs, nfe = odeint(dynamics, x.reshape(bt, n * d), ts, rtol=cfg.rtol, atol=cfg.atol,
                     group=_whole(groups))
    return xs[1].reshape(bt, n, d), nfe


def _whole(groups):
    return None if groups is None else groups.whole


def cnf_block_forward(params, cfg: CNFConfig, x, context, logpx, e, *, training: bool = False,
                      nfe_sink=None, ode_backward: str = "adjoint",
                      ode_steps: int = DISCRETE_STEPS, groups=None):
    """One CNF block, forward (likelihood) direction, on (points,
    log-density).  x, e: (BT, N, D); context (BT, zdim); logpx (BT, N, 1)
    -> (y (BT, N, D), logpy (BT, N, 1), nfe).  e is the Hutchinson noise,
    fixed for the whole solve and a constant of the adjoint (as in the TPU
    kernel's VJP and the reference).  ``training=True`` solves through
    ``odeint_train``: the adjoint, reporting its backward NFE to
    ``nfe_sink``, or with ``ode_backward="discrete"`` autograd through at
    most ``ode_steps`` solver steps.  ``groups``: the process groups over
    which the rows and points are sharded; the ODEnet's parameters and
    t_end are the adjoint's replicated args, the context its ROWS arg (a
    sum over the point group's points at each evaluation).  Under
    autograd ("discrete") the context's cotangent is summed over the point
    group once, so that it is the one-process cotangent of the rank's rows
    in both modes."""
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
        kinds = [REPLICATED] * len(flatten_tree(params["odenet"])[0]) + [ROWS, REPLICATED]
        point = None if groups is None else groups.point
        if ode_backward == "discrete":
            context = sum_grad(context, point, "discrete_ctx")
        (xs, lps), nfe = odeint_train(dynamics, state0, ts, (params["odenet"], context, t_end),
                                      rtol=cfg.rtol, atol=cfg.atol, backward=ode_backward,
                                      num_steps=ode_steps, nfe_sink=nfe_sink, group=_whole(groups),
                                      kinds=kinds, point_group=point)
    else:
        ts = np.array([0.0, _end_time(params, cfg)], np.float32)
        args = (params["odenet"], context)
        (xs, lps), nfe = odeint(lambda t, state: dynamics(t, state, args), state0, ts,
                                rtol=cfg.rtol, atol=cfg.atol, group=_whole(groups))
    return xs[1].reshape(bt, n, d), lps[1].reshape(bt, n, 1), nfe


def _mbn_batch_stats(x, groups=None):
    """PointFlow's running-statistics update reads x transposed to
    (N, BT, C) and reshaped to (C, -1) -- not a per-channel reduction; kept
    as the JAX package keeps it (caspr_tpu/models/cnf.py::_mbn_batch_stats).
    Returns (mean, unbiased variance) over each row.

    With process groups x is this rank's rows (and points) of the global
    batch; the quirk's rows are point ranges over every rank's rows (cut
    inside a point where C does not divide N, at a place that depends on
    the number of ranks and the points a rank holds), so the global batch
    is gathered, its points over the point group, then its rows over the
    batch group, and the one-process statistics taken on it."""
    if groups is not None:
        if groups.point is not None:
            x = all_gather_cat(x, groups.point, "mbn", dim=1)
        x = all_gather_cat(x, groups.batch, "mbn")
    xt = x.transpose(0, 1).reshape(x.shape[-1], -1)
    return xt.mean(dim=1), xt.var(dim=1, correction=1)


def mbn_forward(params, state, cfg: CNFConfig, x, logpx, training: bool = False, groups=None):
    """The MovingBatchNorm with its running statistics and its log-det:
    (y, logpx - sum_c(weight_c - log(var_c + eps) / 2), new_state).  It
    normalises with the statistics from before the update; with
    ``training`` the new state moves them bn_decay of the way to the
    batch's (no gradient; global over ``groups``) and counts the
    step, else it is ``state``."""
    new_state = state
    if training:
        with torch.no_grad():
            bmean, bvar = _mbn_batch_stats(x, groups)
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


def flow_reverse(params, state, cfg: CNFConfig, y, context, groups=None, *,
                 sample_div: bool = False, generator=None, e=None):
    """Base samples y (BT, N, D) -> points, visiting the chain back to
    front.  Returns (x, nfe).  ``sample_div=True`` decodes as the reference
    does (``cnf_block_apply``), each block with a Hutchinson noise drawn
    from ``generator`` or taken from ``e``, as ``flow_forward`` draws and
    takes it.  ``groups``: the process groups over which the rows and points
    are sharded."""
    noise = _noise_list(e)
    kinds = cfg.chain()
    nfe, block = 0.0, 0
    for i in range(len(kinds) - 1, -1, -1):
        if kinds[i] == "mbn":
            y = mbn_reverse(params[i], state[i], cfg, y)
            continue
        cur = _block_noise(noise, block, generator, y, groups) if sample_div else None
        y, block_nfe = cnf_block_apply(params[i], cfg, y, context, groups, sample_div=sample_div,
                                       e=cur)
        nfe = nfe_add(nfe, block_nfe)
        block += 1
    return y, nfe


def _noise_list(e):
    return None if e is None else ([e] if isinstance(e, torch.Tensor) else list(e))


def _block_noise(noise, block, generator, x, groups):
    """A block's Hutchinson noise: ``noise[block]``, else drawn from
    ``generator`` at x's shape (the global shape under ``groups``, this
    rank's part kept)."""
    if noise is not None:
        return noise[block]
    draw = lambda shape: torch.randn(shape, generator=generator, dtype=x.dtype, device=x.device)
    return draw(x.shape) if groups is None else global_draw(draw, x.shape, groups)


def flow_total_time(params, cfg: CNFConfig):
    """The sum of the CNF blocks' end times, sqrt_end_time^2 each (a tensor
    with its gradient) or time_length without train_T: the counterpart of
    the reference's count_total_time (flow.py:29-41)."""
    total = 0.0
    for kind, p in zip(cfg.chain(), params):
        if kind == "cnf":
            total = total + (p["sqrt_end_time"] * p["sqrt_end_time"] if cfg.train_T
                             else cfg.time_length)
    return total


def flow_forward(params, state, cfg: CNFConfig, x, context, logpx, generator=None, e=None, *,
                 training: bool = False, nfe_sink=None, ode_backward: str = "adjoint",
                 ode_steps: int = DISCRETE_STEPS, groups=None):
    """Points x (BT, N, D) with log-density channel logpx (BT, N, 1) ->
    (y, logpy, new_state, nfe), visiting the chain front to back.

    Each CNF block draws its Hutchinson noise (BT, N, D) from ``generator``;
    ``e``, a tensor for a chain of one block or a sequence with one tensor
    per block, replaces the draw (and ``generator`` is not used).
    ``training`` updates the MovingBatchNorm statistics (new_state) and
    solves the blocks for their gradient (``cnf_block_forward``).

    ``groups``: the process groups over which the rows and points are
    sharded, this rank's rows being the batch-group rank's equal part of
    the global batch and its points the point-group rank's range.  Each
    block's noise is then drawn at the global shape (R_dp * BT, sp * N, D)
    and this rank keeps its rows and points, so that ranks whose generators
    are alike hold the one-process noise; ``e`` is this rank's part."""
    noise = _noise_list(e)
    new_state = list(state)
    nfe, block = 0.0, 0
    for i, (kind, p) in enumerate(zip(cfg.chain(), params)):
        if kind == "mbn":
            x, logpx, new_state[i] = mbn_forward(p, state[i], cfg, x, logpx, training, groups)
            continue
        cur = _block_noise(noise, block, generator, x, groups)
        x, logpx, block_nfe = cnf_block_forward(p, cfg, x, context, logpx, cur,
                                                training=training, nfe_sink=nfe_sink,
                                                ode_backward=ode_backward, ode_steps=ode_steps,
                                                groups=groups)
        nfe = nfe_add(nfe, block_nfe)
        block += 1
    return x, logpx, new_state, nfe
