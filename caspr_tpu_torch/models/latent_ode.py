"""Latent neural ODE advecting the motion feature (counterpart of
caspr_tpu/models/latent_ode.py): a tanh MLP integrated by dopri5 at
rtol = atol = 1e-3.  The reference's ODESolver sets ``self.atol = rtol``,
so its advertised atol of 1e-4 never takes effect; the effective value is
kept here as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..nn import linear
from ..ops import odeint
from ..ops.odeint import DISCRETE_STEPS, REPLICATED, odeint_train


@dataclass(frozen=True)
class LatentODEConfig:
    input_size: int = 64
    hidden_size: int = 512
    num_layers: int = 2  # hidden-to-hidden layers (4 linear layers in all)
    rtol: float = 1e-3
    atol: float = 1e-3  # the reference's effective value (see above)
    augment_size: int = 0

    @property
    def output_size(self) -> int:
        return self.input_size + self.augment_size


def dynamics_param_shapes(cfg: LatentODEConfig):
    dims = [cfg.output_size] + [cfg.hidden_size] * (cfg.num_layers + 1) + [cfg.output_size]
    return {f"layer{i}": {"weight": (dims[i + 1], dims[i]), "bias": (dims[i + 1],)}
            for i in range(len(dims) - 1)}


def dynamics_apply(params, z):
    n = len(params)
    for i in range(n):
        z = linear(params[f"layer{i}"], z)
        if i < n - 1:
            z = torch.tanh(z)
    return z


def latent_ode_solve(params, cfg: LatentODEConfig, z0, t, *, adjoint: bool = False,
                     nfe_sink=None, ode_backward: str = "adjoint",
                     ode_steps: int = DISCRETE_STEPS, group=None):
    """Advect z0 (B, H) to every time of t (T,), non-decreasing, relative to
    t[0].  Returns (pred_z (B, T, H'), nfe).  ``adjoint=True`` (training)
    solves through ``odeint_train`` with the parameters as its args, so
    gradients reach z0 and every parameter: by the continuous adjoint, whose
    backward NFE goes to ``nfe_sink``, or with ``ode_backward="discrete"``
    by autograd through at most ``ode_steps`` solver steps.  Repeated request times are zero-length intervals of the
    adjoint, two evaluations each, as in the JAX package.
    ``group``: a process group over which z0's rows are sharded (every
    rank passes the same t); the parameters are the adjoint's replicated
    args.  Under point parallelism it is the batch group: every rank of a
    point group solves the same rows alike."""
    rel_t = t - t[0]
    if cfg.augment_size > 0:
        z0 = torch.cat([z0, z0.new_zeros((z0.shape[0], cfg.augment_size))], dim=1)
    if adjoint:
        zs, nfe = odeint_train(lambda _t, z, p: dynamics_apply(p, z), z0, rel_t, params,
                               rtol=cfg.rtol, atol=cfg.atol, backward=ode_backward,
                               num_steps=ode_steps, nfe_sink=nfe_sink, group=group,
                               kinds=REPLICATED)
    else:
        zs, nfe = odeint(lambda _t, z: dynamics_apply(params, z), z0, rel_t,
                         rtol=cfg.rtol, atol=cfg.atol, group=group)  # (T, B, H')
    return zs.permute(1, 0, 2), nfe
