"""CaSPR: TPointNet++ encoder -> latent ODE -> CNF decoder (counterpart of
caspr_tpu/models/caspr.py): the reconstruct path, and the likelihood path
(``forward``) as evaluation runs it (running statistics) and as training
runs it (``training=True``: both solves differentiable, through the
continuous adjoint or, with ``ode_backward="discrete"``, autograd through
the solver; the MovingBatchNorm statistics updated).

``CaSPRModel(cfg, device)`` binds a config and a device; parameters and
the MovingBatchNorm state are dicts of tensors on that device, from a
checkpoint (``caspr_tpu_torch.weights``) or freshly drawn (``caspr_init``).
The device defaults to the card: without CUDA the constructor raises
unless the caller asks for the CPU.

Sharded over ranks (``groups=``, ``parallel.mesh.Groups``), a rank holds
its rows of the global batch and, with sp, its range of each cloud's
points.  The encoder needs whole clouds (FPS, the ball query, three-NN):
the input is gathered over the point group ahead of it, the encoder runs
alike on every rank of a point group, and the rank keeps its points of the
T-NOCS prediction.  The latent ODE solves the rank's rows over the batch
group, alike on every rank of a point group; its parameters and the
latent code enter the gradient once (``parallel.mesh.count_once``).  The
CNF solves the rank's rows and points over the whole group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..ops import sample_gaussian, sphere_surface_points, standard_normal_logprob
from ..ops.odeint import DISCRETE_STEPS, NFESink
from ..parallel.mesh import all_gather_cat, count_once, global_draw, group_rank_size
from ..utils.profiling import annotate
from .cnf import CNFConfig, flow_forward, flow_param_shapes, flow_reverse
from .latent_ode import LatentODEConfig, dynamics_param_shapes, latent_ode_solve
from .tpointnet2 import TPointNet2Config, tpointnet2_apply, tpointnet2_param_shapes


@dataclass(frozen=True)
class CaSPRConfig:
    radii_list: Tuple[float, ...] = (0.02, 0.05, 0.1, 0.2, 0.4, 0.8)
    local_feat_size: int = 512
    latent_feat_size: int = 1600
    ode_hidden_size: int = 512
    motion_feat_size: int = 64
    pretrain_tnocs: bool = False
    augment_quad: bool = True
    augment_pairs: bool = True
    cnf_blocks: int = 1
    regress_tnocs: bool = True
    tnocs_point_size: int = 4
    sa_points: Tuple[int, ...] = (1024, 512, 256, 64, 16)
    ball_samples: Tuple[int, int] = (16, 32)
    global_feat_size: int = 1024
    space_time_pt_feat: int = 64
    cnf_dims: Tuple[int, ...] = (512, 512, 512)
    sa_impl: str = "xla"  # "xla" | "factored" | "fused": see models/pointnet2.py
    # the CNF's diffeq layer type and nonlinearity (models/cnf.py::CNFConfig);
    # the JAX package's CaSPRConfig has the defaults alone and reaches the
    # others through a CNFConfig
    cnf_layer_type: str = "concatsquash"
    cnf_nonlinearity: str = "softplus"
    # the CNF ODEnet's products, "f32" or "bf16" (CNFConfig.matmul_dtype;
    # the JAX package's CASPR_TPU_CNF_MATMUL)
    cnf_matmul_dtype: str = "f32"
    # its VJP's products, "f32" or "bf16" (with cnf_matmul_dtype "bf16";
    # CNFConfig.bwd_matmul_dtype, the JAX package's CASPR_TPU_CNF_BWD=pallas)
    cnf_bwd_matmul_dtype: str = "f32"

    def encoder_config(self) -> TPointNet2Config:
        return TPointNet2Config(
            radii_list=tuple(self.radii_list),
            local_feat_size=self.local_feat_size,
            out_feat_size=self.latent_feat_size,
            augment_quad=self.augment_quad,
            augment_pairs=self.augment_pairs,
            tnocs_point_size=self.tnocs_point_size,
            regress_tnocs=self.regress_tnocs,
            sa_points=tuple(self.sa_points),
            ball_samples=tuple(self.ball_samples),
            global_feat_size=self.global_feat_size,
            space_time_pt_feat=self.space_time_pt_feat,
            sa_impl=self.sa_impl,
        )

    def latent_ode_config(self) -> LatentODEConfig:
        return LatentODEConfig(input_size=self.motion_feat_size, hidden_size=self.ode_hidden_size)

    def cnf_config(self) -> CNFConfig:
        return CNFConfig(zdim=self.latent_feat_size, num_blocks=self.cnf_blocks,
                         dims=tuple(self.cnf_dims), layer_type=self.cnf_layer_type,
                         nonlinearity=self.cnf_nonlinearity, matmul_dtype=self.cnf_matmul_dtype,
                         bwd_matmul_dtype=self.cnf_bwd_matmul_dtype)


def caspr_param_shapes(cfg: CaSPRConfig):
    """(params, state) trees of shapes, the layout of the JAX package's
    caspr_init; ``weights.params_from_jax`` holds a checkpoint to it."""
    params = {"encoder": tpointnet2_param_shapes(cfg.encoder_config())}
    state = {}
    if not cfg.pretrain_tnocs:
        params["latent_ode"] = dynamics_param_shapes(cfg.latent_ode_config())
        params["point_cnf"], state["point_cnf"] = flow_param_shapes(cfg.cnf_config())
    return params, state


def caspr_init(generator: torch.Generator, cfg: CaSPRConfig, device=None):
    """Fresh (params, state) on ``device`` (default: the card), drawn from
    ``generator`` (on that device) with the JAX package's distributions
    (caspr_tpu/models/caspr.py::caspr_init):
      - every linear / 1x1-conv weight (out, in) and its bias: U(+-1/sqrt(in))
        (nn/core.py::linear_init, torch.nn.Linear's default);
      - the latent ODE's weights N(0, 0.1), biases 0 (latent_ode.py);
      - GroupNorm weights 1, biases 0; MovingBatchNorm weights and biases 0;
        sqrt_end_time sqrt(0.5), swish_beta 1 (cnf.py);
      - MovingBatchNorm state: mean 0, variance 1, step 0.
    The leaves are drawn in the order of ``caspr_param_shapes``; the numbers
    are not the JAX package's (another generator), their distributions are."""
    device = resolve_device(device)
    shapes, state_shapes = caspr_param_shapes(cfg)
    time_length = cfg.cnf_config().time_length

    def draw(tree, path):
        if isinstance(tree, list):
            return [draw(v, path + (str(i),)) for i, v in enumerate(tree)]
        if "weight" in tree and len(tree["weight"]) == 2:  # a linear layer
            bound = 1.0 / math.sqrt(tree["weight"][1])
            out = {}
            for name, shape in tree.items():
                if path[0] == "latent_ode":
                    out[name] = (0.1 * torch.randn(shape, generator=generator, device=device)
                                 if name == "weight" else torch.zeros(shape, device=device))
                else:
                    u = torch.rand(shape, generator=generator, device=device)
                    out[name] = (2.0 * u - 1.0) * bound
            return out
        out = {}
        for name, shape in tree.items():
            if isinstance(shape, (dict, list)):
                out[name] = draw(shape, path + (name,))
            elif name == "sqrt_end_time":
                out[name] = torch.tensor(math.sqrt(time_length), device=device)
            elif name == "swish_beta":
                out[name] = torch.ones(shape, device=device)
            elif name == "weight" and path[0] == "encoder":  # GroupNorm scale
                out[name] = torch.ones(shape, device=device)
            else:  # GroupNorm shift, MovingBatchNorm weight and bias
                out[name] = torch.zeros(shape, device=device)
        return out

    def fill_state(tree):
        if isinstance(tree, list):
            return [fill_state(v) for v in tree]
        return {k: fill_state(v) if isinstance(v, (dict, list))
                else (torch.ones if k == "running_var" else torch.zeros)(v, device=device)
                for k, v in tree.items()}

    return draw(shapes, ()), fill_state(state_shapes)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        # float32 products in full float32, as the JAX reference runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class CaSPRModel:
    """Binds a static config and a device to the inference functions."""

    def __init__(self, cfg: CaSPRConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def encode(self, params, x, point=None):
        """x: (B, T, N, 4) -> (z0 (B, H), tnocs_pred (B, T, N, 4) or None).

        ``point``: a process group over which x's points are sharded, x
        being this rank's range of them.  The clouds are gathered whole
        over it ("points"), encoded, and tnocs_pred is this rank's range.
        Its span is ``caspr::encode``."""
        with annotate("caspr::encode"):
            if point is None:
                return tpointnet2_apply(params["encoder"], self.cfg.encoder_config(), x)
            n = x.shape[2]
            z0, tnocs_pred = tpointnet2_apply(params["encoder"], self.cfg.encoder_config(),
                                              all_gather_cat(x, point, "points", dim=2))
            if tnocs_pred is not None:
                rank = group_rank_size(point)[0]
                tnocs_pred = tnocs_pred[:, :, rank * n:(rank + 1) * n]
            return z0, tnocs_pred

    def aggregate_and_solve_latent(self, params, z0, times, shared_times: bool = False, *,
                                   adjoint: bool = False, nfe_sink: Optional[NFESink] = None,
                                   ode_backward: str = "adjoint",
                                   ode_steps: int = DISCRETE_STEPS, group=None):
        """z0: (B, H), times: (B, T) -> (feats (B, T, H), nfe).

        Solves at the sorted flattened times and gathers each (b, t) slot
        back through the inverse permutation; ``shared_times=True`` says
        every row of ``times`` is the same and solves at the T times of the
        first row instead.  ``adjoint=True`` (training) solves for the
        gradient, by ``ode_backward`` (see ``latent_ode.latent_ode_solve``).

        ``group``: a process group over which the rows are sharded.  The
        solve's request times are then those of every rank's rows,
        gathered in rank order, as the one-process solve of the global
        batch takes them; with ``shared_times`` every rank must pass the
        global batch's first row.  Its span is ``caspr::latent``."""
        with annotate("caspr::latent"):
            b, t = times.shape
            motion = self.cfg.motion_feat_size
            z_dyn, z_stat = z0[:, :motion], z0[:, motion:]
            if shared_times:
                sorted_t = torch.sort(times[0], stable=True).values
                ranks = torch.argsort(torch.argsort(times[0], stable=True), stable=True)
                ranks = ranks[None, :].expand(b, t)
            else:
                rank = 0
                if group is not None:
                    rank = group_rank_size(group)[0]
                    times = all_gather_cat(times, group, "times")
                flat = times.reshape(-1)
                order = torch.argsort(flat, stable=True)
                sorted_t = flat[order]
                ranks = torch.argsort(order, stable=True).reshape(-1, t)[rank * b:(rank + 1) * b]
            # (B, T or B*T, motion)
            pred_z, nfe = latent_ode_solve(params["latent_ode"], self.cfg.latent_ode_config(),
                                           z_dyn, sorted_t, adjoint=adjoint,
                                           nfe_sink=nfe_sink, ode_backward=ode_backward,
                                           ode_steps=ode_steps, group=group)
            feats = torch.take_along_dim(pred_z, ranks[..., None], dim=1)
            z_rep = z_stat[:, None, :].expand(b, t, z_stat.shape[-1])
            return torch.cat([feats, z_rep], dim=-1), nfe

    def forward(self, params, state, x, sample_points, generator=None, *,
                training: bool = False, e=None, nfe_sink=None, ode_backward: str = "adjoint",
                ode_steps: int = DISCRETE_STEPS, groups=None):
        """Forward with unreduced losses, for evaluation or training.

        x, sample_points: (B, T, N, 4).  Returns (out, state): out has
        'tnocs_loss' (B, T, N, 4) and 'tnocs_pred' when regressing, 'nll'
        (B, T, N) unless pretraining, and 'nfe' = (latent_ode_nfe,
        cnf_nfe), forward evaluations.  The CNF's Hutchinson noise comes
        from ``generator`` or, when given, from ``e`` (see
        ``models.cnf.flow_forward``).  Evaluation returns ``state``
        unchanged.  ``training=True`` solves both ODEs for their gradient,
        so the outputs are differentiable in every parameter, and returns
        the updated MovingBatchNorm state: through the continuous adjoint,
        where ``nfe_sink``, a dict with optional "latent" and "cnf"
        ``NFESink``s, collects each solver's backward NFE when the gradient
        is taken, or with ``ode_backward="discrete"`` by autograd through at
        most ``ode_steps`` steps of each solve (the sinks get nothing).
        ``groups``: the process groups over which the batch (and with sp
        the points) is sharded, x and sample_points being this rank's rows
        and points; every reduction is then global (``parallel.mesh``) and
        the outputs are this rank's part of the one-process run's.  The
        latent code and the latent ODE's parameters, alike on every rank of
        a point group, pass the point group's ``count_once``."""
        cfg = self.cfg
        b, t, n, _ = sample_points.shape
        point = None if groups is None else groups.point
        z0, tnocs_pred = self.encode(params, x, point)
        out = {}
        if cfg.regress_tnocs:
            size = cfg.tnocs_point_size
            out["tnocs_loss"] = (tnocs_pred[..., :size] - sample_points[..., :size]).abs()
            out["tnocs_pred"] = tnocs_pred
        if cfg.pretrain_tnocs:
            out["nfe"] = (0.0, 0.0)
            return out, state
        sink = nfe_sink or {}
        z0 = count_once(z0, point)
        params = {**params, "latent_ode": count_once(params["latent_ode"], point)}
        feats, ode_nfe = self.aggregate_and_solve_latent(
            params, z0, sample_points[:, :, 0, 3], adjoint=training, nfe_sink=sink.get("latent"),
            ode_backward=ode_backward, ode_steps=ode_steps,
            group=None if groups is None else groups.batch)
        pts = sample_points[..., :3].reshape(b * t, n, 3)
        with annotate("caspr::likelihood"):
            y, dlogp, cnf_state, cnf_nfe = flow_forward(
                params["point_cnf"], state["point_cnf"], cfg.cnf_config(), pts,
                feats.reshape(b * t, cfg.latent_feat_size), pts.new_zeros((b * t, n, 1)),
                generator=generator, e=e, training=training, nfe_sink=sink.get("cnf"),
                ode_backward=ode_backward, ode_steps=ode_steps, groups=groups)
        log_py = standard_normal_logprob(y).sum(dim=-1)  # (B*T, N)
        out["nll"] = -(log_py - dlogp.reshape(b * t, n)).reshape(b, t, n)
        out["nfe"] = (ode_nfe, cnf_nfe)
        return out, ({**state, "point_cnf": cnf_state} if training else state)

    def sample_base(self, generator, batch: int, num_points: int, truncate_std=None,
                    sample_contours: Optional[Sequence[float]] = None, groups=None):
        """Base samples (batch, num_points, 3): Gaussian (optionally
        truncated), or points on spheres of the given radii.  With process
        ``groups`` the draw is the global batch's, (R_dp * batch,
        num_points, 3), and this rank keeps its rows and, with sp, its
        range of num_points / sp points."""
        if sample_contours is None:
            draw = lambda shape: sample_gaussian(generator, shape, truncate_std,
                                                 device=self.device)
        else:
            radii = list(sample_contours)

            def draw(shape):
                contours, taken = [], 0
                for i, radius in enumerate(radii):
                    cur = num_points - taken if i == len(radii) - 1 else num_points // len(radii)
                    pts = sphere_surface_points(generator, shape[0] * cur, radius,
                                                device=self.device)
                    contours.append(pts.reshape(shape[0], cur, 3))
                    taken += num_points // len(radii)
                return torch.cat(contours, dim=1)

        if groups is None:
            return draw((batch, num_points, 3))
        sp = group_rank_size(groups.point)[1]
        if num_points % sp:
            raise ValueError(f"{num_points} points not divisible by {sp} sp ranks")
        return global_draw(draw, (batch, num_points // sp, 3), groups)

    def decode_from_samples(self, params, state, z, y, groups=None, *, sample_div: bool = False,
                            generator=None, e=None):
        """Decode given base samples.  z: (B, T, H); y: (B, T, N, 3) ->
        (logp_y (B, T, N), x (B, T, N, 3), cnf_nfe).  ``sample_div=True``
        decodes as the reference does, integrating a log-density beside the
        points with a Hutchinson noise from ``generator`` or ``e`` (B*T, N,
        3) (``models.cnf.flow_reverse``).  ``groups``: the process groups over
        which the rows and points are sharded.  Its span is ``caspr::decode``
        (``decode`` draws base samples and calls it)."""
        with annotate("caspr::decode"):
            b, t, h = z.shape
            n = y.shape[2]
            y = y.reshape(b * t, n, 3)
            logp_y = standard_normal_logprob(y).sum(dim=-1)
            x, nfe = flow_reverse(params["point_cnf"], state["point_cnf"], self.cfg.cnf_config(),
                                  y, z.reshape(b * t, h), groups, sample_div=sample_div,
                                  generator=generator, e=e)
            return logp_y.reshape(b, t, n), x.reshape(b, t, n, 3), nfe

    def decode(self, params, state, z, generator, num_points: int = 1024,
               constant_in_time: bool = False, truncate_std: Optional[float] = None,
               sample_contours: Optional[Sequence[float]] = None, groups=None, *,
               sample_div: bool = False, e=None):
        """Sample points at each step from latents z (B, T, H).  Returns
        (y base samples (B, T, N, 3), logp_y (B, T, N), x (B, T, N, 3), nfe).
        ``sample_div``, ``e``: see ``decode_from_samples`` (the noise drawn
        from ``generator`` after the base samples).
        ``groups``: the process groups over which the rows and points are
        sharded (the base samples drawn for the global batch and cut,
        ``sample_base``; N is then num_points / sp)."""
        b, t, _ = z.shape
        batch = b if constant_in_time else b * t
        y = self.sample_base(generator, batch, num_points, truncate_std, sample_contours, groups)
        n = y.shape[1]
        if constant_in_time:
            y = y[:, None].expand(b, t, n, 3)
        y = y.reshape(b, t, n, 3)
        logp_y, x, nfe = self.decode_from_samples(params, state, z, y, groups,
                                                  sample_div=sample_div, generator=generator, e=e)
        return y, logp_y, x, nfe

    def reconstruct(self, params, state, x, generator, num_points: int = 1024,
                    constant_in_time: bool = False, timestamps=None,
                    max_timestamp: float = 5.0, truncate_std: Optional[float] = None,
                    sample_contours: Optional[Sequence[float]] = None, base_samples=None,
                    groups=None, *, sample_div: bool = False, e=None):
        """Encode -> advect -> decode.

        x: (B, T, N, 4) conditioning sequence; timestamps: (T',) decode
        times (default: the input times / max_timestamp).  ``base_samples``
        (B, T', num_points, 3), when given, replaces the sampled base
        points.  ``sample_div=True`` decodes as the reference does, with the
        Hutchinson noise ``e`` (B*T', num_points, 3) or, without it, drawn
        from ``generator`` (``decode_from_samples``).  ``group``: a process
        group over which the batch is sharded, x (and base_samples and e)
        being this rank's rows; every rank passes the same ``timestamps``.
        With sp (``groups.point``) x, base_samples, e and the outputs are
        this rank's range of the points, and ``num_points`` is the global
        count.  Returns (y, logp_y, x_recon, tnocs_pred, (ode_nfe, cnf_nfe))."""
        b = x.shape[0]
        z0, tnocs_pred = self.encode(params, x, None if groups is None else groups.point)
        if timestamps is None:
            all_times = x[:, :, 0, 3] / max_timestamp
        else:
            all_times = timestamps.reshape(1, -1).expand(b, timestamps.shape[-1])
        z, ode_nfe = self.aggregate_and_solve_latent(params, z0, all_times,
                                                     shared_times=timestamps is not None,
                                                     group=None if groups is None else groups.batch)
        if base_samples is None:
            y, logp_y, x_rec, cnf_nfe = self.decode(
                params, state, z, generator, num_points=num_points,
                constant_in_time=constant_in_time, truncate_std=truncate_std,
                sample_contours=sample_contours, groups=groups, sample_div=sample_div, e=e)
        else:
            y = base_samples
            logp_y, x_rec, cnf_nfe = self.decode_from_samples(
                params, state, z, y, groups, sample_div=sample_div, generator=generator, e=e)
        return y, logp_y, x_rec, tnocs_pred, (ode_nfe, cnf_nfe)
