"""The optimizer, the train and evaluation steps and the epoch runner
(counterpart of caspr_tpu/train/loop.py).

Loss semantics:
  - CNF loss: weight * mean over (B, T) of the per-step NLL summed over the
    points;
  - T-NOCS loss: weight * mean of the per-point L1 over all of B, T, N, 4.
Adam is torch.optim.Adam over the leaves of the parameter tree, whose L2
weight decay (added to the gradient before the moments) and bias
correction are those of the JAX package's optax chain.  Parameters are
updated in place.

Data and point parallelism (``mesh=``, a ``parallel.make_mesh`` mesh):
each rank (process) holds its equal share of every global batch, its rows
over the dp axes and, with sp, its range of their points.  Its loss is
its share of the global-batch loss, so that the sum over every rank is
the one-process loss: the CNF part is a mean over rows of sums over
points, its rows' mean of its points' sums over R_dp; the T-NOCS part a
mean over every point, its points' mean over R_dp x sp.  The model makes
its reductions global (``CaSPRModel.forward(groups=)``), and the gradient
is summed over every rank in one flat buffer before the optimizer's step,
the counterpart of the psum XLA inserts.  No DistributedDataParallel
wrapper: the parameters are a tensor tree, and what is alike on several
ranks arrives counted once already (the adjoint's replicated leaves on
rank 0 alone, ``ops.odeint.odeint_adjoint``; what a point group holds
alike from its rank 0, ``parallel.mesh.count_once``).  Every rank then
takes the same step, and its parameters stay bit-equal to the others'.
The logged scalars are the global values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.odeint import DISCRETE_STEPS, ODE_BACKWARDS, NFESink, flatten_tree, nfe_add, nfe_sum
from ..parallel.mesh import (all_gather_cat, all_reduce_sum, all_reduce_sum_leaves,
                             group_rank_size, mesh_groups, shard_points)
from ..utils.profiling import annotate
from .trackers import log, print_stats


@dataclass(frozen=True)
class Adam:
    """Adam's hyper-parameters (torch.optim.Adam, reference caspr/train.py:
    135-136); ``init(params)`` makes the optimizer over a parameter tree,
    the port's optimizer state."""

    lr: float
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(flatten_tree(params)[0], lr=self.lr, betas=tuple(self.betas),
                                eps=self.eps, weight_decay=self.weight_decay)


def make_optimizer(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0) -> Adam:
    """The counterpart of the JAX package's ``make_optimizer``: use
    ``.init(params)`` for the optimizer state."""
    return Adam(lr, tuple(betas), eps, weight_decay)


def compute_losses(out, cnf_loss_weight, tnocs_loss_weight):
    """(weighted scalar loss, CNF part, T-NOCS part) from the model's
    unreduced output; a part whose key is absent is 0."""
    ref = next(v for v in out.values() if isinstance(v, torch.Tensor))
    cnf_loss = tnocs_loss = ref.new_zeros(())
    if "nll" in out:
        cnf_loss = cnf_loss_weight * out["nll"].sum(dim=2).mean()
    if "tnocs_loss" in out:
        tnocs_loss = tnocs_loss_weight * out["tnocs_loss"][..., :4].mean()
    return cnf_loss + tnocs_loss, cnf_loss, tnocs_loss


def make_eval_step(model, cnf_loss_weight, tnocs_loss_weight, mesh=None):
    """Returns eval(params, mbn_state, x, target, generator, e=None) -> metrics.

    Errors come back unreduced, and the loss also per batch item (the batch
    mean of ``loss_per_item`` is ``compute_losses``'s scalar), so that the
    caller can mask loader padding out of every statistic.  ``e`` injects
    the CNF's Hutchinson noise instead of drawing it from ``generator``.
    x and target may be numpy arrays: they go to the model's device.  With
    a ``mesh`` x, target and e are this rank's rows and points; the
    unreduced errors are its rows, their points gathered over the point
    group (``run_one_epoch`` gathers the rows); the scalar losses are the
    global batch's."""
    groups = mesh_groups(mesh)

    @torch.no_grad()
    def step(params, mbn_state, x, target, generator=None, e=None):
        x = torch.as_tensor(x, device=model.device)
        target = torch.as_tensor(target, device=model.device)
        out, _ = model.forward(params, mbn_state, x, target, generator, training=False, e=e,
                               groups=groups)
        b, t, n, _ = target.shape
        if groups is not None and groups.point is not None:  # every point of the rank's rows
            out = {**out, **{k: all_gather_cat(out[k], groups.point, "eval", dim=2)
                             for k in ("nll", "tnocs_loss") if k in out}}
            n *= group_rank_size(groups.point)[1]
        loss, cnf_loss, tnocs_loss = compute_losses(out, cnf_loss_weight, tnocs_loss_weight)
        if groups is not None:
            shares = torch.stack([loss, cnf_loss, tnocs_loss]) / group_rank_size(groups.batch)[1]
            loss, cnf_loss, tnocs_loss = all_reduce_sum(shares, groups.batch, "metrics")
        nll = out["nll"] if "nll" in out else target.new_zeros((b, t, n))
        tn = out["tnocs_loss"] if "tnocs_loss" in out else target.new_zeros((b, t, n, 4))
        cnf_per_item = cnf_loss_weight * nll.sum(dim=2).mean(dim=1)
        tnocs_per_item = tnocs_loss_weight * tn.mean(dim=(1, 2, 3))
        return {
            "loss": loss,
            "cnf_loss": cnf_loss,
            "tnocs_loss": tnocs_loss,
            "loss_per_item": cnf_per_item + tnocs_per_item,  # (B,)
            "nll": nll,
            "tnocs_pos_err": torch.linalg.vector_norm(tn[..., :3], dim=-1),  # (B, T, N)
            "tnocs_time_err": tn[..., 3],  # (B, T, N)
            "nfe": (float(out["nfe"][0]), float(out["nfe"][1])),
        }

    return step


def _split_noise(e, parts: int, i: int):
    """Microbatch i's rows of an injected noise (a tensor or one per CNF
    block), or None."""
    if e is None:
        return None
    if isinstance(e, torch.Tensor):
        return e.chunk(parts)[i]
    return [t.chunk(parts)[i] for t in e]


def _host_float(value) -> float:
    """One scalar read to the host (a synchronisation), as a span."""
    with annotate("caspr::host_read"):
        return value.item()


def make_train_step(model, tx, cnf_loss_weight, tnocs_loss_weight, accum_steps: int = 1,
                    ode_backward: str = "adjoint", ode_steps: int = DISCRETE_STEPS, mesh=None):
    """Returns step(params, opt_state, mbn_state, x, target, generator=None,
    e=None) -> (params, opt_state, new_mbn_state, metrics), the counterpart
    of the JAX package's train step: CaSPRModel.forward(training=True), the
    weighted losses, their gradient (through the two ODE solves), and
    one update of ``params`` in place by ``opt_state``, a torch optimizer
    over the leaves of ``params`` (``tx.init(params)`` for Adam).  ``tx``
    itself is not read -- the optimizer carries its hyper-parameters -- and
    stays for the JAX package's signature.

    ``ode_backward`` says how the gradient goes through the solves:
    "adjoint", the continuous adjoint, or "discrete", autograd through at
    most ``ode_steps`` steps of each solve (``odeint_discrete``).

    metrics (host floats): loss, cnf_loss, tnocs_loss, mean_nll, nfe (per
    solver, forward + adjoint evaluations, as the reference logs them
    after loss.backward(); forward-only with "discrete"), nfe_forward, and
    with T-NOCS regression tnocs_pos_err, tnocs_time_err.
    ``accum_steps > 1`` splits the batch into that many equal microbatches,
    averages their gradients, threads the MovingBatchNorm state through
    them (each microbatch normalises with the statistics its predecessor
    left) and makes one update; losses are the
    microbatch means, NFE their sums.  The CNF's Hutchinson noise comes from
    ``generator``, or from ``e`` (the whole batch's, split with it).  x and
    target may be numpy arrays: they go to the model's device.

    With a ``mesh`` (module docstring) x, target and e are this rank's
    rows and points (``parallel.shard_batch_points``; e's points on its
    axis 1).  With ``accum_steps > 1`` they must be this rank's rows of each
    global microbatch in turn, as ``SequenceLoader(microbatches=)`` gives
    them, so that microbatch i is the one-process step's microbatch i.  The
    NFE must agree on every rank (a RuntimeError otherwise).

    Spans (``utils.profiling.annotate``): a call is ``caspr::train_step``;
    each microbatch's model forward and losses ``caspr::train_step.forward``
    and their gradient ``caspr::train_step.backward``; the optimizer's step
    ``caspr::train_step.update``; each logged scalar's read
    ``caspr::host_read``."""
    del tx
    if ode_backward not in ODE_BACKWARDS:
        raise ValueError(f"ode_backward {ode_backward!r}, expected one of {ODE_BACKWARDS}")
    groups = mesh_groups(mesh)
    # the parts of the global batch's rows and of every point a rank holds
    rows = 1 if groups is None else group_rank_size(groups.batch)[1]
    parts = rows * (1 if groups is None else group_rank_size(groups.point)[1])

    def grads_of(params, leaves, mbn_state, x, target, generator, e):
        sinks = {"latent": NFESink(), "cnf": NFESink()}
        with torch.enable_grad():
            with annotate("caspr::train_step.forward"):
                out, new_state = model.forward(params, mbn_state, x, target, generator,
                                               training=True, e=e, nfe_sink=sinks,
                                               ode_backward=ode_backward, ode_steps=ode_steps,
                                               groups=groups)
                _, cnf_loss, tnocs_loss = compute_losses(out, cnf_loss_weight, tnocs_loss_weight)
                # this rank's share of the global-batch loss (module docstring)
                cnf_loss, tnocs_loss = cnf_loss / rows, tnocs_loss / parts
                loss = cnf_loss + tnocs_loss
            with annotate("caspr::train_step.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        scalars = {"loss": _host_float(loss), "cnf_loss": _host_float(cnf_loss),
                   "tnocs_loss": _host_float(tnocs_loss),
                   "mean_nll": _host_float(out["nll"].mean()) / parts if "nll" in out else 0.0,
                   "nfe_forward": tuple(float(v) for v in out["nfe"]),
                   "nfe_backward": (sinks["latent"].value, sinks["cnf"].value)}
        if "tnocs_loss" in out:
            per_point = out["tnocs_loss"].detach()
            pos_err = torch.linalg.vector_norm(per_point[..., :3], dim=-1).mean()
            scalars["tnocs_pos_err"] = _host_float(pos_err) / parts
            scalars["tnocs_time_err"] = _host_float(per_point[..., 3].mean()) / parts
        return grads, new_state, scalars

    def step(params, opt_state, mbn_state, x, target, generator=None, e=None):
        with annotate("caspr::train_step"):
            return one_step(params, opt_state, mbn_state, x, target, generator, e)

    def one_step(params, opt_state, mbn_state, x, target, generator, e):
        x = torch.as_tensor(x, device=model.device)
        target = torch.as_tensor(target, device=model.device)
        leaves, _ = flatten_tree(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum_steps {accum_steps}")
        grads, parts = None, []
        for i, (xi, ti) in enumerate(zip(x.chunk(accum_steps), target.chunk(accum_steps))):
            g_i, mbn_state, m_i = grads_of(params, leaves, mbn_state, xi, ti, generator,
                                           _split_noise(e, accum_steps, i))
            grads = g_i if grads is None else [a + b for a, b in zip(grads, g_i)]
            parts.append(m_i)
        if accum_steps > 1:
            grads = [g / accum_steps for g in grads]
        m = {k: float(np.mean([p[k] for p in parts])) for k in parts[0] if not k.startswith("nfe")}
        nfe_fwd = tuple(nfe_sum([p["nfe_forward"][j] for p in parts]) for j in range(2))
        nfe_bwd = tuple(nfe_sum([p["nfe_backward"][j] for p in parts]) for j in range(2))
        if groups is not None:
            grads = all_reduce_sum_leaves(grads, groups.whole, "grad")
            m = _global_scalars(m, nfe_fwd + nfe_bwd, groups.whole, model.device)
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        with annotate("caspr::train_step.update"):
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
        metrics = {k: m[k] for k in ("loss", "cnf_loss", "tnocs_loss", "mean_nll")}
        metrics["nfe"] = tuple(nfe_add(f, b) for f, b in zip(nfe_fwd, nfe_bwd))
        metrics["nfe_forward"] = tuple(nfe_fwd)
        for k in ("tnocs_pos_err", "tnocs_time_err"):
            if k in m:
                metrics[k] = m[k]
        return params, opt_state, mbn_state, metrics

    return step


def _global_scalars(m, nfe, group, device):
    """The ranks' shares of the logged scalars summed in rank order (one
    all-gather with the NFE counts), after checking that every rank counted
    the same NFE."""
    keys = sorted(m)
    rows = all_gather_cat(torch.tensor([[m[k] for k in keys] + list(nfe)], dtype=torch.float64,
                                        device=device), group, "metrics")
    with annotate("caspr::host_read"):
        rows = rows.cpu().numpy()
    if not (rows[:, len(keys):] == rows[0, len(keys):]).all():
        raise RuntimeError(f"the ranks counted different NFE (forward, backward): "
                           f"{rows[:, len(keys):].tolist()}")
    return {k: float(rows[:, i].sum()) for i, k in enumerate(keys)}


def _gather_eval_rows(metrics, group):
    """The per-row outputs of an eval step of every rank, in global row
    order (one all-gather)."""
    keys = ("loss_per_item", "nll", "tnocs_pos_err", "tnocs_time_err")
    b = metrics["loss_per_item"].shape[0]
    flat = all_gather_cat(torch.cat([metrics[k].reshape(b, -1) for k in keys], dim=1), group,
                           "eval")
    out, at = {}, 0
    for k in keys:
        width = metrics[k][0].numel()
        out[k] = flat[:, at:at + width].reshape(-1, *metrics[k].shape[1:])
        at += width
    return out


def run_one_epoch(step_fn, params, opt_state, mbn_state, loader, generator, epoch, loss_tracker,
                  log_out, mode="train", print_stats_every=10, mesh=None):
    """One pass over ``loader``; batches are dicts of numpy arrays
    ("input", "target", optionally "valid": the number of real rows of a
    padded batch).  Returns (params, opt_state, mbn_state).

    ``mode="train"``: ``step_fn`` is a train step and ``loss_tracker`` a
    ``TrainLossTracker``; every ``print_stats_every`` batches the mean loss
    since the last report is recorded and logged with the NFE (forward +
    adjoint), with a warning when an NFE count carries the +0.5 marker of an
    exhausted step bound.  Any other mode (which labels the log lines):
    ``step_fn`` is an eval step and ``loss_tracker`` a ``TestStatTracker``;
    padded rows are masked out of every statistic, and the mean of the
    per-item losses over the real rows is the unpadded batch loss.

    ``mesh``: the steps were made with it, and the loader gives this rank's
    rows (``SequenceLoader(num_shards=, shard_index=)`` over the batch
    group), of which the step takes the rank's points
    (``parallel.shard_points``).  An eval step's rows are gathered from
    every rank of the batch group in global row order and the padding
    masked by the batch's "valid_global", so that every rank's tracker
    holds the one-process run's statistics."""
    group = None if mesh is None else mesh_groups(mesh).batch

    def inputs(batch):
        xy = (batch["input"], batch["target"])
        return xy if mesh is None else shard_points(mesh, xy)

    num_batches = len(loader)
    if mode == "train":
        batch_losses = []
        for i, batch in enumerate(loader):
            params, opt_state, mbn_state, metrics = step_fn(
                params, opt_state, mbn_state, *inputs(batch), generator)
            batch_losses.append(metrics["loss"])
            if i % print_stats_every == 0:
                loss_tracker.record_train_step(float(np.mean(batch_losses)), metrics["cnf_loss"],
                                               metrics["tnocs_loss"], epoch * num_batches + i)
                nfe = np.asarray(metrics["nfe"])
                if (nfe % 1.0 != 0.0).any():
                    log(log_out, "WARNING: a discrete-mode ODE solve hit its attempted-step "
                                 "bound this step; outputs past the bound hold the final "
                                 "integrator state. Raise CASPR_TPU_ODE_STEPS.")
                print_stats(log_out, epoch, i, num_batches, float(np.mean(batch_losses)),
                            metrics.get("mean_nll", 0.0), metrics.get("tnocs_pos_err", 0.0),
                            metrics.get("tnocs_time_err", 0.0), "TRAIN", nfe)
                batch_losses = []
        return params, opt_state, mbn_state
    for i, batch in enumerate(loader):
        metrics = step_fn(params, mbn_state, *inputs(batch), generator)
        if group is None:
            valid = batch.get("valid", len(batch["input"]))
        else:
            metrics = {**metrics, **_gather_eval_rows(metrics, group)}
            # "valid" is the global count where the loader has one shard
            valid = batch.get("valid_global", batch.get("valid", len(metrics["loss_per_item"])))
        host = {k: metrics[k][:valid].cpu().numpy()
                for k in ("loss_per_item", "nll", "tnocs_pos_err", "tnocs_time_err")}
        loss_tracker.record_stats(
            float(host["loss_per_item"].mean()), host["nll"],
            host["tnocs_pos_err"].reshape(-1), host["tnocs_time_err"].reshape(-1),
            metrics["nfe"])
        if i % print_stats_every == 0:
            means = loss_tracker.get_mean_stats()
            print_stats(log_out, epoch, i, num_batches, means[0], means[1], means[2], means[3],
                        mode.upper(), means[4])
    return params, opt_state, mbn_state
