"""The evaluation step and the epoch runner (counterpart of
caspr_tpu/train/loop.py, ``mode="test"``).

Loss semantics:
  - CNF loss: weight * mean over (B, T) of the per-step NLL summed over the
    points;
  - T-NOCS loss: weight * mean of the per-point L1 over all of B, T, N, 4.
"""

from __future__ import annotations

import torch

from .trackers import print_stats


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


def make_eval_step(model, cnf_loss_weight, tnocs_loss_weight):
    """Returns eval(params, mbn_state, x, target, generator, e=None) -> metrics.

    Errors come back unreduced, and the loss also per batch item (the batch
    mean of ``loss_per_item`` is ``compute_losses``'s scalar), so that the
    caller can mask loader padding out of every statistic.  ``e`` injects
    the CNF's Hutchinson noise instead of drawing it from ``generator``.
    x and target may be numpy arrays: they go to the model's device."""

    @torch.no_grad()
    def step(params, mbn_state, x, target, generator=None, e=None):
        x = torch.as_tensor(x, device=model.device)
        target = torch.as_tensor(target, device=model.device)
        out, _ = model.forward(params, mbn_state, x, target, generator, training=False, e=e)
        loss, cnf_loss, tnocs_loss = compute_losses(out, cnf_loss_weight, tnocs_loss_weight)
        b, t, n, _ = target.shape
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


def run_one_epoch(step_fn, params, opt_state, mbn_state, loader, generator, epoch, loss_tracker,
                  log_out, mode="train", print_stats_every=10):
    """One pass over ``loader``.  With ``mode="test"`` (or any other
    evaluation name, which labels the log lines) ``step_fn`` is an eval
    step and ``loss_tracker`` a ``TestStatTracker``.  Batches are dicts of
    numpy arrays ("input", "target", optionally "valid": the number of
    real rows of a padded batch); padded rows are masked out of every
    statistic, and the mean of the per-item losses over the real rows is
    the unpadded batch loss.  Returns (params, opt_state, mbn_state)."""
    if mode == "train":
        raise NotImplementedError(
            "run_one_epoch(mode='train') belongs to the training slice, which is not ported yet")
    num_batches = len(loader)
    for i, batch in enumerate(loader):
        metrics = step_fn(params, mbn_state, batch["input"], batch["target"], generator)
        valid = batch.get("valid", len(batch["input"]))
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
