"""Train CaSPR with the port: the counterpart of the JAX package's train.py,
with its flags and its flow.

    python -m caspr_tpu_torch.cli.train --data-cfg data/configs/demo.cfg \\
        --out ./train_out --epochs 2 --batch-size 5 --seq-len 5 --num-pts 1024

The epoch loop over the train split (shuffled, whole batches), validation
every ``--val-every`` epochs with ``BEST_time_model.pkl`` at each new best
validation loss, ``time_model_<epoch>.pkl`` every ``--save-every`` epochs,
and the loss curves (``train_curve.npz``, and ``train_curve.png`` where
matplotlib imports).  ``--weights`` resumes from a checkpoint of either
package (or a reference .pth): the parameters, the MovingBatchNorm state
and, where the checkpoint holds them, Adam's moments.  ``--ode-backward``
chooses how the gradient goes through the ODE solves; "discrete" takes at
most ``CASPR_TPU_ODE_STEPS`` (default 128) steps a solve.  The model runs
on the card; ``main(argv, device="cpu")`` runs it on the CPU.  Each
epoch's seconds per train step and the loader's wait per batch go to the
log.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from ..data import DynamicPCLDataset, SequenceLoader
from ..models import CaSPRModel, caspr_init
from ..nn import count_params
from ..train import (TestStatTracker, TrainLossTracker, log, make_eval_step, make_optimizer,
                     make_train_step, print_stats, run_one_epoch, save_checkpoint)
from ..train.checkpoint import restore_adam_state
from ..utils.config import (apply_runtime_flags, caspr_config_from_flags, get_general_options,
                            get_train_options, ode_steps_from_env, refuse_unported)
from .test import load_model_weights


def parse_args(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser = get_general_options(parser)
    parser = get_train_options(parser)
    flags, _ = parser.parse_known_args(argv)
    return flags


def train(flags, device=None):
    refuse_unported(flags)
    os.makedirs(flags.out, exist_ok=True)
    log_out = os.path.join(flags.out, "train_log.txt")
    log(log_out, flags)

    def dataset(split, random_point_sample):
        return DynamicPCLDataset(
            flags.data_cfg, split=split, train_frac=0.8, val_frac=0.1, num_pts=flags.num_pts,
            seq_len=flags.seq_len, shift_time_to_zero=(not flags.pretrain_tnocs),
            random_point_sample=random_point_sample)

    train_dataset, val_dataset = dataset("train", True), dataset("val", False)
    log(log_out, "Data loader: %s, %d train and %d val sequences" % (
        "native (native/npz_loader.cpp)" if train_dataset.use_native_loader else "numpy",
        len(train_dataset), len(val_dataset)))
    train_loader = SequenceLoader(train_dataset, batch_size=flags.batch_size, shuffle=True,
                                  drop_last=True, seed=flags.seed, num_workers=flags.num_workers)
    val_loader = SequenceLoader(val_dataset, batch_size=flags.batch_size, shuffle=False,
                                drop_last=True, seed=flags.seed, num_workers=flags.num_workers)

    apply_runtime_flags(flags)
    cfg = caspr_config_from_flags(flags)
    model = CaSPRModel(cfg, device=device)
    generator = torch.Generator(device=model.device).manual_seed(flags.seed)
    params, state = caspr_init(generator, cfg, device=model.device)
    params, state, ckpt = load_model_weights(flags, params, state, log_out)

    tx = make_optimizer(flags.lr, (flags.beta1, flags.beta2), flags.eps, flags.decay)
    opt_state = tx.init(params)
    # Adam's moments from the checkpoint where it has them (the reference
    # saves none; restarting Adam with zero moments kicks a trained model
    # off its optimum)
    if ckpt is not None and not flags.pretrain_tnocs and ckpt.get("opt_state") is not None:
        try:
            restore_adam_state(params, opt_state, ckpt["opt_state"])
            log(log_out, "Restored optimizer state from checkpoint")
        except ValueError as exc:
            log(log_out, f"Optimizer state in checkpoint incompatible ({exc}); "
                         "starting Adam fresh")

    log(log_out, "Num model params: " + str(count_params(params)))

    step_seconds = []

    def timed(step):
        def run(*args, **kwargs):
            start = time.perf_counter()
            out = step(*args, **kwargs)  # its metrics are host floats: the step has ended
            step_seconds.append(time.perf_counter() - start)
            return out
        return run

    train_step = timed(make_train_step(
        model, tx, flags.cnf_loss, flags.tnocs_loss, accum_steps=flags.grad_accum,
        ode_backward=flags.ode_backward, ode_steps=ode_steps_from_env()))
    eval_step = make_eval_step(model, flags.cnf_loss, flags.tnocs_loss)
    loss_tracker = TrainLossTracker()

    for epoch in range(flags.epochs):
        train_loader.set_epoch(epoch)
        step_seconds.clear()
        params, opt_state, state = run_one_epoch(
            train_step, params, opt_state, state, train_loader, generator, epoch, loss_tracker,
            log_out, mode="train", print_stats_every=flags.print_every)
        waits = train_loader.waits
        log(log_out, "TIMING epoch %d: %f s per train step over %d steps, loader wait %f s "
            "per batch" % (epoch, float(np.mean(step_seconds)) if step_seconds else 0.0,
                           len(step_seconds), float(np.mean(waits)) if waits else 0.0))

        if epoch % flags.val_every == 0:
            val_tracker = TestStatTracker()
            run_one_epoch(eval_step, params, None, state, val_loader, generator, epoch,
                          val_tracker, log_out, mode="val", print_stats_every=flags.print_every)
            total_loss, cnf_err, pos_err, time_err, nfe = val_tracker.get_mean_stats()
            if not math.isnan(total_loss):
                best = (len(loss_tracker.val_losses) == 0
                        or total_loss < min(loss_tracker.val_losses))
                loss_tracker.record_val_step(total_loss, epoch * len(train_loader))
                print_stats(log_out, epoch, 0, 0, total_loss, cnf_err, pos_err, time_err, "VAL",
                            nfe)
                if best:
                    log(log_out, "BEST Val loss so far! Saving checkpoint...")
                    save_checkpoint(os.path.join(flags.out, "BEST_time_model.pkl"), params,
                                    state, opt_state, epoch)
            loss_tracker.plot_cur_loss_curves(flags.out, log_out)

        if epoch % flags.save_every == 0:
            save_checkpoint(os.path.join(flags.out, "time_model_%d.pkl" % epoch), params, state,
                            opt_state, epoch)


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and train on ``device``
    (default: the card)."""
    train(parse_args(sys.argv[1:] if argv is None else argv), device=device)


if __name__ == "__main__":
    main()
