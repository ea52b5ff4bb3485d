"""Evaluate CaSPR with the port: the counterpart of the JAX package's test.py,
with its flags and its flow.

    python -m caspr_tpu_torch.cli.test --data-cfg data/configs/demo.cfg \\
        --weights artifacts/demo_trained.pkl --seq-len 10 --num-pts 2048 \\
        --eval-tnocs-regression ...

It logs the flags, builds the model from them, draws fresh weights from
``--seed`` and loads ``--weights`` (a .pkl checkpoint of either package,
or a reference .pth) over them, then runs the chosen protocols over the
test split: ``--eval-test`` (the likelihood path and its TEST line),
``--eval-shape-recon-observed`` / ``-unobserved``,
``--eval-tnocs-regression`` and ``--eval-pose-observed-ransac``.  The last
batch is padded to the batch size and masked out of every statistic.  The
model runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
Each protocol's seconds and the loader's wait per batch go to the log.

``--parallel`` evaluates data-parallel, one process per card
(``torchrun --nproc_per_node <cards> -m caspr_tpu_torch.cli.test
--parallel ...``): each rank loads and evaluates its share of every batch
(``--batch-size`` is the global batch), and rank 0 writes the log and the
artifacts, which are the one-process run's (``utils.evaluations``); rank i
> 0 logs to rank<i>_<--log>.  ``--sp-size k`` adds point parallelism, the
``(dp, sp)`` mesh (``torchrun --nproc_per_node 4 -m caspr_tpu_torch.cli.test
--parallel --sp-size 2 ...``): the k ranks of a point group load the same
rows and each decodes its range of their points.  The JAX package's
test.py --parallel is one process over the local devices instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..data import DynamicPCLDataset, SequenceLoader
from ..models import CaSPRModel, caspr_init
from ..parallel import replicate
from ..parallel.mesh import describe
from ..train import (TestStatTracker, load_checkpoint, log, make_eval_step, print_stats,
                     run_one_epoch)
from ..train.checkpoint import load_encoder_weights_from_full, load_state, load_weights
from ..utils import evaluations as eval_utils
from ..utils.config import (apply_runtime_flags, caspr_config_from_flags, check_flags,
                            get_general_options, get_test_options, parallel_setup)
from ..utils.evaluations import (test_observed_camera_pose_ransac, test_shape_recon,
                                 test_tnocs_regression)


def parse_args(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser = get_general_options(parser)
    parser = get_test_options(parser)
    flags, _ = parser.parse_known_args(argv)
    return flags


def load_model_weights(flags, params, state, log_out):
    """``--weights`` over fresh (params, state): the encoder alone under
    ``--pretrain-tnocs``, else every parameter and the MovingBatchNorm
    state.  Returns (params, state, the checkpoint or None)."""
    if flags.weights == "":
        return params, state, None
    ckpt = load_checkpoint(flags.weights)
    if flags.pretrain_tnocs:
        log(log_out, f"Loading pre-trained canonicalizer from {flags.weights}")
        params = load_encoder_weights_from_full(params, ckpt["params"])
    else:
        log(log_out, f"Loading model weights from {flags.weights}")
        params = load_weights(params, ckpt["params"])
        if ckpt.get("state"):
            state = load_state(state, ckpt["state"])
    return params, state, ckpt


def test(flags, device=None):
    protocols = (flags.eval_shape_recon_observed or flags.eval_shape_recon_unobserved
                 or flags.eval_tnocs_regression or flags.eval_pose_observed_ransac)
    check_flags(flags, eval_utils.PROTOCOL_NUM_PTS if protocols else None)
    mesh, device, rank, shards, log_name = parallel_setup(flags, device, flags.log)
    os.makedirs(flags.out, exist_ok=True)
    log_out = os.path.join(flags.out, log_name)
    log(log_out, flags)

    apply_runtime_flags(flags)
    cfg = caspr_config_from_flags(flags)
    model = CaSPRModel(cfg, device=device)
    generator = torch.Generator(device=model.device).manual_seed(flags.seed)
    params, state = caspr_init(generator, cfg, device=model.device)
    params, state, _ = load_model_weights(flags, params, state, log_out)
    if mesh is not None:
        log(log_out, f"Eval mesh over {describe(mesh)}, rank {rank}")
        replicate(mesh, (params, state))

    test_dataset = DynamicPCLDataset(
        flags.data_cfg, split="test", train_frac=0.8, val_frac=0.1, num_pts=flags.num_pts,
        seq_len=flags.seq_len, shift_time_to_zero=(not flags.pretrain_tnocs),
        random_point_sample=False)
    log(log_out, "Data loader: %s, %d test sequences" % (
        "native (native/npz_loader.cpp)" if test_dataset.use_native_loader else "numpy",
        len(test_dataset)))
    test_loader = SequenceLoader(test_dataset, batch_size=flags.batch_size,
                                 shuffle=flags.shuffle_test, seed=flags.seed,
                                 num_workers=flags.num_workers, pad_last=True, **shards)

    def timed(what, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        seconds, waits = time.perf_counter() - start, test_loader.waits
        log(log_out, "TIMING %s: %f s, loader wait %f s per batch over %d batches"
            % (what, seconds, float(np.mean(waits)) if waits else 0.0, len(waits)))
        return out

    if flags.eval_full_test:
        tracker = TestStatTracker()
        eval_step = make_eval_step(model, flags.cnf_loss, flags.tnocs_loss, mesh=mesh)
        timed("eval-test", run_one_epoch, eval_step, params, None, state, test_loader,
              generator, 0, tracker, log_out, mode="test", print_stats_every=1, mesh=mesh)
        means = tracker.get_mean_stats()
        print_stats(log_out, 0, 0, 0, means[0], means[1], means[2], means[3], "TEST", means[4])

    if flags.eval_shape_recon_observed:
        timed("eval-shape-recon-observed", test_shape_recon, model, params, state, test_loader,
              log_out, eval_utils.ALL_OBSERVED_STEPS, eval_utils.ALL_UNOBSERVED_STEPS,
              generator=generator, mesh=mesh)
    if flags.eval_shape_recon_unobserved:
        timed("eval-shape-recon-unobserved", test_shape_recon, model, params, state,
              test_loader, log_out, eval_utils.SPLIT_OBSERVED_STEPS,
              eval_utils.SPLIT_UNOBSERVED_STEPS, generator=generator, mesh=mesh)
    if flags.eval_tnocs_regression:
        timed("eval-tnocs-regression", test_tnocs_regression, model, params, state,
              test_loader, log_out, mesh=mesh)
    if flags.eval_pose_observed_ransac:
        timed("eval-pose-observed-ransac", test_observed_camera_pose_ransac, model, params,
              state, test_loader, log_out, show=flags.show_pose_viz, mesh=mesh)


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and evaluate on ``device``
    (default: the card)."""
    test(parse_args(sys.argv[1:] if argv is None else argv), device=device)


if __name__ == "__main__":
    main()
