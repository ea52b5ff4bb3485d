"""The command-line option groups of the train and test scripts (the port's
own copy of caspr_tpu/utils/config.py): the same option strings, dests,
defaults, types, nargs and choices, so every documented recipe parses
unchanged.  Help texts say what a flag means on the port; the flags whose
slices are not ported yet parse and are refused by ``refuse_unported``.
The viz options wait for the viz script.
"""

from __future__ import annotations

import argparse
import os

def get_general_options(parser: argparse.ArgumentParser):
    parser.add_argument("--num-workers", type=int, default=2, help="for data loaders")
    parser.add_argument("--out", type=str, default="./train_out",
                        help="Directory to save model weights and logs to.")
    parser.add_argument("--data-cfg", type=str, required=True,
                        help=".cfg for the dataset to use")
    parser.add_argument("--batch-size", type=int, default=5)
    parser.add_argument("--seq-len", type=int, default=5,
                        help="Number of time steps to sample in each sequence.")
    parser.add_argument("--num-pts", type=int, default=1024,
                        help="Points to sample per step.")
    parser.add_argument("--no-augment-quad", dest="augment_quad",
                        action="store_false")
    parser.set_defaults(augment_quad=True)
    parser.add_argument("--no-augment-pairs", dest="augment_pairs",
                        action="store_false")
    parser.set_defaults(augment_pairs=True)
    parser.add_argument("--pretrain-tnocs", dest="pretrain_tnocs",
                        action="store_true")
    parser.set_defaults(pretrain_tnocs=False)
    parser.add_argument("--weights", type=str, default="",
                        help="Path to model weights (.pkl checkpoint or "
                             "reference .pth to convert on the fly).")
    parser.add_argument("--radii", type=float, nargs="+",
                        default=[0.02, 0.05, 0.1, 0.2, 0.4, 0.8])
    parser.add_argument("--local-feat-size", type=int, default=512)
    parser.add_argument("--cnf-blocks", type=int, default=1)
    parser.add_argument("--latent-feat-size", type=int, default=1600)
    parser.add_argument("--ode-hidden-size", type=int, default=512)
    parser.add_argument("--motion-feat-size", type=int, default=64)
    parser.add_argument("--no-regress-tnocs", dest="regress_tnocs",
                        action="store_false")
    parser.set_defaults(regress_tnocs=True)
    parser.add_argument("--cnf-loss", type=float, default=0.01,
                        help="Weight for NLL loss")
    parser.add_argument("--tnocs-loss", type=float, default=100.0,
                        help="Weight for TNOCS regression loss")
    parser.add_argument("--matmul-precision", type=str, default="default",
                        choices=["default", "high", "highest"],
                        help="Accepted for the JAX package's flag surface: "
                             "the port computes in float32 with TF32 off "
                             "at every choice.")
    return parser


def get_train_options(parser: argparse.ArgumentParser):
    parser.add_argument("--parallel", dest="use_parallel", action="store_true",
                        help="Data parallelism over the local devices "
                             "(not ported yet: raises).")
    parser.set_defaults(use_parallel=False)
    parser.add_argument("--sp-size", type=int, default=1,
                        help="Point-parallel mesh axis: shard each cloud's "
                             "points over this many devices (not ported "
                             "yet: any value but 1 raises).")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--val-every", type=int, default=3)
    parser.add_argument("--save-every", type=int, default=10)
    parser.add_argument("--print-every", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--beta1", type=float, default=0.9)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--eps", type=float, default=1e-8)
    parser.add_argument("--decay", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the weights' initialisation, the data "
                             "order and subsampling, and the model's noise.")
    parser.add_argument("--multihost", dest="multihost", action="store_true",
                        help="Multi-process training (not ported yet: "
                             "raises).")
    parser.set_defaults(multihost=False)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="Gradient-accumulation microbatches per "
                             "optimizer step (batch must divide evenly). "
                             "Cuts peak activation memory ~N-fold for the "
                             "same effective batch.")
    parser.add_argument("--ode-backward", type=str, default="adjoint",
                        choices=["adjoint", "discrete"],
                        help="Training gradients through the ODE solves: "
                             "'adjoint' = continuous adjoint (reference "
                             "parity, O(1) memory); 'discrete' = autograd "
                             "through the solver (exact discrete gradients; "
                             "at most CASPR_TPU_ODE_STEPS steps a solve, "
                             "default 128).")
    return parser


def get_test_options(parser: argparse.ArgumentParser):
    parser.add_argument("--log", type=str, default="test_log.txt")
    parser.add_argument("--parallel", dest="use_parallel", action="store_true",
                        help="Shard eval batches across the local devices "
                             "(not ported yet: raises).")
    parser.set_defaults(use_parallel=False)
    parser.add_argument("--sp-size", type=int, default=1,
                        help="Point-parallel mesh axis for eval (not ported "
                             "yet: any value but 1 raises).")
    parser.add_argument("--shuffle-test", dest="shuffle_test", action="store_true")
    parser.set_defaults(shuffle_test=False)
    parser.add_argument("--eval-test", dest="eval_full_test", action="store_true")
    parser.set_defaults(eval_full_test=False)
    parser.add_argument("--eval-shape-recon-observed",
                        dest="eval_shape_recon_observed", action="store_true")
    parser.set_defaults(eval_shape_recon_observed=False)
    parser.add_argument("--eval-shape-recon-unobserved",
                        dest="eval_shape_recon_unobserved", action="store_true")
    parser.set_defaults(eval_shape_recon_unobserved=False)
    parser.add_argument("--eval-tnocs-regression", dest="eval_tnocs_regression",
                        action="store_true")
    parser.set_defaults(eval_tnocs_regression=False)
    parser.add_argument("--eval-pose-observed-ransac",
                        dest="eval_pose_observed_ransac", action="store_true")
    parser.set_defaults(eval_pose_observed_ransac=False)
    parser.add_argument("--show-pose-viz", dest="show_pose_viz",
                        action="store_true",
                        help="Export pose scenes (not ported yet: raises).")
    parser.set_defaults(show_pose_viz=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def apply_runtime_flags(flags):
    """The port's float32 products: TF32 off for matmuls and cuDNN,
    whatever ``--matmul-precision`` says.  Writes no environment variable."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def refuse_unported(flags):
    """Raise NotImplementedError for a flag whose slice is not ported yet."""
    wanted = []
    if getattr(flags, "use_parallel", False):
        wanted.append("--parallel")
    if getattr(flags, "multihost", False):
        wanted.append("--multihost")
    if getattr(flags, "sp_size", 1) != 1:
        wanted.append(f"--sp-size {flags.sp_size}")
    if wanted:
        raise NotImplementedError(
            f"{', '.join(wanted)}: multi-device runs are not ported yet "
            "(ROADMAP Queue 1 item 10.6)")
    if getattr(flags, "show_pose_viz", False):
        raise NotImplementedError(
            "--show-pose-viz: the pose-scene export is not ported yet "
            "(ROADMAP Queue 1 item 10.5)")


def ode_steps_from_env() -> int:
    """The step bound of ``--ode-backward discrete``: CASPR_TPU_ODE_STEPS,
    as the JAX package documents it, else 128; at least 1."""
    from ..ops.odeint import DISCRETE_STEPS

    try:
        steps = int(os.environ.get("CASPR_TPU_ODE_STEPS", str(DISCRETE_STEPS)))
    except ValueError:
        steps = DISCRETE_STEPS
    return max(steps, 1)


def caspr_config_from_flags(flags):
    """Build a CaSPRConfig from parsed CLI flags."""
    from ..models import CaSPRConfig

    return CaSPRConfig(
        radii_list=tuple(flags.radii),
        local_feat_size=flags.local_feat_size,
        latent_feat_size=flags.latent_feat_size,
        ode_hidden_size=flags.ode_hidden_size,
        motion_feat_size=flags.motion_feat_size,
        pretrain_tnocs=flags.pretrain_tnocs,
        augment_quad=flags.augment_quad,
        augment_pairs=flags.augment_pairs,
        cnf_blocks=flags.cnf_blocks,
        regress_tnocs=flags.regress_tnocs,
    )
