"""The command-line option groups of the train, test and viz scripts (the
port's own copy of caspr_tpu/utils/config.py): the same option strings,
dests, defaults, types, nargs and choices, so every documented recipe
parses unchanged.  Help texts say what a flag means on the port;
``check_flags`` refuses the combinations a run cannot shard.
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
                        help="Data parallelism, one process per card: start "
                             "it with torchrun --nproc_per_node <cards>; each "
                             "rank trains on its share of every batch and the "
                             "gradients are summed over the ranks.")
    parser.set_defaults(use_parallel=False)
    parser.add_argument("--sp-size", type=int, default=1,
                        help="Point-parallel mesh axis (with --parallel): "
                             "shard each cloud's points over this many "
                             "ranks, the innermost axis of the (dp, sp) "
                             "mesh; it must divide the ranks of a node and "
                             "--num-pts.")
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
                        help="With --parallel, train over several nodes "
                             "(torchrun --nnodes): the (dcn, dp) mesh.")
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
                        help="Shard eval batches over the ranks, one process "
                             "per card started by torchrun; rank 0 writes "
                             "the logs and artifacts.")
    parser.set_defaults(use_parallel=False)
    parser.add_argument("--sp-size", type=int, default=1,
                        help="Point-parallel mesh axis for eval (with "
                             "--parallel): shard each cloud's points over "
                             "this many ranks.")
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
                        help="With --eval-pose-observed-ransac, export each "
                             "sequence's pose scene beside the log.")
    parser.set_defaults(show_pose_viz=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def get_viz_options(parser: argparse.ArgumentParser):
    parser.add_argument("--shuffle-test", dest="shuffle_test", action="store_true")
    parser.set_defaults(shuffle_test=False)
    parser.add_argument("--viz-tnocs", dest="viz_tnocs", action="store_true",
                        help="Export the T-NOCS regression scene.")
    parser.set_defaults(viz_tnocs=False)
    parser.add_argument("--viz-observed", dest="viz_observed", action="store_true",
                        help="Export the reconstruction at the observed times.")
    parser.set_defaults(viz_observed=False)
    parser.add_argument("--viz-interpolated", dest="viz_interpolated",
                        action="store_true",
                        help="Export the reconstruction at --num-sampled-steps "
                             "times from 0 to 1.")
    parser.set_defaults(viz_interpolated=False)
    parser.add_argument("--no-input-seq", dest="show_input_seq",
                        action="store_false")
    parser.set_defaults(show_input_seq=True)
    parser.add_argument("--no-nocs-cubes", dest="show_nocs_cubes",
                        action="store_false")
    parser.set_defaults(show_nocs_cubes=True)
    parser.add_argument("--tnocs-err-map", dest="tnocs_error_map",
                        action="store_true")
    parser.set_defaults(tnocs_error_map=False)
    parser.add_argument("--num-sampled-pts", type=int, default=2048)
    parser.add_argument("--num-sampled-steps", type=int, default=30)
    parser.add_argument("--no-constant", dest="constant_in_time",
                        action="store_false",
                        help="Draw fresh base samples at every time.")
    parser.set_defaults(constant_in_time=True)
    parser.add_argument("--no-base-samples", dest="show_base_sampling",
                        action="store_false")
    parser.set_defaults(show_base_sampling=True)
    parser.add_argument("--sample-contours", dest="sample_contours",
                        action="store_true",
                        help="Base samples on spheres of the Gaussian's "
                             "contour radii, coloured by contour.")
    parser.set_defaults(sample_contours=False)
    parser.add_argument("--base-color-map", dest="base_color_map",
                        action="store_true")
    parser.set_defaults(base_color_map=False)
    parser.add_argument("--prob-color-map", dest="prob_color_map",
                        action="store_true")
    parser.set_defaults(prob_color_map=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def apply_runtime_flags(flags):
    """The port's float32 products: TF32 off for matmuls and cuDNN,
    whatever ``--matmul-precision`` says.  Writes no environment variable."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_flags(flags, protocol_points=None):
    """Refuse, with a ValueError naming the flag, what a run cannot shard,
    before any process group is formed: --multihost or --sp-size other
    than 1 without --parallel, and with it a node's rank count (torchrun's
    LOCAL_WORLD_SIZE, else the world's) that --sp-size does not divide, a
    --batch-size that the dp ranks do not divide, and a point count,
    --num-pts or the evaluation protocol's ``protocol_points``, that
    --sp-size does not divide."""
    import torch.distributed as dist

    sp = getattr(flags, "sp_size", 1)
    parallel = getattr(flags, "use_parallel", False)
    if getattr(flags, "multihost", False) and not parallel:
        # sharded loaders without the gradient sum would train divergent
        # models: refuse early, as the JAX package's train.py does
        raise ValueError("--multihost requires --parallel")
    if sp != 1 and not parallel:
        raise ValueError(f"--sp-size {sp} requires --parallel")
    if not parallel:
        return
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if sp < 1 or node % sp:
        raise ValueError(f"--sp-size {sp} does not divide the {node} ranks of a node")
    if flags.batch_size % (world // sp):
        raise ValueError(f"--batch-size {flags.batch_size} is not divisible by the "
                         f"{world // sp} dp ranks ({world} ranks / --sp-size {sp})")
    for name, n in (("--num-pts", flags.num_pts), ("the protocol's points", protocol_points)):
        if n is not None and n % sp:
            raise ValueError(f"{name} {n} is not divisible by --sp-size {sp}")


def parallel_setup(flags, device, log_name: str):
    """--parallel: join the process group (``parallel.init_distributed``,
    one process per card, the card of index LOCAL_RANK unless ``device``
    names one) and make the mesh, ``(dp,)`` or ``(dp, sp)`` by --sp-size;
    the train CLI over several nodes needs --multihost.  Returns (mesh or
    None, the device, this rank, the loader's shards over the batch group
    ({"num_shards": dp ranks, "shard_index": this rank's index}), the log
    file's name: ``log_name`` on rank 0, else ``rank<i>_<log_name>``)."""
    if not flags.use_parallel:
        return None, device, 0, {}, log_name
    import torch.distributed as dist

    from ..parallel import DCN_AXIS, batch_group, init_distributed, make_mesh

    device = init_distributed(device=device)
    mesh = make_mesh(sp_size=flags.sp_size)
    if DCN_AXIS in mesh.mesh_dim_names and not getattr(flags, "multihost", True):
        raise ValueError(f"--parallel over {mesh.mesh.shape[0]} nodes needs --multihost")
    rank = dist.get_rank()
    group = batch_group(mesh)
    shards = {"num_shards": dist.get_world_size(group), "shard_index": dist.get_rank(group)}
    return mesh, device, rank, shards, log_name if rank == 0 else f"rank{rank}_{log_name}"


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
