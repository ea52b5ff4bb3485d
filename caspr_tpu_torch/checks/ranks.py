"""Data- and point-parallel runs of the port in processes of their own, one
per rank, for the tests and chip_smoke.py phases 10 and 11.

    results = run_ranks(world, payload, work_dir, timeout=...)

pickles ``payload`` (plain data and numpy arrays) into ``work_dir``, starts
``python -m caspr_tpu_torch.checks.ranks <rank> <world> <work_dir>`` once per
rank -- each a fresh interpreter, so a rank imports the port alone -- and
returns each rank's result in rank order.  The ranks meet through a
``torch.distributed.FileStore`` in ``work_dir`` (no network port), with
``payload["timeout"]`` seconds for each collective; ``run_ranks`` waits at
most ``timeout`` seconds for them all, then kills them and raises, so a hang
fails the caller instead of holding it.  Each rank's output goes to
``work_dir/rank<i>.log``.

``payload["job"]`` is one of:

  "steps"  one train step per entry of ``payload["cases"]``, each from the
           payload's weights, on this rank's rows and points of a global
           batch (``parallel.shard_batch_points``, by the case's
           accum_steps; the noise's points on its axis 1): returns
           per case the metrics, the gradient the optimizer was handed (the
           sum over ranks), the parameters and MovingBatchNorm state after
           the step, the collectives and the kernel launches of the step;
  "evals"  ``test_shape_recon`` and ``test_tnocs_regression`` over the
           rank's shard of a dataset's test split (sharded over the batch
           group), rank 0 writing the logs,
           then with "pose_out" ``test_observed_camera_pose_ransac`` with
           its scenes there (rank i > 0 logging to rank<i>_pose_log.txt, as
           the test command line names a rank's log); "no_matplotlib" runs
           the scene export as on a host without matplotlib;
  "cli"    the train or test command line's ``main`` with its argv (which
           holds --parallel): the process group is formed before, and the
           command line keeps it;
  "reconstruct"  ``CaSPRModel.reconstruct`` of ``payload["x"]`` at the
           decode ``payload["timestamps"]`` from ``payload["base"]`` (the
           global batch's base samples), on this rank's rows and points,
           once to warm up and once timed (with "sample_div" the
           reference-parity decode, its noise ``payload["e"]``, the global
           (B T', N, 3), cut as the base samples): returns the rank's
           decoded points, the NFE, the seconds, the launches and
           collectives;
  "mesh"   for each (num_slices, sp_size) of ``payload["meshes"]`` the
           mesh's axes and shape and the ranks of this rank's batch, point
           and whole groups; ``shard_batch_points`` of ``payload["array"]``
           on the first mesh; and the loader shards the command lines'
           ``parallel_setup`` gives for ``payload["sp_size"]``;
  "parts"  each payload of ``payload["parts"]`` in turn, in one group.

``run_torchrun`` runs the "cli" job under torchrun instead, where the
command line forms the process group itself.

Common keys: "world", "backend" ("gloo" or "nccl"), "device" (every rank's,
e.g. "cpu" or "cuda:0": ranks may share a card over gloo; "cuda": the card
of index LOCAL_RANK), "threads" (CPU threads a rank, default 1: ranks share
the host's cores), "config" (CaSPRConfig fields), "num_slices" (the mesh's
nodes, default 1), "sp_size" (the mesh's sp axis, default 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def run_ranks(world: int, payload: dict, work_dir: str, timeout: float = 300.0) -> list:
    """Run ``payload`` on ``world`` ranks; their results in rank order."""
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "payload.pkl"), "wb") as f:
        pickle.dump(dict(payload, world=world), f)
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(os.path.join(work_dir, f"rank{rank}.log"), "w"))
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world // payload.get("num_slices", 1)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "caspr_tpu_torch.checks.ranks", str(rank), str(world), work_dir],
            cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for f in logs:
            f.close()

    def tails():
        return "\n".join(f"--- rank {r}:\n" + Path(work_dir, f"rank{r}.log").read_text()[-3000:]
                         for r in range(world))

    if hung:
        raise RuntimeError(f"{len(hung)} of {world} ranks did not end in {timeout} s\n{tails()}")
    if any(p.returncode for p in procs):
        raise RuntimeError(f"ranks exited {[p.returncode for p in procs]}\n{tails()}")
    out = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


class RecordingOptimizer:
    """Hands the step to ``inner`` after keeping the gradients it was given."""

    def __init__(self, inner, leaves):
        self.inner, self.leaves, self.grads = inner, leaves, None

    def step(self):
        self.grads = [p.grad.detach().cpu().numpy().copy() for p in self.leaves]
        self.inner.step()

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)


def _model(payload, device):
    from ..models.caspr import CaSPRConfig, CaSPRModel

    cfg = CaSPRConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in payload.get("config", {}).items()})
    return cfg, CaSPRModel(cfg, device=device)


def _weights(payload, cfg, device):
    from ..weights import load_demo, params_from_jax

    if payload["weights"] == "demo":
        return load_demo(cfg, device=device)
    return params_from_jax(payload["weights"]["params"], payload["weights"]["state"], cfg,
                           device=device)


def _numpy(tree):
    from ..train.checkpoint import _flatten

    return {k: v.detach().cpu().numpy().copy() for k, v in _flatten(tree).items()}


def steps_job(payload, rank, world, mesh, device):
    import numpy as np
    import torch

    from ..ops import kernels
    from ..ops.odeint import flatten_tree
    from ..parallel import collectives, reset_collectives, shard_batch_points
    from ..parallel.mesh import describe
    from ..train import make_train_step
    from ..train.checkpoint import _flatten

    cfg, model = _model(payload, device)
    out = []
    for case in payload["cases"]:
        accum = case.get("accum_steps", 1)
        params, state = _weights(payload, cfg, device)
        leaves = flatten_tree(params)[0]
        if case.get("optimizer", "sgd1") == "sgd1":  # params - grads: the gradient itself
            inner = torch.optim.SGD(leaves, lr=1.0)
        else:
            inner = torch.optim.Adam(leaves, lr=case["lr"])
        opt = RecordingOptimizer(inner, leaves)
        x, target = shard_batch_points(mesh, (case["x"], case["target"]), accum)
        e = case.get("e")
        if e is not None:  # (B T, N, 3): cut as (B, T, N, 3)
            e = shard_batch_points(mesh, e.reshape(*case["x"].shape[:2], *e.shape[1:]), accum)
            e = torch.from_numpy(np.ascontiguousarray(e.reshape(-1, *e.shape[2:]))).to(device)
        step = make_train_step(model, None, case.get("cnf_w", 0.01), case.get("tnocs_w", 100.0),
                               accum_steps=accum, ode_backward=case.get("ode_backward", "adjoint"),
                               mesh=mesh)
        reset_collectives()
        kernels.reset_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        params, _, state, metrics = step(params, opt, state, x, target, e=e)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - start
        out.append({"metrics": metrics, "seconds": seconds, "mesh": describe(mesh),
                    "grads": dict(zip(_flatten(params), opt.grads)),
                    "params": _numpy(params), "state": _numpy(state),
                    "collectives": {k: dict(v) for k, v in collectives.items()},
                    "launches": dict(kernels.launches)})
    return out


def evals_job(payload, rank, world, mesh, device):
    import torch

    from ..data import DynamicPCLDataset, SequenceLoader
    from ..parallel import batch_group, collectives, reset_collectives
    from ..parallel.mesh import group_rank_size
    from ..utils import evaluations as ev

    cfg, model = _model(payload, device)
    params, state = _weights(payload, cfg, device)
    ds = DynamicPCLDataset(payload["data_cfg"], split="test", num_pts=ev.PROTOCOL_NUM_PTS,
                           seq_len=ev.PROTOCOL_NUM_STEPS, random_point_sample=False)
    index, shards = group_rank_size(batch_group(mesh))
    loader = SequenceLoader(ds, payload["batch_size"], seed=0, pad_last=True, num_shards=shards,
                            shard_index=index)
    out_dir = payload["out"]
    reset_collectives()
    ev.test_shape_recon(model, params, state, loader, os.path.join(out_dir, "recon_log.txt"),
                        ev.SPLIT_OBSERVED_STEPS, ev.SPLIT_UNOBSERVED_STEPS,
                        generator=torch.Generator(device=device).manual_seed(0),
                        base_samples=payload.get("base_samples"), mesh=mesh)
    means = ev.test_tnocs_regression(model, params, state, loader,
                                     os.path.join(out_dir, "tnocs_log.txt"), mesh=mesh)
    if payload.get("pose_out"):
        name = "pose_log.txt" if rank == 0 else f"rank{rank}_pose_log.txt"
        hidden = sys.modules.get("matplotlib", ...)
        if payload.get("no_matplotlib"):
            sys.modules["matplotlib"] = None
        try:
            ev.test_observed_camera_pose_ransac(model, params, state, loader,
                                                os.path.join(payload["pose_out"], name),
                                                show=True, mesh=mesh)
        finally:
            if hidden is ...:
                sys.modules.pop("matplotlib", None)
            else:
                sys.modules["matplotlib"] = hidden
    return {"tnocs_means": means, "collectives": {k: dict(v) for k, v in collectives.items()}}


def cli_job(payload, rank, world, mesh, device):
    import torch.distributed as dist

    from ..cli import test as cli_test
    from ..cli import train as cli_train
    from ..ops import kernels
    from ..parallel import collectives, reset_collectives

    module = {"train": cli_train, "test": cli_test}[payload["cli"]]
    overrides = payload.get("config")
    if overrides:  # fields the command lines have no flag for
        from_flags = module.caspr_config_from_flags
        module.caspr_config_from_flags = lambda flags: dataclasses.replace(
            from_flags(flags), **{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in overrides.items()})
    reset_collectives()
    kernels.reset_launches()
    start = time.perf_counter()
    module.main(payload["argv"], device=payload.get("device"))
    return {"seconds": time.perf_counter() - start, "launches": dict(kernels.launches),
            "collectives": {k: dict(v) for k, v in collectives.items()},
            "backend": dist.get_backend()}


def reconstruct_job(payload, rank, world, mesh, device):
    import torch

    from ..ops import kernels
    from ..parallel import collectives, mesh_groups, reset_collectives, shard_batch_points

    cfg, model = _model(payload, device)
    params, state = _weights(payload, cfg, device)
    x, base = (torch.as_tensor(a, device=device).contiguous()
               for a in shard_batch_points(mesh, (payload["x"], payload["base"])))
    timestamps = torch.as_tensor(payload["timestamps"], device=device)
    e = payload.get("e")
    if e is not None:  # (B T', N, 3): cut as (B, T', N, 3)
        e = shard_batch_points(mesh, e.reshape(*payload["base"].shape[:2], *e.shape[1:]))
        e = torch.as_tensor(e, device=device).reshape(-1, *e.shape[2:]).contiguous()

    def recon():
        with torch.no_grad():
            out = model.reconstruct(params, state, x, None, num_points=payload["x"].shape[2],
                                    timestamps=timestamps, base_samples=base,
                                    groups=mesh_groups(mesh),
                                    sample_div=payload.get("sample_div", False), e=e)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    recon()
    reset_collectives()
    kernels.reset_launches()
    start = time.perf_counter()
    _, _, x_rec, _, nfe = recon()
    return {"points": x_rec.cpu().numpy(), "nfe": nfe, "seconds": time.perf_counter() - start,
            "launches": dict(kernels.launches),
            "collectives": {k: dict(v) for k, v in collectives.items()}}


def mesh_job(payload, rank, world, mesh, device):
    import argparse

    import torch.distributed as dist

    from ..parallel import make_mesh, mesh_groups, shard_batch_points
    from ..parallel.mesh import describe
    from ..utils.config import parallel_setup

    def ranks_of(group):
        return None if group is None else dist.get_process_group_ranks(group)

    meshes = []
    for num_slices, sp_size in payload["meshes"]:
        m = make_mesh(num_slices, sp_size=sp_size, timeout=payload.get("timeout", 120))
        groups = mesh_groups(m)
        meshes.append({"names": m.mesh_dim_names, "describe": describe(m),
                       "batch": ranks_of(groups.batch), "point": ranks_of(groups.point),
                       "whole": ranks_of(groups.whole)})
        if len(meshes) == 1:
            shard = shard_batch_points(m, payload["array"])
    flags = argparse.Namespace(use_parallel=True, sp_size=payload["sp_size"], multihost=False)
    _, _, _, shards, log_name = parallel_setup(flags, device, "log.txt")
    return {"meshes": meshes, "shard": shard, "shards": shards, "log_name": log_name}


def parts_job(payload, rank, world, mesh, device):
    """Each of ``payload["parts"]`` (payloads of the other jobs, over the
    common keys) in turn, in one process group; their results in order."""
    return [JOBS[part["job"]](dict(payload, **part), rank, world, mesh, device)
            for part in payload["parts"]]


JOBS = {"steps": steps_job, "evals": evals_job, "cli": cli_job, "reconstruct": reconstruct_job,
        "mesh": mesh_job, "parts": parts_job}


def run_torchrun(nproc: int, payload: dict, work_dir: str, timeout: float = 300.0) -> list:
    """The "cli" job under ``python -m torch.distributed.run --standalone
    --nproc_per_node nproc``: torchrun's own rendezvous (on localhost), and
    the command line forms the group itself through
    ``parallel.init_distributed`` (nccl on the cards).  Each rank's result
    in rank order; the launcher's output goes to ``work_dir/torchrun.log``."""
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "payload.pkl"), "wb") as f:
        pickle.dump(dict(payload, world=nproc), f)
    log_path = os.path.join(work_dir, "torchrun.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc), "-m", "caspr_tpu_torch.checks.ranks", "--torchrun", work_dir],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise RuntimeError(f"torchrun did not end in {timeout} s:\n"
                               + Path(log_path).read_text()[-3000:])
    if proc.returncode:
        raise RuntimeError(f"torchrun exited {proc.returncode}:\n"
                           + Path(log_path).read_text()[-3000:])
    out = []
    for rank in range(nproc):
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    if argv[0] == "--torchrun":  # started by torchrun: the command line forms the group
        work_dir, rank = argv[1], int(os.environ["RANK"])
        with open(os.path.join(work_dir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        try:
            result = cli_job(payload, rank, payload["world"], None, None)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        return 0
    rank, world, work_dir = int(argv[0]), int(argv[1]), argv[2]
    with open(os.path.join(work_dir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)

    from ..parallel import make_mesh
    from ..parallel.mesh import rank_device

    torch.set_num_threads(payload.get("threads", 1))
    device = rank_device(payload["device"])
    if device.type == "cuda":
        from ..ops import kernels

        kernels.build()  # built already by the caller: this loads it
    dist.init_process_group(payload.get("backend", "gloo"),
                            store=dist.FileStore(os.path.join(work_dir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=payload.get("timeout", 120)))
    try:
        mesh = make_mesh(payload.get("num_slices", 1), sp_size=payload.get("sp_size", 1),
                         timeout=payload.get("timeout", 120))
        result = JOBS[payload["job"]](payload, rank, world, mesh, device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
